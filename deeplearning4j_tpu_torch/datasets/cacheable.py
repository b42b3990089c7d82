"""Local files for the zoo and the dataset fetchers: the local half of the
JAX package's ``datasets/cacheable.py`` (``ensure_file`` and
``ensure_extracted``).

The port never downloads. A file is looked up under the data directory
(``DL4J_TPU_DATA_DIR``, default ``~/.deeplearning4j_tpu/data``, the JAX
package's); a missing one raises ``FileNotFoundError`` naming where to put
it. With an md5 given, a mismatch deletes the file and raises
``ChecksumError`` (the reference's ZooModel.java:77-83 policy); a match is
remembered in a ``.md5ok`` marker bound to the file's size and mtime, the
JAX package's, so the two share a cache. ``ensure_extracted`` unpacks a
local zip or tar[.gz] archive into a directory once, through a temporary
sibling so an interrupted extraction never leaves a half-filled target.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import zipfile


class ChecksumError(RuntimeError):
    pass


def data_dir():
    return os.environ.get("DL4J_TPU_DATA_DIR",
                          os.path.expanduser("~/.deeplearning4j_tpu/data"))


def _md5(path, chunk=1 << 20):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def ensure_file(relpath, url=None, md5=None, root=None):
    """The local path of ``relpath`` under the data directory (or
    ``root``), its md5 checked when ``md5`` is given. ``url`` only names
    the source in the error for a missing file: nothing is fetched."""
    root = root or data_dir()
    path = os.path.join(root, relpath)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{relpath} not found under {root}: place the file at {path}"
            + (f" (source: {url})" if url else "")
            + "; deeplearning4j_tpu_torch does not download.")
    if md5 is None:
        return path
    st = os.stat(path)
    stamp = f"{md5} {st.st_size} {st.st_mtime_ns}"
    marker = path + ".md5ok"
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == stamp:
                return path
    got = _md5(path)
    if got != md5:
        os.remove(path)
        if os.path.exists(marker):
            os.remove(marker)
        raise ChecksumError(f"Checksum mismatch for {path}: expected {md5}, got {got}; "
                            "the file was deleted: place a good copy there again.")
    try:  # a read-only data directory keeps no marker
        with open(marker, "w") as f:
            f.write(stamp)
    except OSError:
        pass
    return path


def ensure_extracted(relpath, archive_relpath, url=None, md5=None, root=None):
    """The directory ``relpath`` under the data directory, extracted from
    the local archive ``archive_relpath`` (zip or tar[.gz], md5-checked by
    ``ensure_file``) when it is missing or empty."""
    root = root or data_dir()
    target = os.path.join(root, relpath)
    if os.path.isdir(target) and os.listdir(target):
        return target
    archive = ensure_file(archive_relpath, url=url, md5=md5, root=root)
    tmp = target + ".extracting"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            z.extractall(tmp)
    else:
        with tarfile.open(archive) as t:
            t.extractall(tmp, filter="data")
    os.makedirs(os.path.dirname(target) or root, exist_ok=True)
    shutil.rmtree(target, ignore_errors=True)
    os.replace(tmp, target)
    return target
