"""Make a test process immune to the JAX package's native-library build race.

The JAX package builds ``native/*.cc`` with ``g++ -o`` straight onto
``native/build/libdl4j_native.so`` at first use and caches a failed load for
the life of the process. Under pytest-xdist, workers that collect at the
same moment race on that one file, and a worker that loads it half written
(``file too short``) stays without the library for every test it runs.

``heal_reference_native()`` runs at import in the port's test modules that
reach the JAX package's native code, so in every worker during collection.
Under an exclusive ``fcntl.flock`` it builds the four sources with the JAX
package's own command into a private file (reusing one healed build of the
same sources), moves a copy onto the shared path with ``os.replace``
(atomic), loads the private file through the JAX module's ``_declare`` and
installs it as that module's library, clearing a cached error. A process
whose JAX module already holds a loaded library is left as it is.

What it cannot reach: a JAX test module that asks for the library at
collection time before any port test module is imported reads the shared
file on its own, outside this lock.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile


def _sources_digest(jn):
    h = hashlib.sha256()
    for s in jn._SOURCES:
        with open(os.path.join(jn._SRC_DIR, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(jn, out):
    """The JAX package's build command, onto ``out``."""
    srcs = [os.path.join(jn._SRC_DIR, s) for s in jn._SOURCES]
    cmd = (["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall", "-o", out]
           + srcs + ["-ldl", "-lpthread"])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")


def heal_reference_native():
    """Give the JAX package's native module a library built and loaded
    without the race (see the module docstring). Returns True when the
    module holds a loaded library afterwards."""
    from deeplearning4j_tpu import native as jn

    if jn._lib is not None:
        return True
    if shutil.which("g++") is None:
        return False
    build_dir = os.path.dirname(jn._OUT)
    os.makedirs(build_dir, exist_ok=True)
    healed = os.path.join(build_dir, f".healed-{_sources_digest(jn)}.so")
    with open(os.path.join(build_dir, ".heal.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(healed):
                staged = f"{healed}.{os.getpid()}.tmp"
                _build(jn, staged)
                os.replace(staged, healed)
            fd, private = tempfile.mkstemp(suffix=".so", prefix="dl4j_native.")
            os.close(fd)
            shutil.copyfile(healed, private)
            staged = f"{jn._OUT}.{os.getpid()}.tmp"
            shutil.copyfile(healed, staged)
            os.replace(staged, jn._OUT)
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return False
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    try:
        loaded = ctypes.CDLL(private)
        jn._declare(loaded)
    except OSError:
        return False
    finally:
        os.unlink(private)
    with jn._lock:
        jn._lib = loaded
        jn._build_error = None
    return True
