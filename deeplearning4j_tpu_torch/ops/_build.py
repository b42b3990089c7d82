"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface, at first use, into ``_build/`` beside ``csrc/``. The library is
named by the source's hash, so an edited source is rebuilt and a clean
checkout builds on its first call; nvcc's ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside it as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (neither on PATH nor in /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the shared library for the current ``source`` lives once built."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` unless the library for its hash exists. Returns the
    library path; raises with nvcc's output when the build fails."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


class Library:
    """A kernel library loaded once, on first use, by ``ctypes``.
    ``declare(lib)`` sets each entry point's ``argtypes`` and ``restype``."""

    def __init__(self, source: pathlib.Path, declare):
        self.source = source
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> pathlib.Path:
        return build(self.source)

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


def device_index(dev) -> int:
    import torch
    return dev.index if dev.index is not None else torch.cuda.current_device()
