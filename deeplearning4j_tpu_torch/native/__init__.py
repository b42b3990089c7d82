"""Native host components (C++), loaded through ctypes: the port's copy of
the JAX package's ``deeplearning4j_tpu/native``.

Reference analog: the components whose guts are C++ in the reference stack
(libnd4j compression codecs, JavaCPP HDF5, the accumulator's concurrency
structures, DataVec's byte-crunching):

- threshold_codec.cc  THRESHOLD gradient compression (EncodingHandler.java:28)
- fbq.cc              FancyBlockingQueue (accumulation/FancyBlockingQueue.java)
- etl.cc              host-side ETL kernels (the DataVec/AsyncDataSetIterator path)
- hdf5_bridge.cc      HDF5 C bridge over the system libhdf5 (Hdf5Archive.java)

These are host code, not device kernels. The sources live in ``src/`` beside
this file; the library is compiled with ``g++`` at first use into the
package's ``_build/`` (gitignored), named by the sources' hash so an edited
source rebuilds and concurrent builders never share a half-written file.
``available()`` says whether the toolchain and build work; the numpy
fallbacks in ``codec.py``, ``etl.py`` and ``queue.py`` keep those modules
working without it. ``h5_available()`` says whether the system libhdf5
could be loaded, which the Keras import needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

_SRC_DIR = pathlib.Path(__file__).resolve().parent / "src"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("threshold_codec.cc", "fbq.cc", "etl.cc", "hdf5_bridge.cc")

_lock = threading.Lock()
_lib = None
_build_error = None


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives once built."""
    digest = hashlib.sha256()
    for s in _SOURCES:
        digest.update((_SRC_DIR / s).read_bytes())
    return _BUILD_DIR / f"libdl4j_native-{digest.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = (["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall", "-o", str(tmp)]
           + [str(_SRC_DIR / s) for s in _SOURCES] + ["-ldl", "-lpthread"])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64, f32, u8, i32, u32 = c.c_int64, c.c_float, c.c_uint8, c.c_int32, c.c_uint32
    P = c.POINTER
    # threshold codec
    lib.dl4j_encode_threshold.restype = i64
    lib.dl4j_encode_threshold.argtypes = [P(f32), i64, f32, P(i32), i64]
    lib.dl4j_decode_threshold.restype = None
    lib.dl4j_decode_threshold.argtypes = [P(i32), i64, f32, P(f32), i64]
    lib.dl4j_encode_bitmap.restype = i64
    lib.dl4j_encode_bitmap.argtypes = [P(f32), i64, f32, P(u32)]
    lib.dl4j_decode_bitmap.restype = None
    lib.dl4j_decode_bitmap.argtypes = [P(u32), i64, f32, P(f32)]
    # fbq
    lib.dl4j_fbq_create.restype = c.c_void_p
    lib.dl4j_fbq_create.argtypes = [i64]
    lib.dl4j_fbq_destroy.argtypes = [c.c_void_p]
    lib.dl4j_fbq_register.restype = i64
    lib.dl4j_fbq_register.argtypes = [c.c_void_p]
    lib.dl4j_fbq_put.restype = c.c_int
    lib.dl4j_fbq_put.argtypes = [c.c_void_p, i64, i64]
    lib.dl4j_fbq_poll.restype = c.c_int
    lib.dl4j_fbq_poll.argtypes = [c.c_void_p, i64, i64, P(i64)]
    lib.dl4j_fbq_pending.restype = i64
    lib.dl4j_fbq_pending.argtypes = [c.c_void_p, i64]
    lib.dl4j_fbq_close.argtypes = [c.c_void_p]
    # etl
    lib.dl4j_u8_to_f32.restype = None
    lib.dl4j_u8_to_f32.argtypes = [P(u8), P(f32), i64, f32, f32, c.c_int]
    lib.dl4j_one_hot.restype = None
    lib.dl4j_one_hot.argtypes = [P(i32), P(f32), i64, i64]
    lib.dl4j_gather_rows_f32.restype = None
    lib.dl4j_gather_rows_f32.argtypes = [P(f32), P(i64), P(f32), i64, i64, i64, c.c_int]
    lib.dl4j_nchw_to_nhwc.restype = None
    lib.dl4j_nchw_to_nhwc.argtypes = [P(f32), P(f32), i64, i64, i64, i64, c.c_int]
    # hdf5
    lib.dl4j_h5_available.restype = c.c_int
    lib.dl4j_h5_open.restype = i64
    lib.dl4j_h5_open.argtypes = [c.c_char_p, c.c_int]
    lib.dl4j_h5_close.restype = c.c_int
    lib.dl4j_h5_close.argtypes = [i64]
    lib.dl4j_h5_exists.restype = c.c_int
    lib.dl4j_h5_exists.argtypes = [i64, c.c_char_p]
    lib.dl4j_h5_list.restype = i64
    lib.dl4j_h5_list.argtypes = [i64, c.c_char_p, c.c_char_p, i64, P(i64)]
    lib.dl4j_h5_dataset_info.restype = c.c_int
    lib.dl4j_h5_dataset_info.argtypes = [i64, c.c_char_p, P(c.c_int), P(i64), P(c.c_int),
                                         P(c.c_int)]
    lib.dl4j_h5_read_f32.restype = c.c_int
    lib.dl4j_h5_read_f32.argtypes = [i64, c.c_char_p, P(f32), i64]
    lib.dl4j_h5_read_i64.restype = c.c_int
    lib.dl4j_h5_read_i64.argtypes = [i64, c.c_char_p, P(i64), i64]
    lib.dl4j_h5_write_f32.restype = c.c_int
    lib.dl4j_h5_write_f32.argtypes = [i64, c.c_char_p, P(f32), P(i64), c.c_int]
    lib.dl4j_h5_make_group.restype = c.c_int
    lib.dl4j_h5_make_group.argtypes = [i64, c.c_char_p]
    lib.dl4j_h5_read_attr_str.restype = i64
    lib.dl4j_h5_read_attr_str.argtypes = [i64, c.c_char_p, c.c_char_p, c.c_char_p, i64]
    lib.dl4j_h5_read_attr_strs.restype = i64
    lib.dl4j_h5_read_attr_strs.argtypes = [i64, c.c_char_p, c.c_char_p, c.c_char_p, i64,
                                           P(i64)]
    lib.dl4j_h5_write_attr_str.restype = c.c_int
    lib.dl4j_h5_write_attr_str.argtypes = [i64, c.c_char_p, c.c_char_p, c.c_char_p]
    lib.dl4j_h5_write_attr_strs.restype = c.c_int
    lib.dl4j_h5_write_attr_strs.argtypes = [i64, c.c_char_p, c.c_char_p, c.c_char_p]


def lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            loaded = ctypes.CDLL(str(out))
            _declare(loaded)
            _lib = loaded
            return _lib
        except Exception as e:  # remember it, so callers fall back once, not N times
            _build_error = f"dl4j native library unavailable: {e}"
            raise RuntimeError(_build_error) from e


def available() -> bool:
    try:
        lib()
        return True
    except RuntimeError:
        return False


def h5_available() -> bool:
    """Whether the system HDF5 shared library could be dlopen'd."""
    try:
        return bool(lib().dl4j_h5_available())
    except RuntimeError:
        return False
