"""HDF5 archive access through the native C++ bridge.

Reference analog: deeplearning4j-modelimport/.../Hdf5Archive.java:25,51-61 —
JavaCPP-wrapped native HDF5 used for Keras .h5 import (SURVEY.md §2.3). This
wraps native/src/hdf5_bridge.cc (dlopen'd system libhdf5) into the same surface
Hdf5Archive offers: read/write datasets, string attributes, group listings.
"""

from __future__ import annotations

import ctypes

import numpy as np

from deeplearning4j_tpu_torch import native as _native


class Hdf5Archive:
    """Read (mode="r") or create (mode="w") an HDF5 file."""

    def __init__(self, path: str, mode: str = "r"):
        self._lib = _native.lib()
        if not self._lib.dl4j_h5_available():
            raise RuntimeError("system libhdf5 not found (dlopen failed)")
        self._h = self._lib.dl4j_h5_open(
            path.encode(), 0 if mode == "r" else 1)
        if self._h < 0:
            raise IOError(f"cannot open HDF5 file {path!r} (mode={mode})")
        self.path = path

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        if self._h >= 0:
            self._lib.dl4j_h5_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- read ----------------------------------------------------------------
    def exists(self, path: str) -> bool:
        return bool(self._lib.dl4j_h5_exists(self._h, path.encode()))

    def list(self, path: str = "/"):
        """Children of a group as [(kind, name)] with kind 'g'|'d'."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            needed = ctypes.c_int64()
            n = self._lib.dl4j_h5_list(self._h, path.encode(), buf, cap,
                                       ctypes.byref(needed))
            if n == -2:
                cap = int(needed.value) + 1
                continue
            if n < 0:
                raise IOError(f"cannot list HDF5 group {path!r}")
            out = []
            for line in buf.value.decode().splitlines():
                if line:
                    out.append((line[0], line[2:]))
            return out

    def groups(self, path: str = "/"):
        return [name for kind, name in self.list(path) if kind == "g"]

    def datasets(self, path: str = "/"):
        return [name for kind, name in self.list(path) if kind == "d"]

    def dataset_shape(self, path: str):
        ndim = ctypes.c_int()
        dims = (ctypes.c_int64 * 8)()
        tclass = ctypes.c_int()
        esize = ctypes.c_int()
        r = self._lib.dl4j_h5_dataset_info(
            self._h, path.encode(), ctypes.byref(ndim), dims,
            ctypes.byref(tclass), ctypes.byref(esize))
        if r != 0:
            raise IOError(f"no such dataset {path!r}")
        return tuple(dims[i] for i in range(ndim.value))

    def read_dataset(self, path: str) -> np.ndarray:
        """Numeric dataset as float32 (HDF5 converts int/double on read)."""
        shape = self.dataset_shape(path)
        n = int(np.prod(shape)) if shape else 1
        out = np.empty(n, np.float32)
        r = self._lib.dl4j_h5_read_f32(
            self._h, path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        if r != 0:
            raise IOError(f"failed reading dataset {path!r} (code {r})")
        return out.reshape(shape)

    def read_attr_string(self, name: str, path: str = "/") -> str:
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        r = self._lib.dl4j_h5_read_attr_str(
            self._h, path.encode(), name.encode(), buf, cap)
        if r == -2:  # shouldn't happen at 1MB, but double once
            cap = cap * 32
            buf = ctypes.create_string_buffer(cap)
            r = self._lib.dl4j_h5_read_attr_str(
                self._h, path.encode(), name.encode(), buf, cap)
        if r < 0:
            raise IOError(f"no string attribute {name!r} on {path!r}")
        return buf.value.decode("utf-8", "replace")

    def read_attr_strings(self, name: str, path: str = "/"):
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            needed = ctypes.c_int64()
            n = self._lib.dl4j_h5_read_attr_strs(
                self._h, path.encode(), name.encode(), buf, cap,
                ctypes.byref(needed))
            if n == -2:
                cap = int(needed.value) + 1
                continue
            if n < 0:
                raise IOError(f"no string-array attribute {name!r} on {path!r}")
            lines = buf.value.decode("utf-8", "replace").split("\n")
            return [l for l in lines[: int(n)]]

    # -- write ---------------------------------------------------------------
    def write_dataset(self, path: str, array) -> None:
        a = np.ascontiguousarray(array, np.float32)
        dims = (ctypes.c_int64 * max(a.ndim, 1))(*(a.shape or (1,)))
        r = self._lib.dl4j_h5_write_f32(
            self._h, path.encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dims,
            max(a.ndim, 1))
        if r != 0:
            raise IOError(f"failed writing dataset {path!r} (code {r})")

    def make_group(self, path: str) -> None:
        if self._lib.dl4j_h5_make_group(self._h, path.encode()) != 0:
            raise IOError(f"failed creating group {path!r}")

    def _attr_target_check(self, path):
        if path not in ("/", "") and not self.exists(path):
            raise IOError(f"cannot write attribute: object {path!r} does not "
                          f"exist (create the group/dataset first)")

    def write_attr_string(self, name: str, value: str, path: str = "/") -> None:
        self._attr_target_check(path)
        r = self._lib.dl4j_h5_write_attr_str(
            self._h, path.encode(), name.encode(), value.encode())
        if r != 0:
            raise IOError(f"failed writing attribute {name!r} on {path!r}")

    def write_attr_strings(self, name: str, values, path: str = "/") -> None:
        self._attr_target_check(path)
        joined = "\n".join(values)
        r = self._lib.dl4j_h5_write_attr_strs(
            self._h, path.encode(), name.encode(), joined.encode())
        if r != 0:
            raise IOError(f"failed writing attribute {name!r} on {path!r}")
