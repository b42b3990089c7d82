"""Native host-side ETL kernels with NumPy fallbacks.

Reference analog: the byte-crunching half of DL4J's data pipeline (DataVec
loaders + AsyncDataSetIterator's workspace prefetch, SURVEY.md §2.1) whose
guts are native. Used by the dataset iterators to keep minibatch assembly off
the step critical path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from deeplearning4j_tpu_torch import native as _native

_THREADS = max(1, min(8, (os.cpu_count() or 1) // 2))


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0, bias: float = 0.0):
    """uint8 image buffer -> normalized float32 (same shape)."""
    src = np.ascontiguousarray(src, np.uint8)
    if _native.available():
        out = np.empty(src.shape, np.float32)
        _native.lib().dl4j_u8_to_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            src.size, scale, bias, _THREADS)
        return out
    return src.astype(np.float32) * scale + bias


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Out-of-range labels (e.g. -1 padding markers) yield all-zero rows, in
    both the native kernel and this fallback."""
    labels = np.ascontiguousarray(labels, np.int32)
    if _native.available():
        out = np.empty((labels.size, num_classes), np.float32)
        _native.lib().dl4j_one_hot(
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.size, num_classes)
        return out
    flat = labels.reshape(-1)
    out = np.zeros((flat.size, num_classes), np.float32)
    valid = (flat >= 0) & (flat < num_classes)
    out[np.nonzero(valid)[0], flat[valid]] = 1.0
    return out


def gather_rows(src: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Minibatch assembly: out[i] = src[index[i]] for a 2-D+ float32 source."""
    src = np.ascontiguousarray(src, np.float32)
    index = np.ascontiguousarray(index, np.int64)
    if index.size and (index.min() < 0 or index.max() >= len(src)):
        raise IndexError(
            f"gather_rows index out of range [0, {len(src)}) "
            f"(min {index.min()}, max {index.max()})")
    if _native.available():
        row = int(np.prod(src.shape[1:])) if src.ndim > 1 else 1
        out = np.empty((index.size,) + src.shape[1:], np.float32)
        _native.lib().dl4j_gather_rows_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            index.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            index.size, row, len(src), _THREADS)
        return out
    return src[index]


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    """Reference-layout [N,C,H,W] batch -> the framework's [N,H,W,C]."""
    x = np.ascontiguousarray(x, np.float32)
    n, c, h, w = x.shape
    if _native.available():
        out = np.empty((n, h, w, c), np.float32)
        _native.lib().dl4j_nchw_to_nhwc(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, c, h, w, _THREADS)
        return out
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))
