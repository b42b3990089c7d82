"""Threshold gradient compression (sparse ±τ messages with bitmap fallback).

Reference analog: EncodingHandler.java:28 + the libnd4j "THRESHOLD"
NDArrayCompressor (SURVEY.md §2.1 gradient-sharing row, §2.3). Semantics
preserved: encoding an update extracts the ±τ contribution of every element
with |g| ≥ τ and leaves the residual behind, so un-sent mass accumulates and
is sent on a later step; when more than 1/16 of elements flag, a 2-bit-per-
element bitmap is smaller than the sparse index list and is used instead.

The hot loops are C++ (native/src/threshold_codec.cc); a NumPy fallback keeps the
module working without the native build.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from deeplearning4j_tpu_torch import native as _native

# sparse message: 4 bytes per flagged element. bitmap: 2 bits/element = n/4
# bytes total. Sparse is smaller iff 4*count < n/4, i.e. density < 1/16.
_SPARSE_FRACTION = 1.0 / 16.0


@dataclasses.dataclass
class EncodedUpdate:
    """One compressed gradient message."""

    kind: str  # "sparse" | "bitmap"
    payload: np.ndarray  # int32 (sparse) or uint32 (bitmap)
    threshold: float
    n: int  # logical element count

    def nbytes(self) -> int:
        return int(self.payload.nbytes)


def encode(residual: np.ndarray, threshold: float) -> EncodedUpdate:
    """Encode (and subtract from) ``residual`` in place. The array must be
    C-contiguous float32 — a non-contiguous view would make reshape(-1) copy
    and silently discard the in-place residual update."""
    if residual.dtype != np.float32 or not residual.flags.c_contiguous:
        raise ValueError("encode() requires a C-contiguous float32 array "
                         "(in-place residual update)")
    flat = residual.reshape(-1)
    n = flat.size
    cap = max(16, int(n * _SPARSE_FRACTION))
    if _native.available():
        L = _native.lib()
        fptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        out = np.empty(cap, np.int32)
        cnt = L.dl4j_encode_threshold(
            fptr, n, threshold, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if cnt >= 0:
            return EncodedUpdate("sparse", out[:cnt].copy(), threshold, n)
        bitmap = np.zeros((n + 15) // 16, np.uint32)
        L.dl4j_encode_bitmap(
            fptr, n, threshold,
            bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return EncodedUpdate("bitmap", bitmap, threshold, n)
    # ---- NumPy fallback ----
    pos = flat >= threshold
    neg = flat <= -threshold
    cnt = int(pos.sum() + neg.sum())
    if cnt <= cap:
        idx_pos = np.nonzero(pos)[0].astype(np.int64) + 1
        idx_neg = -(np.nonzero(neg)[0].astype(np.int64) + 1)
        enc = np.concatenate([idx_pos, idx_neg]).astype(np.int32)
        flat[pos] -= threshold
        flat[neg] += threshold
        return EncodedUpdate("sparse", enc, threshold, n)
    bitmap = np.zeros((n + 15) // 16, np.uint32)
    codes = np.zeros(n, np.uint32)
    codes[pos] = 1
    codes[neg] = 2
    shifts = (2 * (np.arange(n) % 16)).astype(np.uint32)
    np.bitwise_or.at(bitmap, np.arange(n) // 16, codes << shifts)
    flat[pos] -= threshold
    flat[neg] += threshold
    return EncodedUpdate("bitmap", bitmap, threshold, n)


def decode(msg: EncodedUpdate, target: np.ndarray) -> None:
    """Accumulate the message into ``target`` (same logical size, float32)."""
    if target.dtype != np.float32 or not target.flags.c_contiguous:
        raise ValueError("decode() requires a C-contiguous float32 target "
                         "(in-place accumulate)")
    flat = target.reshape(-1)
    assert flat.size == msg.n
    if _native.available():
        L = _native.lib()
        tptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if msg.kind == "sparse":
            enc = np.ascontiguousarray(msg.payload, np.int32)
            L.dl4j_decode_threshold(
                enc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                enc.size, msg.threshold, tptr, flat.size)
        else:
            bm = np.ascontiguousarray(msg.payload, np.uint32)
            L.dl4j_decode_bitmap(
                bm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                flat.size, msg.threshold, tptr)
        return
    # ---- NumPy fallback ----
    if msg.kind == "sparse":
        enc = msg.payload.astype(np.int64)
        pos = enc[enc > 0] - 1
        neg = -enc[enc < 0] - 1
        np.add.at(flat, pos, msg.threshold)
        np.add.at(flat, neg, -msg.threshold)
    else:
        idx = np.arange(msg.n)
        codes = (msg.payload[idx // 16] >> (2 * (idx % 16)).astype(np.uint32)) & 3
        flat[codes == 1] += msg.threshold
        flat[codes == 2] -= msg.threshold


class AdaptiveThreshold:
    """Adaptive τ schedule (reference: EncodingHandler threshold/minThreshold/
    thresholdStep/shakeFrequency semantics): decay τ while messages stay
    sparse, never below ``min_threshold``; periodically "shake" by encoding at
    a smaller τ once to flush accumulated residual."""

    def __init__(self, initial=1e-3, min_threshold=1e-5, step=1e-5,
                 shake_frequency=0):
        self.threshold = float(initial)
        self.min_threshold = float(min_threshold)
        self.step = float(step)
        self.shake_frequency = int(shake_frequency)
        self.iteration = 0

    def current(self) -> float:
        self.iteration += 1
        if self.shake_frequency and self.iteration % self.shake_frequency == 0:
            return max(self.threshold / 2.0, self.min_threshold)
        return self.threshold

    def observe(self, msg: EncodedUpdate) -> None:
        # dense bitmap => τ too small: back off; very sparse => decay τ
        if msg.kind == "bitmap":
            self.threshold = min(self.threshold * 2.0, 1.0)
        else:
            density = len(msg.payload) / max(msg.n, 1)
            if density < 0.01:
                self.threshold = max(self.threshold - self.step,
                                     self.min_threshold)
