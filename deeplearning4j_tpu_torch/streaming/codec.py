"""NDArray wire codec for the streaming tier.

The port of ``deeplearning4j_tpu/streaming/codec.py``, numpy only: frames
are byte for byte those of the JAX package's codec, so either package
reads the other's wire (dl4j-streaming's analog: NDArrays round-tripped
through byte payloads on a topic).

Wire format (self-describing, versioned):
  magic b"NDT1" | 1B kind (0 array, 1 dataset) | 4B LE header length |
  header JSON {dtype, shape[, label_dtype, label_shape][, ts]} | raw
  C-order bytes. Arrays are little-endian; bf16 is sent as f32.
"""

from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"NDT1"
_KIND_ARRAY = 0
_KIND_DATASET = 1


def _np(a):
    if hasattr(a, "detach"):  # a torch tensor: to the host first
        a = a.detach().cpu()
        if str(a.dtype) == "torch.bfloat16":
            a = a.float()
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


def _pack(kind, header, payloads):
    h = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<BI", kind, len(h)), h] + payloads)


def _unpack(buf):
    if buf[:4] != MAGIC:
        raise ValueError("Bad magic; not an NDT1 payload")
    kind, hlen = struct.unpack_from("<BI", buf, 4)
    header = json.loads(buf[9:9 + hlen].decode())
    return kind, header, buf[9 + hlen:]


def encode_ndarray(a) -> bytes:
    a = _np(a)
    return _pack(_KIND_ARRAY, {"dtype": a.dtype.str, "shape": a.shape},
                 [a.tobytes()])


def decode_ndarray(buf) -> np.ndarray:
    kind, h, raw = _unpack(buf)
    if kind != _KIND_ARRAY:
        raise ValueError("Payload is not a bare ndarray")
    # a copy: torch.from_numpy wants a writable array, frombuffer's is not
    return np.frombuffer(raw, dtype=np.dtype(h["dtype"])).reshape(h["shape"]).copy()


def encode_dataset(features, labels, ts=None) -> bytes:
    """``ts`` (optional, seconds since the epoch — the PUBLISH time)
    rides the self-describing JSON header, so a bounded-staleness
    consumer can age a batch from its source rather than from queue
    residency alone (delayed-ingest faults arrive already-stale).
    Decoders that predate the field ignore it (header is JSON)."""
    f, l = _np(features), _np(labels)
    header = {"dtype": f.dtype.str, "shape": f.shape,
              "label_dtype": l.dtype.str, "label_shape": l.shape}
    if ts is not None:
        header["ts"] = float(ts)
    return _pack(_KIND_DATASET, header, [f.tobytes(), l.tobytes()])


def dataset_ts(buf):
    """The publish timestamp of a dataset payload, or None."""
    _kind, h, _raw = _unpack(buf)
    return h.get("ts")


def decode_dataset(buf):
    kind, h, raw = _unpack(buf)
    if kind != _KIND_DATASET:
        raise ValueError("Payload is not a dataset")
    f_n = int(np.prod(h["shape"])) * np.dtype(h["dtype"]).itemsize
    f = np.frombuffer(raw[:f_n], dtype=np.dtype(h["dtype"])).reshape(h["shape"])
    l = np.frombuffer(raw[f_n:], dtype=np.dtype(h["label_dtype"])).reshape(
        h["label_shape"])
    return f.copy(), l.copy()
