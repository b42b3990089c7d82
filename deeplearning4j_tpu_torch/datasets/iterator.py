"""Minibatch sources and shape buckets.

The same semantics as the JAX package's ``iter_batches``, ``pad_batch``,
``validity_mask``, ``BucketRegistry`` and ``ShapeBuckets``
(``deeplearning4j_tpu/datasets/iterator.py``). Arrays may be numpy arrays
or torch tensors; padding keeps each one's kind (and a tensor's device).
Serving warms each bucket once at startup, so no request pays a kernel
build; training pads ragged batches to one shape with a validity mask,
which the masked-mean losses make exact.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch


def _pad_axis(a, target, axis):
    """Zero-pad ``a`` to ``target`` along ``axis`` (no-op when it is that
    long already)."""
    n = a.shape[axis]
    if n == target:
        return a
    if n > target:
        raise ValueError(f"{'batch' if axis == 0 else 'sequence'} of {n} exceeds the "
                         f"bucketed shape {target}")
    if torch.is_tensor(a):
        shape = list(a.shape)
        shape[axis] = target - n
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    width = [(0, 0)] * a.ndim
    width[axis] = (0, target - n)
    return np.pad(np.asarray(a), width)


def validity_mask(labels, n_valid, target, *, seq_valid=None, seq_target=None):
    """[target] (or [target, T] for time-distributed labels) float32 numpy
    mask: 1 for the first ``n_valid`` examples, 0 for padding; with a
    sequence bucket the steps past ``seq_valid`` are 0 too."""
    valid = (np.arange(target) < n_valid).astype(np.float32)
    if labels.ndim >= 3:  # [B, T, ...] labels score per timestep
        t = int(seq_target) if seq_target else labels.shape[1]
        mask = np.repeat(valid[:, None], t, axis=1)
        if seq_valid is not None:
            mask = mask * (np.arange(t) < seq_valid).astype(np.float32)[None]
        return mask
    return valid


def pad_batch(x, y, m, target, *, seq_target=None):
    """Bucket one ``(x, y, mask)`` minibatch to ``target`` examples (and,
    with ``seq_target``, steps). Returns ``(x, y, mask, n_valid)``; the
    mask is always present, all ones when nothing was padded."""
    n = x.shape[0]
    seq = x.shape[1] if seq_target is not None and x.ndim >= 2 else None
    x, y_padded = _pad_axis(x, target, 0), _pad_axis(y, target, 0)
    if seq_target is not None:
        if x.ndim >= 2:
            x = _pad_axis(x, seq_target, 1)
        if y_padded.ndim >= 3:
            y_padded = _pad_axis(y_padded, seq_target, 1)
    if m is None:
        m = validity_mask(y, n, target, seq_valid=seq, seq_target=seq_target)
        if torch.is_tensor(x):
            m = torch.from_numpy(m).to(x.device)
    else:
        m = _pad_axis(m, target, 0)
        if seq_target is not None:
            m = _pad_axis(m, seq_target, 1)
    return x, y_padded, m, n


def iter_batches(data, labels=None, batch_size=None, mask=None, pad_to=None):
    """Yield ``(x, y, mask)`` minibatches from an iterable of batches
    (objects with ``features``/``labels``, dicts, 2- or 3-tuples), an
    ``(x, y)`` pair, or feature and label arrays sliced by ``batch_size``.
    ``pad_to`` pads every batch to that many examples (``True``: the first
    batch's size) and always yields a mask."""
    if pad_to is not None and pad_to is not False:
        target = None if pad_to is True else int(pad_to)
        for x, y, m in iter_batches(data, labels, batch_size, mask):
            if target is None:
                target = x.shape[0]
            x, y, m, _ = pad_batch(x, y, m, target)
            yield x, y, m
        return
    if labels is None and hasattr(data, "__iter__") \
            and not isinstance(data, (tuple, list, np.ndarray, torch.Tensor)):
        for item in data:
            if hasattr(item, "features") and hasattr(item, "labels"):
                yield item.features, item.labels, getattr(item, "features_mask", None)
            elif isinstance(item, dict):
                yield item["features"], item["labels"], item.get("mask")
            elif len(item) == 3:
                yield item
            else:
                yield item[0], item[1], None
        return
    if labels is None and hasattr(data, "shape"):
        raise ValueError("labels are required with array features "
                         "(pass an iterator or (x, y) pair otherwise)")
    x, y = (data, labels) if labels is not None else data
    n = x.shape[0]
    bs = batch_size or n
    for i in range(0, n, bs):
        m = mask[i:i + bs] if mask is not None else None
        yield x[i:i + bs], y[i:i + bs], m


class BucketRegistry:
    """Registered batch sizes: ``bucket_for(n)`` is the smallest size >= n
    (``None`` past the largest; callers chunk by ``max``)."""

    def __init__(self, sizes):
        cleaned = sorted({int(s) for s in sizes})
        if not cleaned or cleaned[0] < 1:
            raise ValueError(f"bucket sizes must be positive, got {sizes!r}")
        self._sizes = cleaned

    @classmethod
    def powers_of_two(cls, max_batch, min_batch=1):
        """1, 2, 4, ... up to (and always including) ``max_batch``."""
        sizes, b = [], int(min_batch)
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(int(max_batch))
        return cls(sizes)

    def sizes(self):
        return list(self._sizes)

    @property
    def max(self):
        return self._sizes[-1]

    def bucket_for(self, n):
        """Smallest registered bucket >= n, or None when n exceeds max."""
        if n > self._sizes[-1]:
            return None
        return self._sizes[bisect.bisect_left(self._sizes, n)]

    def __iter__(self):
        return iter(self._sizes)

    def __len__(self):
        return len(self._sizes)

    def __repr__(self):
        return f"BucketRegistry({self._sizes})"


class ShapeBuckets:
    """2-D (batch, seq) grid: ``bucket_for(rows, seq)`` is the smallest
    ``(batch_bucket, seq_bucket)`` covering the request, ``None`` past
    either max. A short sequence runs in a short shape."""

    def __init__(self, batch_sizes, seq_sizes):
        self._batch = (batch_sizes if isinstance(batch_sizes, BucketRegistry)
                       else BucketRegistry(batch_sizes))
        self._seq = (seq_sizes if isinstance(seq_sizes, BucketRegistry)
                     else BucketRegistry(seq_sizes))

    @property
    def batch(self):
        return self._batch

    @property
    def seq(self):
        return self._seq

    @property
    def max(self):
        """Largest batch bucket (callers chunk oversized batches by it)."""
        return self._batch.max

    @property
    def max_seq(self):
        """Largest seq bucket: longer requests are rejected, not chunked."""
        return self._seq.max

    def bucket_for(self, rows, seq):
        b = self._batch.bucket_for(rows)
        s = self._seq.bucket_for(seq)
        if b is None or s is None:
            return None
        return (b, s)

    def sizes(self):
        """The full grid as ``[(batch, seq), ...]``, seq-major within
        batch (warmup order)."""
        return [(b, s) for b in self._batch for s in self._seq]

    def __iter__(self):
        return iter(self.sizes())

    def __len__(self):
        return len(self._batch) * len(self._seq)

    def __repr__(self):
        return (f"ShapeBuckets(batch={self._batch.sizes()}, "
                f"seq={self._seq.sizes()})")
