"""Shape buckets for serving: the finite set of padded shapes a process
runs.

Host-side, standard library only; the same semantics as the
JAX package's ``BucketRegistry`` and ``ShapeBuckets``
(``deeplearning4j_tpu/datasets/iterator.py``). The port warms each bucket
once at startup, so no request pays a kernel build.
"""

from __future__ import annotations

import bisect


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
