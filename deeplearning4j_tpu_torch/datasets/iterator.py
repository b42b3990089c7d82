"""Minibatch sources, shape buckets and the prefetching iterators.

The same semantics as the JAX package's ``iter_batches``, ``pad_batch``,
``validity_mask``, ``BucketRegistry``, ``ShapeBuckets`` (with
``seq_edges_from_demand``, which reads ``telemetry/history.py``), the
``DataSetIterator`` family (``BenchmarkDataSetIterator`` included),
``SuperBatchIterator``, ``AsyncDataSetIterator`` and its
``DataSetCallback`` hooks (``deeplearning4j_tpu/datasets/iterator.py``).
Arrays may be numpy arrays or torch tensors, features and labels dicts of
them (a graph's inputs and outputs); padding keeps each one's kind (and a
tensor's device). Serving warms each bucket once at startup, so no request
pays a kernel build; training pads ragged batches to one shape with a
validity mask, which the masked-mean losses make exact.

``SuperBatchIterator`` stacks K minibatches into ``[K, B, ...]`` for one
K-step dispatch (``nn/fused.py``): ragged batches pad to the bucketed
shape, a ragged K-tail pads with steps whose ``step_valid`` is 0.
``AsyncDataSetIterator`` assembles the next batch on a producer thread
while the current dispatch runs (``queue_size=2``: double buffering). With
a CUDA ``device`` the producer stages each array in pinned host memory and
copies it with ``non_blocking=True`` on a stream of its own, recording an
event the consumer's stream waits on before the dispatch reads the batch.
"""

from __future__ import annotations

import bisect
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.utils.device import as_device


def _map(fn, tree):
    """``fn`` over an array or each entry of a dict of arrays."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _first(tree):
    return next(iter(tree.values())) if isinstance(tree, dict) else tree


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
    labels = _first(labels)
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
    mask is always present, all ones when nothing was padded. ``x`` and
    ``y`` may be dicts of arrays (a graph's), padded entry by entry."""
    x0 = _first(x)
    n = x0.shape[0]
    seq = x0.shape[1] if seq_target is not None and x0.ndim >= 2 else None
    x = _map(lambda a: _pad_axis(a, target, 0), x)
    y_padded = _map(lambda a: _pad_axis(a, target, 0), y)
    if seq_target is not None:
        x = _map(lambda a: _pad_axis(a, seq_target, 1) if a.ndim >= 2 else a, x)
        y_padded = _map(lambda a: _pad_axis(a, seq_target, 1) if a.ndim >= 3 else a, y_padded)
    if m is None:
        m = validity_mask(y, n, target, seq_valid=seq, seq_target=seq_target)
        if torch.is_tensor(x0):
            m = torch.from_numpy(m).to(x0.device)
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

    def round_up_to_multiple(self, m):
        """A new registry with every bucket rounded up to a multiple of
        ``m`` (mesh serving: the padded batch splits over the data axis),
        duplicates collapsed."""
        return BucketRegistry(-(-s // m) * m for s in self._sizes)

    def __iter__(self):
        return iter(self._sizes)

    def __len__(self):
        return len(self._sizes)

    def __repr__(self):
        return f"BucketRegistry({self._sizes})"


class ShapeBuckets:
    """2-D (batch, seq) grid: ``bucket_for(rows, seq)`` is the smallest
    ``(batch_bucket, seq_bucket)`` covering the request, ``None`` past
    either max. A short sequence runs in a short shape. Seq edges come from
    ``powers_of_two`` or from the demand history's sequence-length
    distribution (``from_demand``)."""

    def __init__(self, batch_sizes, seq_sizes):
        self._batch = (batch_sizes if isinstance(batch_sizes, BucketRegistry)
                       else BucketRegistry(batch_sizes))
        self._seq = (seq_sizes if isinstance(seq_sizes, BucketRegistry)
                     else BucketRegistry(seq_sizes))

    @classmethod
    def powers_of_two(cls, max_batch, max_seq, *, min_batch=1, min_seq=None):
        """Power-of-two grid on both axes; ``min_seq`` defaults to
        ``min(16, max_seq)`` (shorter buckets cost a warmup their padding
        savings do not pay back)."""
        if min_seq is None:
            min_seq = min(16, int(max_seq))
        return cls(BucketRegistry.powers_of_two(max_batch, min_batch),
                   BucketRegistry.powers_of_two(max_seq, min_seq))

    @classmethod
    def from_demand(cls, batch_sizes, max_seq, *, history=None,
                    series="serving_request_seq_len", quantiles=(0.5, 0.9)):
        """Seq edges from the sequence-length histogram retained in
        ``telemetry.history`` (``seq_edges_from_demand``; ``max_seq`` always
        included); with no retained demand, powers of two, so a cold process
        still serves."""
        edges = seq_edges_from_demand(max_seq, history=history, series=series,
                                      quantiles=quantiles)
        if edges is None:
            edges = BucketRegistry.powers_of_two(max_seq, min(16, int(max_seq)))
        return cls(batch_sizes, edges)

    def with_batch(self, batch_sizes):
        """Same seq grid, replaced batch axis."""
        return ShapeBuckets(batch_sizes, self._seq)

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

    def round_up_to_multiple(self, m):
        """A new grid with every BATCH bucket rounded up to a multiple of
        ``m`` (mesh serving); the seq axis is untouched, since a mesh splits
        rows, never timesteps."""
        return ShapeBuckets(self._batch.round_up_to_multiple(m), self._seq)

    def sizes(self):
        """The full grid as ``[(batch, seq), ...]``, seq-major within
        batch (warmup order)."""
        return [(b, s) for b in self._batch for s in self._seq]

    def __iter__(self):
        return iter(self.sizes())

    def __len__(self):
        return len(self._batch) * len(self._seq)

    def signature(self):
        """Stable string identity of the grid."""
        return ("b=" + ",".join(map(str, self._batch)) +
                ";s=" + ",".join(map(str, self._seq)))

    def __repr__(self):
        return (f"ShapeBuckets(batch={self._batch.sizes()}, "
                f"seq={self._seq.sizes()})")


def seq_edges_from_demand(max_seq, *, history=None, series="serving_request_seq_len",
                          quantiles=(0.5, 0.9)):
    """Seq grid edges from the sequence-length histogram retained in the
    metrics history (``telemetry.history``; the process default unless
    ``history`` is given): for each demand quantile, the smallest histogram
    bucket bound covering it (clamped to ``max_seq``), plus ``max_seq``
    itself. ``None`` when the history holds no samples of the series."""
    if history is None:
        from deeplearning4j_tpu_torch.telemetry.history import get_history
        history = get_history()
    merged = {}
    for sample in history.samples():
        doc = (sample.get("metrics") or {}).get(series)
        if not isinstance(doc, dict):
            continue
        for s in doc.get("series", ()):
            buckets = (s.get("value") or {}).get("buckets")
            if not buckets:
                continue
            for le, count in buckets.items():
                # cumulative snapshots: the last retained sample wins
                merged[le] = max(merged.get(le, 0), int(count))
    total = sum(merged.values())
    if not total:
        return None
    bounds = sorted((float("inf") if le == "+Inf" else float(le), count)
                    for le, count in merged.items())
    edges = set()
    for q in quantiles:
        rank = q * total
        cum = 0
        for bound, count in bounds:
            cum += count
            if cum >= rank:
                edge = int(max_seq) if bound == float("inf") else min(int(bound), int(max_seq))
                edges.add(max(1, edge))
                break
    edges.add(int(max_seq))
    return sorted(edges)


# ---------------------------------------------------------------------------
# DataSet iterators (reference: datasets/iterator/ — the DataSetIterator
# SPI, AsyncDataSetIterator.java, MultipleEpochsIterator,
# EarlyTerminationDataSetIterator)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataSet:
    """One minibatch (reference: org.nd4j.linalg.dataset.DataSet)."""

    features: object
    labels: object
    features_mask: object = None
    labels_mask: object = None

    def num_examples(self):
        return _first(self.features).shape[0]


class DataSetIterator:
    """Iterator protocol: yields DataSets; ``reset()`` starts an epoch."""

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    @property
    def batch_size(self):
        raise NotImplementedError


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches of in-memory arrays. ``pad_last=True`` pads the ragged
    last batch to ``batch_size`` (validity folded into the masks) and gives
    masks on every batch, so the epoch has one shape."""

    def __init__(self, features, labels, batch_size=32, *, features_mask=None,
                 labels_mask=None, shuffle=False, seed=123, drop_last=False, pad_last=False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)
        self._batch = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.pad_last = pad_last
        self._order = np.arange(len(self.features))
        self._pos = 0

    @property
    def batch_size(self):
        return self._batch

    def reset(self):
        self._pos = 0
        if self.shuffle:
            self.rng.shuffle(self._order)

    def __next__(self):
        n = len(self.features)
        if self._pos >= n:
            raise StopIteration
        end = min(self._pos + self._batch, n)
        if self.drop_last and end - self._pos < self._batch:
            raise StopIteration
        idx = self._order[self._pos:end]
        self._pos = end
        pick = lambda a: None if a is None else a[idx]
        ds = DataSet(self.features[idx], self.labels[idx], pick(self.features_mask),
                     pick(self.labels_mask))
        if not self.pad_last:
            return ds
        x, y, fm, _ = pad_batch(ds.features, ds.labels, ds.features_mask, self._batch)
        lm = None if ds.labels_mask is None else _pad_axis(ds.labels_mask, self._batch, 0)
        return DataSet(x, y, fm, lm)


_SENTINEL = object()


def _stage(a, device, stream):
    """``a`` (numpy or tensor) as a tensor on ``device``: through pinned
    memory and a copy on ``stream`` for a card."""
    if a is None:
        return None
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    with torch.cuda.stream(stream):
        return t.to(device, non_blocking=True)


class AsyncDataSetIterator(DataSetIterator):
    """Prefetch on a producer thread (reference: AsyncDataSetIterator.java,
    queue-based double buffering). A producer error reaches the consumer
    at its next ``next()``, before the batches still queued; ``close()``
    stops and joins the producer, and the iterator restarts cleanly on the
    next ``reset()``. With ``device`` every array of an item (a DataSet or
    a SuperBatch, whose extra fields ride along) is placed there on the
    producer thread; on a card the consumer's current stream waits on the
    copy's event when it takes the item. A ``callback``
    (``DataSetCallback``) takes each batch instead and places it itself.

    Telemetry (JAX ``iterator.py:495``, ``:544``, ``:560-562``): the
    producer's work runs in ``etl.prefetch`` spans (the placement in
    ``etl.device_put``), and with telemetry on the consumer's wait on the
    queue lands in ``etl_fetch_stall_seconds``, the queue's depth in
    ``etl_queue_depth`` and each delivered batch in ``etl_batches_total``.

    Transient producer errors (JAX ``iterator.py:447-466``, ``:599-629``):
    an error in ``RETRY_ON`` (the connection and timeout family a
    streaming source throws while it heals) is retried
    with capped exponential backoff up to ``retry_transient`` times per
    batch, counted ``etl_retry_total{outcome=retried|recovered|fatal}``;
    past the budget it surfaces on the consumer as any producer error
    does. Opt-in (``retry_transient=0``, fail on the first): a plain
    generator closes on its first raise, so retrying its ``next()`` would
    read as a clean but truncated epoch."""

    #: errors worth retrying: ConnectionError is an OSError; TimeoutError
    #: is the quiet-stream timeout continuous ingest raises
    RETRY_ON = (OSError, TimeoutError)

    def __init__(self, base, queue_size=2, device=None, callback=None,
                 retry_transient=0, retry_backoff_s=0.05):
        if callback is not None and device is not None:
            raise ValueError("callback and device are mutually exclusive: the callback "
                             "owns device placement (e.g. InterleavedDataSetCallback)")
        self.base = base
        self.queue_size = queue_size
        self.device = None if device is None else torch.device(device)
        self.callback = callback  # a DataSetCallback run on the producer thread
        self.retry_transient = int(retry_transient)
        self.retry_backoff_s = float(retry_backoff_s)
        self._queue = None
        self._thread = None
        self._error = None
        self._stop = None
        self._stream = None
        reg = self._reg = _tm.get_registry()
        # fetch stall: time the training thread spent blocked on the prefetcher
        self._m_stall = reg.histogram(
            "etl_fetch_stall_seconds",
            "consumer time blocked waiting on the prefetch queue")
        self._m_batches = reg.counter(
            "etl_batches_total", "batches delivered by async prefetch")
        self._m_depth = reg.gauge(
            "etl_queue_depth", "prefetched batches ready in the queue")
        self._m_retry = reg.counter(
            "etl_retry_total",
            "transient producer errors, by outcome (retried = one backoff "
            "attempt, recovered = a batch arrived after retries, fatal = "
            "the retry budget ran out and the error surfaced)")
        if reg.enabled:
            # every outcome series exists from the start, at zero (the SLO
            # delta discipline ignores a series' first appearance)
            for outcome in ("retried", "recovered", "fatal"):
                self._m_retry.inc(0, outcome=outcome)

    @property
    def batch_size(self):
        return self.base.batch_size

    def reset(self):
        self._shutdown()
        self.base.reset()
        if self.callback is not None:
            self.callback.reset()
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._stop = threading.Event()
        if self.device is not None and self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _place(self, ds):
        if self.callback is not None:
            return self.callback.call(ds)
        if self.device is None:
            return ds
        put = lambda tree: None if tree is None else _map(
            lambda a: _stage(a, self.device, self._stream), tree)
        with _tm.span("etl.device_put"):
            item = dataclasses.replace(ds, features=put(ds.features), labels=put(ds.labels),
                                       features_mask=put(ds.features_mask),
                                       labels_mask=put(ds.labels_mask))
        if self._stream is not None:
            ev = torch.cuda.Event()
            ev.record(self._stream)
            item._ready = ev
        return item

    def _producer(self):
        # this generation's queue and flag: a producer outliving close()'s
        # join must not feed the next generation's queue
        q, stop = self._queue, self._stop
        try:
            while not stop.is_set():
                with _tm.span("etl.prefetch"):
                    try:
                        ds = self._next_with_retry(stop)
                    except StopIteration:
                        break
                    item = self._place(ds)
                q.put(item)
        except Exception as e:  # surfaced on the consumer side
            if self._queue is q:
                self._error = e
        finally:
            q.put(_SENTINEL)

    def _next_with_retry(self, stop):
        """``next(self.base)`` under the transient-retry policy (producer
        thread only): a retryable error waits a capped exponential backoff
        (a ``close()`` ends the wait) and tries again up to the budget,
        then re-raises, counted fatal."""
        attempts = 0
        while True:
            try:
                ds = next(self.base)
            except self.RETRY_ON:
                attempts += 1
                if stop.is_set():
                    raise  # closing, not a verdict on the stream
                if attempts > self.retry_transient:
                    if self._reg.enabled:
                        self._m_retry.inc(outcome="fatal")
                    raise
                if self._reg.enabled:
                    self._m_retry.inc(outcome="retried")
                if stop.wait(min(self.retry_backoff_s * (2 ** (attempts - 1)), 2.0)):
                    raise
            else:
                if attempts and self._reg.enabled:
                    self._m_retry.inc(outcome="recovered")
                return ds

    def __next__(self):
        if self._queue is None:
            self.reset()
        if self._error is not None:
            # a dead producer surfaces at once, not after the queued batches
            raise self._error
        if self._reg.enabled:
            t0 = time.perf_counter()
            item = self._queue.get()
            self._m_stall.observe(time.perf_counter() - t0)
            self._m_depth.set(self._queue.qsize())
        else:
            item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        if self._reg.enabled:
            self._m_batches.inc()
        ev = getattr(item, "_ready", None)
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for tree in (item.features, item.labels, item.features_mask, item.labels_mask):
                if tree is not None:
                    # the consumer's stream now uses the producer's memory
                    _map(lambda t: t.record_stream(cur), tree)
        return item

    def close(self):
        """Stop and join the producer; safe to call repeatedly."""
        self._shutdown()

    def _shutdown(self):
        if self._thread is not None:
            # flag, then drain: a producer blocked in put() wakes, sees the
            # flag and exits instead of producing the rest of the epoch
            self._stop.set()
            self._drain()
            if self._thread.is_alive():
                self._thread.join(timeout=5)
            self._drain()
        self._thread = None
        self._queue = None

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


@dataclasses.dataclass
class SuperBatch(DataSet):
    """K stacked minibatches for one K-step dispatch (``nn/fused.py``):
    ``features``/``labels`` ``[K, B, ...]`` (dicts stack entry by entry),
    ``labels_mask`` the ``[K, B(, T)]`` validity times the user's mask,
    ``step_valid`` 1 for a real minibatch and 0 for a padded K-tail step,
    ``n_steps`` the count of real ones."""

    step_valid: object = None
    n_steps: int = 0


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class SuperBatchIterator(DataSetIterator):
    """Stacks K minibatches into super-batches, one a K-step dispatch.
    Every super-batch of a fit has one shape: ragged minibatches pad to the
    bucketed batch size (validity folded into ``labels_mask``, exact under
    the masked-mean losses) and a ragged K-tail pads with zeroed steps
    whose ``step_valid`` is 0. ``source`` is a DataSetIterator or a
    zero-argument callable returning a fresh ``(x, y, mask)`` iterable an
    epoch; ``reset()`` re-enters either. Stacking runs on the host, in
    numpy: wrap it in ``AsyncDataSetIterator`` to overlap it with the
    running dispatch."""

    def __init__(self, source, k, *, batch_size=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.source = source
        self.k = int(k)
        self._nominal = batch_size
        self._target = None  # the bucketed batch size, fixed at the first batch
        self._it = None

    @property
    def batch_size(self):
        if self._nominal:
            return self._nominal
        return getattr(self.source, "batch_size", None)

    def reset(self):
        if isinstance(self.source, DataSetIterator) or not callable(self.source):
            self._it = iter(iter_batches(self.source))
        else:
            self._it = iter(self.source())

    def __next__(self):
        if self._it is None:
            self.reset()
        got = []
        for _ in range(self.k):
            try:
                got.append(next(self._it))
            except StopIteration:
                break
        if not got:
            raise StopIteration
        if self._target is None:
            self._target = int(max(_first(got[0][0]).shape[0], self.batch_size or 0))
        padded = [pad_batch(_map(_host, x), _map(_host, y), None if m is None else _host(m),
                            self._target) for x, y, m in got]
        n = len(padded)
        xs, ys = [p[0] for p in padded], [p[1] for p in padded]
        ms = [np.asarray(p[2], np.float32) for p in padded]
        if n < self.k:  # a ragged K-tail: zeroed steps
            xs += [_map(np.zeros_like, xs[0])] * (self.k - n)
            ys += [_map(np.zeros_like, ys[0])] * (self.k - n)
            ms += [np.zeros_like(ms[0])] * (self.k - n)

        def stack(parts):
            if isinstance(parts[0], dict):
                return {key: np.stack([p[key] for p in parts]) for key in parts[0]}
            return np.stack(parts)

        return SuperBatch(features=stack(xs), labels=stack(ys), labels_mask=np.stack(ms),
                          step_valid=(np.arange(self.k) < n).astype(np.float32), n_steps=n)


class ShardedDataSetIterator(DataSetIterator):
    """One rank's share of a source iterator (reference analog: the Spark
    tier's partitions): batch k goes to rank k % world and every other
    batch is skipped, so the ranks stream disjoint data with no
    coordinator. ``rank``/``world`` default to the default process
    group's (a single process is index 0 of 1). An incomplete final round
    ends the epoch on every rank in the same call, so all ranks see the
    same number of batches (a rank stepping into a collective its peers
    never join would hang). A source with ``skip(n)`` seeks past the peers'
    batches without decoding them."""

    def __init__(self, source, rank=None, world=None):
        import torch.distributed as dist
        live = dist.is_available() and dist.is_initialized()
        self.source = source
        self.process_index = int(rank if rank is not None else
                                 (dist.get_rank() if live else 0))
        self.process_count = int(world if world is not None else
                                 (dist.get_world_size() if live else 1))
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"rank {self.process_index} outside a world of "
                             f"{self.process_count}")

    def reset(self):
        self.source.reset()

    def __next__(self):
        if callable(getattr(self.source, "skip", None)):
            self._skip(self.process_index)
            mine = next(self.source)
            self._skip(self.process_count - self.process_index - 1)
            return mine
        mine = None
        for i in range(self.process_count):
            batch = next(self.source)  # StopIteration drops the round
            if i == self.process_index:
                mine = batch
        return mine

    def _skip(self, n):
        if n <= 0:
            return
        skipped = self.source.skip(n)
        if skipped is not None and skipped < n:
            raise StopIteration

    @property
    def batch_size(self):
        return self.source.batch_size


class MultipleEpochsIterator(DataSetIterator):
    """``base`` replayed ``epochs`` times as one stream (reference:
    MultipleEpochsIterator.java)."""

    def __init__(self, base, epochs):
        self.base = base
        self.epochs = epochs
        self._epoch = 0

    @property
    def batch_size(self):
        return self.base.batch_size

    def reset(self):
        self._epoch = 0
        self.base.reset()

    def __next__(self):
        try:
            return next(self.base)
        except StopIteration:
            self._epoch += 1
            if self._epoch >= self.epochs:
                raise
            self.base.reset()
            return next(self.base)


class EarlyTerminationIterator(DataSetIterator):
    """At most ``max_batches`` minibatches of ``base`` (reference:
    EarlyTerminationDataSetIterator.java)."""

    def __init__(self, base, max_batches):
        self.base = base
        self.max_batches = max_batches
        self._count = 0

    @property
    def batch_size(self):
        return self.base.batch_size

    def reset(self):
        self._count = 0
        self.base.reset()

    def __next__(self):
        if self._count >= self.max_batches:
            raise StopIteration
        self._count += 1
        return next(self.base)


class BenchmarkDataSetIterator(DataSetIterator):
    """One synthetic batch repeated ``n_batches`` times (reference:
    BenchmarkDataSetIterator.java, a feeder with no ETL): the JAX package's
    draws from ``np.random.RandomState(seed)``."""

    def __init__(self, feature_shape, n_classes, n_batches, seed=0, labels_shape=None):
        rs = np.random.RandomState(seed)
        self._features = rs.rand(*feature_shape).astype(np.float32)
        if labels_shape is None:
            idx = rs.randint(0, n_classes, feature_shape[0])
            self._labels = np.eye(n_classes, dtype=np.float32)[idx]
        else:
            self._labels = rs.rand(*labels_shape).astype(np.float32)
        self.n_batches = n_batches
        self._count = 0

    @property
    def batch_size(self):
        return self._features.shape[0]

    def reset(self):
        self._count = 0

    def __next__(self):
        if self._count >= self.n_batches:
            raise StopIteration
        self._count += 1
        return DataSet(features=self._features, labels=self._labels)


class DataSetCallback:
    """A hook applied to each batch an ``AsyncDataSetIterator`` prefetches,
    on its producer thread (reference: DataSetCallback.java)."""

    def call(self, ds: DataSet) -> DataSet:
        return ds

    def reset(self):
        """Called on the iterator's reset, so per-epoch state (a round-robin
        position) realigns with the batch index."""


class InterleavedDataSetCallback(DataSetCallback):
    """Round-robin prefetched batches across devices (reference:
    InterleavedDataSetCallback.java): batch i goes to ``devices[i % n]``,
    so the replica that consumes it finds it resident. ``devices``
    defaults to every visible card and raises without one."""

    def __init__(self, devices=None):
        if devices:
            self.devices = [torch.device(d) for d in devices]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("InterleavedDataSetCallback: torch sees no CUDA device; "
                                   "pass devices=[...] (e.g. ['cpu'])")
            self.devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self._counter = 0

    def reset(self):
        self._counter = 0

    def call(self, ds: DataSet) -> DataSet:
        dev = self.devices[self._counter % len(self.devices)]
        self._counter += 1
        put = lambda tree: None if tree is None else _map(lambda a: as_device(a, dev), tree)
        return dataclasses.replace(ds, features=put(ds.features), labels=put(ds.labels),
                                   features_mask=put(ds.features_mask),
                                   labels_mask=put(ds.labels_mask))
