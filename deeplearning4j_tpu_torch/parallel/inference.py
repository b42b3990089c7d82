"""Batched inference with request coalescing: ``ParallelInference``.

The port of ``deeplearning4j_tpu/parallel/inference.py`` (reference:
ParallelInference.java, InferenceMode.BATCHED / SEQUENTIAL). One padded
forward at a fixed maximum batch, the serving tier's ``BucketedForward``;
queued requests are coalesced into one padded batch (``batched``) or
served one at a time (``sequential``), and each answer comes back through
an ``InferenceFuture``. ``update_model`` hot-swaps the served model: a
request in flight finishes on the old one. For continuous batching and
admission control use ``serving/``.

With a ``mesh`` the forward is the serving tier's collective
``BucketedForward(mesh=)``: the maximum batch rounds up to a multiple of
the data axis, the padded batch splits over ``data`` (each rank runs the
forward on its rows) and one all-gather brings every answer to every
rank, equal to the single-process ``output``. Every rank of the mesh calls
``output`` with the same batch, so the request queue, which coalesces by
arrival time on each rank, is not used with a mesh.

Telemetry (JAX ``inference.py:59``, ``:91``, ``:215-219``): a direct
``output`` runs in a ``serving.output`` span, a coalesced batch in a
``serving.batch`` span and a sequential request in ``serving.sequential``;
with telemetry on the queue depth, the latency by mode and the examples
served by mode land in ``serving_queue_depth``,
``serving_request_latency_seconds`` and ``serving_requests_total``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry
from deeplearning4j_tpu_torch.serving.engine import (BucketedForward, InferenceFuture,
                                                     ServingShutdown)


def _single(y):
    """A graph's one output out of its {name: array} dict."""
    return next(iter(y.values())) if isinstance(y, dict) and len(y) == 1 else y


class ParallelInference:
    """``inference_mode``: "batched" coalesces queued requests into one
    padded batch (the default); "sequential" serves them one at a time."""

    def __init__(self, net, *, max_batch_size=32, mesh=None, timeout_s=0.005,
                 inference_mode="batched"):
        if inference_mode not in ("batched", "sequential"):
            raise ValueError(f"inference_mode must be 'batched' or 'sequential', got "
                             f"{inference_mode!r}")
        self.mesh = mesh
        self.timeout_s = timeout_s
        self.inference_mode = inference_mode
        self._nominal_batch = max_batch_size
        self._serving = self._compile(net)
        self.max_batch = self._serving[1].buckets.max  # a mesh rounds it up
        self._queue: queue.Queue = queue.Queue()
        self._thread = None
        self._stop = threading.Event()
        reg = self._reg = _tm.get_registry()
        self._m_depth = reg.gauge(
            "serving_queue_depth", "pending requests in the serving queue")
        self._m_latency = reg.histogram(
            "serving_request_latency_seconds",
            "request latency by mode (direct / batched / sequential)")
        self._m_requests = reg.counter(
            "serving_requests_total",
            "examples served, by mode (direct / batched / sequential)")

    def _compile(self, net):
        """(net, padded forward, batch-1 forward), one tuple so a hot swap
        is atomic."""
        fwd = BucketedForward(net, BucketRegistry([self._nominal_batch]), device=net.device,
                              mesh=self.mesh)
        fwd_one = BucketedForward(net, BucketRegistry([1]), device=net.device)
        return (net, fwd, fwd_one)

    @property
    def net(self):
        return self._serving[0]

    def output(self, x):
        """Direct batched inference (padded to the maximum batch); a graph
        of one output answers with that output's array."""
        enabled = self._reg.enabled
        t0 = time.perf_counter() if enabled else 0.0
        with _tm.span("serving.output"):
            out = self._forward(x)
        if enabled:
            self._m_latency.observe(time.perf_counter() - t0, mode="direct")
            self._m_requests.inc(np.shape(out if not isinstance(out, dict)
                                          else next(iter(out.values())))[0], mode="direct")
            self._m_depth.set(self._queue.qsize())
        return out

    def _forward(self, x):
        """The padded chunk loop (over the mesh with one): one atomic model
        snapshot a call."""
        return _single(self._serving[1](np.asarray(x)))

    def _output_one(self, x):
        return _single(self._serving[2](np.asarray(x)[None]))[0]

    def update_model(self, net):
        """Hot-swap the served model (reference: ParallelInference.updateModel)."""
        self._serving = self._compile(net)

    def forwards(self):
        """Device forwards run so far (both forwards, warm-ups included)."""
        return sum(f.stats()["forwards"] for f in self._serving[1:])

    # -- the request queue ----------------------------------------------

    def start(self):
        if self.mesh is not None:
            raise ValueError("ParallelInference(mesh=) serves collective output() calls "
                             "(every rank passes the same batch); the request queue needs "
                             "no mesh")
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the worker and fail every request it never picked up;
        ``submit`` after ``stop`` raises."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        self._fail_pending()

    def _fail_pending(self):
        err = ServingShutdown("ParallelInference stopped before serving this request")
        while True:
            try:
                _x, holder, _t = self._queue.get_nowait()
            except queue.Empty:
                break
            if not holder.done():
                holder._set_error(err)

    def submit(self, x):
        """Submit one example; returns an ``InferenceFuture``."""
        if self._stop.is_set():
            raise ServingShutdown("ParallelInference is stopped")
        holder = InferenceFuture()
        self._queue.put((np.asarray(x), holder, time.perf_counter()))
        if self._stop.is_set():
            self._fail_pending()
        return holder

    def _drain_batch(self, first):
        """What is queued now, then stragglers under one shared
        ``timeout_s`` deadline while the batch has room."""
        batch = [first]
        try:
            while len(batch) < self.max_batch:
                batch.append(self._queue.get_nowait())
        except queue.Empty:
            deadline = time.perf_counter() + self.timeout_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
        return batch

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = (self._drain_batch(first) if self.inference_mode == "batched"
                     else [first])
            # a failing forward fails these requests, not the serving loop
            try:
                if self.inference_mode == "sequential":
                    for x, holder, t_sub in batch:
                        with _tm.span("serving.sequential"):
                            y = self._output_one(x)
                        self._finish(holder, y, t_sub, "sequential")
                    continue
                with _tm.span("serving.batch", size=len(batch)):
                    ys = self._forward(np.stack([b[0] for b in batch]))
                for (_, holder, t_sub), y in zip(batch, ys):
                    self._finish(holder, y, t_sub, "batched")
            except Exception as e:  # noqa: BLE001 -- propagate to the waiters
                for _, holder, _t in batch:
                    if not holder.done():
                        holder._set_error(e)

    def _finish(self, holder, value, t_submit, mode):
        holder._set(value)
        if self._reg.enabled:
            self._m_requests.inc(mode=mode)
            self._m_latency.observe(time.perf_counter() - t_submit, mode=mode)
