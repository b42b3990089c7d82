"""Inference engine: continuous batching over warmed (batch, seq) buckets.

The port of ``deeplearning4j_tpu/serving/engine.py``:

* **Continuous batching** — one worker thread drains whatever is queued
  the moment the device frees, pads the ragged batch to the nearest
  registered bucket (``datasets.iterator.BucketRegistry``, or the 2-D
  ``ShapeBuckets`` grid, where rows pad to a batch bucket and the sequence
  axis to a seq bucket) and runs ONE forward, then slices the real rows
  and steps back out.
* **Warmup** — every registered bucket runs once at startup, so the first
  request pays no kernel build (the CUDA kernels build on first use).
* **Admission control** — a bounded queue of examples: a full queue
  rejects at ``submit()`` with :class:`ServingOverloaded`, and requests
  whose deadline passed while queued are shed before a forward is spent
  on them.

The forward runs under ``torch.inference_mode()`` on the engine's device
(``"cuda"`` unless the caller asks for the CPU). A ComputationGraph is
served in the JAX package's dict form: a request is one array (the
graph's first input) or a dict of arrays keyed by input name, every leaf
padded to the bucket (a seq bucket pads axis 1 of every leaf with a
sequence axis), and the result is the dict of the graph's outputs
(``apply_fn``'s form), one or several. A batched submit whose leaves
disagree on their leading dimension is refused.

Telemetry (JAX ``engine.py:310``, ``:559``, ``:639``, ``:812-817``,
``:881``, ``:1113``, ``:1239``): with telemetry on, every request (queued
or direct) is a causal trace (``serving.request``: queue wait, the
batch's forward, resolve), each device batch a ``serving.batch`` span and
each forward a ``serving.forward`` span, and the registry carries the
batch and token fill histograms, the admission queue depth, the
submit-to-result latency histogram and its rolling p50/p99 gauges, the
requests by outcome, the shed requests by reason, the requested sequence
lengths (the demand ``datasets.iterator.ShapeBuckets.from_demand`` reads)
and the warmup seconds. Off, each site is one branch.

Operations (JAX ``:72``, ``:83``, ``:752-783``, ``:838-``, ``:1145-1160``,
``:1250-1276``): ``submit(tenant=, origin=)`` meters every served row into
``serving/metering.py`` (rows, tokens, real and padded sequence tokens,
queue and device seconds, estimated FLOPs), and ``origin=`` traffic
counts into ``origin``-labelled series that the default SLO rules exclude
and stays out of the p50/p99 ring. ``update_model`` hot-swaps the served
model: the new ``BucketedForward`` is built and warmed off the serving
path, then rebound in one assignment, so a batch runs on one model, the
batches in flight finish on the old one and no queued request is dropped.
``health()`` is the stats, the recapture counts and this model's usage.
With a ``mesh`` the buckets round up to a multiple of the data axis and
each forward splits its padded batch over ``data`` (each rank runs its
rows, one all-gather brings every answer to every rank): every rank calls
``output`` with the same batch, so the queued path is refused with a mesh.

Warm restarts (JAX ``:219-230``, ``:435``, ``:784-799``): each grid entry
warms through ``utils/compile_cache.aot_compile`` under the JAX package's
kind (``serving``, ``serving:grid=<ShapeBuckets.signature()>`` on a 2-D
grid, the mesh folded in). With ``warm_manifest=`` (a path or a
``WarmManifest``) an entry's kernel libraries are installed and its launch
plans seeded from the manifest (no nvcc run, no tuning lookup); the
warm-up forward itself still runs. A manifest for another model or backend
is refused (``stats()["aot"]["manifest"] == "mismatch"``), a missing entry
warms live (``manifest_misses``). ``save_warm_manifest`` writes what this
engine warmed, for the next process. The first served request stamps
``time_to_first_request_ms``, and ``health()`` carries the
compile-cache events.
"""

from __future__ import annotations

import collections
import json
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry, ShapeBuckets
from deeplearning4j_tpu_torch.serving import metering as _metering
from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx
from deeplearning4j_tpu_torch.utils import compile_cache as _cc
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.device import resolve_device


#: buckets of the fill-ratio histograms (eighths)
FILL_BUCKETS = tuple(i / 8.0 for i in range(1, 9))


class ServingOverloaded(RuntimeError):
    """Request shed by admission control: the bounded queue is full, or the
    request's deadline passed before the worker picked it up. ``reason``
    (``"queue_full"`` / ``"deadline"``) is machine-readable. A future
    re-raised fresh chains ``from`` the original, so the reason survives
    on ``__cause__``."""

    reason = None


def _overloaded(msg, reason):
    e = ServingOverloaded(msg)
    e.reason = reason
    return e


def shed_reason(exc):
    """The structured shed reason of a ServingOverloaded: its own, or that
    of the original it was re-raised ``from`` (``InferenceFuture.get``
    raises a fresh copy chained to the one that carries it)."""
    for e in (exc, getattr(exc, "__cause__", None)):
        r = getattr(e, "reason", None)
        if r is not None:
            return r
    return None


def _origin_labels(meta):
    """Metric labels of a request's meta: synthetic traffic gets
    ``origin=...`` series (which every default SLO rule excludes), organic
    traffic keeps the unlabelled series."""
    origin = (meta or {}).get("origin")
    return {"origin": str(origin)} if origin else {}


class ServingShutdown(RuntimeError):
    """Request failed because the engine stopped before serving it."""


class InferenceFuture:
    """Future-like holder for one submitted request: ``done()`` polls,
    ``get()`` blocks, and a failed request raises a FRESH exception chained
    from the original (re-raising one shared instance across waiter
    threads would mutate its traceback concurrently)."""

    __slots__ = ("_event", "_value", "_error", "latency_s", "trace_id")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None
        #: submit-to-result seconds, stamped by the worker on completion
        self.latency_s = None
        #: the request's trace id when tracing is on
        self.trace_id = None

    def done(self):
        """True once a result or error is set (never blocks)."""
        return self._event.is_set()

    def _set(self, v):
        self._value = v
        self._event.set()

    def _set_error(self, e):
        self._error = e
        self._event.set()

    def get(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("inference result not ready")
        err = self._error
        if err is not None:
            try:
                fresh = type(err)(*err.args)
            except Exception:
                fresh = RuntimeError(f"{type(err).__name__}: {err}")
            raise fresh from err
        return self._value


def _host_array(a):
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _as_input(x, graph_inputs=None):
    """One request input on the host: a dict is the ComputationGraph
    multi-input form (each value taken as an array), anything else one
    array. For a graph (``graph_inputs``: its input names) one array is its
    first input, so both forms batch together."""
    if isinstance(x, dict):
        return {k: _host_array(v) for k, v in x.items()}
    if graph_inputs:
        return {graph_inputs[0]: _host_array(x)}
    return _host_array(x)


def _tree_map(fn, tree):
    """``fn`` over an array or over each value of a dict of arrays."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    return next(iter(tree.values())) if isinstance(tree, dict) else tree


def _concat(parts):
    """Row-concatenate a list of arrays or of dicts of arrays."""
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def _pad_rows_np(tree, target, seq_target=None):
    """Zero-pad every leaf to ``target`` rows along axis 0 (host-side).
    With ``seq_target``, a leaf with a sequence axis (``ndim >= 2``) is
    zero-padded along axis 1 as well: the model is causal over time, so
    the real rows and steps of the padded forward equal the unpadded one."""
    def pad(a):
        a = np.asarray(a)
        n = a.shape[0]
        if n != target:
            a = np.concatenate([a, np.zeros((target - n,) + a.shape[1:], a.dtype)])
        if seq_target is not None and a.ndim >= 2 and a.shape[1] != seq_target:
            width = [(0, 0)] * a.ndim
            width[1] = (0, seq_target - a.shape[1])
            a = np.pad(a, width)
        return a
    return _tree_map(pad, tree)


def _slice_seq(tree, padded_seq, real_seq):
    """Undo the seq-axis pad on a forward's outputs: slice axis 1 back to
    ``real_seq`` on every leaf whose axis 1 is the padded length."""
    if real_seq == padded_seq:
        return tree

    def cut(a):
        return a[:, :real_seq] if a.ndim >= 2 and a.shape[1] == padded_seq else a
    return _tree_map(cut, tree)


class BucketedForward:
    """One model's bucketed forward on one device: chunk by the largest
    batch bucket, pad each chunk to its bucket (both axes on a 2-D grid),
    run the network, slice real rows and steps back out. A hot swap builds
    a new one and rebinds it, so a batch runs on one model.

    With a ``mesh`` the batch buckets round up to a multiple of the data
    axis, and each forward runs this rank's rows of the padded chunk and
    all-gathers the outputs over ``data``: a collective, so every rank of
    the data group calls it with the same batch.

    ``forwards`` counts device forwards (warmup included): each runs every
    layer once, so a kernel a layer launches once per forward launches
    ``forwards`` times per such layer.

    ``warmup`` warms each grid entry through ``compile_cache.aot_compile``
    into ``manifest``: with one built for this net on this backend the
    entries are served from it (libraries installed, plans seeded) and the
    ones it lacks written back; one built for another is refused at
    construction (counted ``mismatch_drop``); without one, a fresh manifest
    for the net takes every entry. ``export_manifest`` returns it."""

    def __init__(self, net, buckets, *, device, dtype=np.float32, mesh=None, manifest=None):
        self.net = net
        self.device = device
        self.mesh = mesh
        self._manifest_state = "none"
        if manifest is not None:
            if manifest.matches(net):
                self._manifest_state = "attached"
            else:
                self._manifest_state = "mismatch"
                _cc.count_event("mismatch_drop")
                manifest = None
        #: the manifest the grid warms from and into
        self.manifest = manifest if manifest is not None else _cc.WarmManifest.for_net(net)
        #: ranks on the mesh's data axis (1 without a mesh)
        self.data_ranks = 1 if mesh is None else int(mesh.shape["data"])
        if self.data_ranks > 1:
            buckets = buckets.round_up_to_multiple(self.data_ranks)
        #: a graph's input names (requests become dicts), None for a network
        #: of one input
        self.graph_inputs = tuple(getattr(net.conf, "inputs", ())) or None
        self.buckets = buckets
        #: 2-D (batch, seq) grid vs the 1-D batch-only registry
        self.seq_aware = isinstance(buckets, ShapeBuckets)
        self.dtype = np.dtype(dtype)
        #: the served parameters' element count (metering's FLOPs estimate)
        self.param_count = _param_count(net)
        # the manifest kind, as the JAX package tags it: the mesh's shape
        # and size, then the 2-D grid (after the mesh's rounding)
        kind = ("serving" if mesh is None else
                f"serving:mesh={sorted(mesh.shape.items())}"
                f":ndev={math.prod(int(v) for v in mesh.shape.values())}")
        if self.seq_aware:
            kind += f":grid={buckets.signature()}"
        self._manifest_kind = kind
        self._lock = threading.Lock()
        self._counts = {"warmed": 0, "forwards": 0}
        self._aot = {"warmed": 0, "manifest_hits": 0, "manifest_misses": 0}
        reg = self._reg = _tm.get_registry()
        self._m_fill = reg.histogram(
            "serving_batch_fill_ratio",
            "fraction of each padded device batch holding real examples",
            buckets=FILL_BUCKETS)
        self._m_token_fill = reg.histogram(
            "serving_batch_token_fill_ratio",
            "fraction of each padded (batch, seq) device shape holding "
            "real tokens — the padded-FLOPs waste signal; equals the row "
            "fill on batch-only (1-D) buckets",
            buckets=FILL_BUCKETS)

    def warmup(self, input_spec):
        """Run every registered bucket once (zeros of the per-example
        ``input_spec`` shape, or a dict of them keyed by graph input) so
        kernel builds and first-launch costs land here, not on a request.
        Returns the wall seconds spent."""
        def zeros(spec, b, s):
            spec = tuple(int(d) for d in spec)
            if s is None:
                return np.zeros((b,) + spec, self.dtype)
            if not spec:
                raise ValueError("seq-bucketed serving needs a per-example "
                                 "input spec with a leading sequence axis")
            return np.zeros((b, s) + spec[1:], self.dtype)

        t0 = time.perf_counter()
        shapes = list(self.buckets) if self.seq_aware else [(b, None) for b in self.buckets]
        for b, s in shapes:
            x = (_tree_map(lambda spec: zeros(spec, b, s), input_spec)
                 if isinstance(input_spec, dict) else zeros(input_spec, b, s))
            _out, src = _cc.aot_compile(self._run, x, manifest=self.manifest,
                                        kind=self._manifest_kind,
                                        signature=json.dumps(_signature(x)))
            with self._lock:
                self._counts["warmed"] += 1
                self._aot["warmed"] += 1
                if src == "manifest":
                    self._aot["manifest_hits"] += 1
                elif self._manifest_state == "attached":
                    self._aot["manifest_misses"] += 1
        return time.perf_counter() - t0

    def aot_stats(self):
        """Grid entries warmed, served from the manifest and missed, and the
        manifest's state (none, attached or mismatch)."""
        with self._lock:
            return dict(self._aot, manifest=self._manifest_state)

    def export_manifest(self):
        """The warm manifest covering every grid entry this forward warmed,
        each under the manifest key (tuning DB fingerprint included) it
        warmed with."""
        return self.manifest

    def _run(self, x_padded):
        """One forward at the padded shape; the result (an array, or a
        graph's dict of outputs) comes back to the host, which waits for
        the device. Over a mesh this rank runs its rows of the batch and
        the outputs are all-gathered over ``data``."""
        if self.data_ranks > 1:
            # lazy: parallel/__init__ imports ParallelInference, built on this module
            from deeplearning4j_tpu_torch.parallel import mesh as _mesh
            x_padded = _tree_map(lambda a: _mesh.ensure_data_sharded(self.mesh, a).numpy(),
                                 x_padded)
        x = _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device),
                      x_padded)
        with _dtypes.policy_precision(), torch.inference_mode():
            y, _ = self.net.apply_fn(self.net.params, self.net.state, x)
        if self.data_ranks > 1:
            from deeplearning4j_tpu_torch.utils import collectives as _C
            group = self.mesh.group("data")
            y = _tree_map(lambda t: _C.gather_dim(t, 0, group), y)
        with self._lock:
            self._counts["forwards"] += 1
        return _tree_map(lambda t: t.cpu().numpy(), y)

    def stats(self):
        with self._lock:
            return dict(self._counts)

    def __call__(self, x, _usage=None):
        """Padded, bucketed forward of a host batch of any leading size (an
        array or a dict of arrays with one leading size). ``_usage`` (a
        list) collects one ``{rows, seq, batch_bucket, seq_bucket}`` record
        per device chunk, so the caller meters padded against real
        tokens."""
        x = _as_input(x, self.graph_inputs)
        first = _first_leaf(x)
        n = first.shape[0]
        seq_in = first.shape[1] if self.seq_aware and first.ndim >= 2 else None
        if self.seq_aware and seq_in is None:
            raise ValueError(
                "seq-bucketed serving requires inputs with a sequence axis "
                f"([rows, steps, ...]); got shape {tuple(first.shape)}")
        outs = []
        step = self.buckets.max
        for i in range(0, n, step):
            chunk = _tree_map(lambda a: np.asarray(a[i:i + step], dtype=self.dtype), x)
            real = _first_leaf(chunk).shape[0]
            if self.seq_aware:
                shape = self.buckets.bucket_for(real, seq_in)
                if shape is None:
                    raise ValueError(
                        f"sequence of {seq_in} steps exceeds the largest "
                        f"registered seq bucket ({self.buckets.max_seq}); "
                        "sequences cannot be chunked")
                bucket, seq_bucket = shape
            else:
                bucket, seq_bucket = self.buckets.bucket_for(real), None
            fill = real / bucket
            token_fill = fill if seq_bucket is None else fill * seq_in / seq_bucket
            if _usage is not None:
                _usage.append({"rows": real, "seq": seq_in or 1, "batch_bucket": bucket,
                               "seq_bucket": seq_bucket or 1})
            if self._reg.enabled:
                self._m_fill.observe(fill)
                self._m_token_fill.observe(token_fill)
            with _tm.span("serving.forward", fill=fill, bucket=bucket, seq_bucket=seq_bucket):
                y = _tree_map(lambda a: a[:real],
                              self._run(_pad_rows_np(chunk, bucket, seq_target=seq_bucket)))
            if seq_bucket is not None:
                y = _slice_seq(y, seq_bucket, seq_in)
            outs.append(y)
        return outs[0] if len(outs) == 1 else _concat(outs)


class ServingEngine:
    """Continuous-batching inference server for ONE named model.

    ``submit()`` is the async request path (bounded admission queue,
    deadline-aware shedding); ``output()`` is the synchronous direct path
    (same buckets, no queue). ``update_model()`` hot-swaps the served
    model. ``stats()`` is the status payload, ``health()`` the health
    export. ``device`` is where the forward runs (``"cuda"`` unless the
    caller asks for ``"cpu"``); the network is moved there. ``mesh``: the
    collective form (see the module docstring), ``output()`` only.
    ``warm_manifest``: a ``WarmManifest`` or a path to one (a missing file
    is a cold start, an unreadable one warns and warms cold).
    """

    def __init__(self, net, *, name="default", input_spec=None,
                 buckets=None, seq_buckets=None, max_batch_size=32, mesh=None,
                 max_queue=256, default_deadline_s=None, batch_window_s=0.0,
                 dtype=np.float32, warmup=None, device="cuda", warm_manifest=None):
        self.name = name
        self.device = resolve_device(device)
        net.to(self.device)
        self._warm_manifest = _load_manifest(warm_manifest)
        self.mesh = mesh
        self.batch_window_s = batch_window_s
        self.default_deadline_s = default_deadline_s
        self._input_spec = input_spec
        self._dtype = np.dtype(dtype)
        if not isinstance(buckets, ShapeBuckets):
            if buckets is None:
                buckets = BucketRegistry.powers_of_two(max_batch_size)
            elif not isinstance(buckets, BucketRegistry):
                buckets = BucketRegistry(buckets)
            if seq_buckets is not None:
                buckets = ShapeBuckets(buckets, seq_buckets)
        self._fwd = BucketedForward(net, buckets, device=self.device, dtype=dtype, mesh=mesh,
                                    manifest=self._warm_manifest)
        self.max_queue = max_queue
        self._pending_rows = 0  # queued EXAMPLES (a batched entry is n)
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        # one deque PER SEQ BUCKET (a single None key on 1-D registries),
        # so requests coalesce within a seq bucket and a short sequence is
        # never padded into a long batch; the condition shares the
        # admission lock, so enqueue, drain and the bound stay atomic
        self._queues = {}
        self._not_empty = threading.Condition(self._lock)
        self._counts = {"submitted": 0, "served": 0, "shed_queue_full": 0,
                        "shed_deadline": 0, "errors": 0, "swaps": 0}
        self._recent_latencies = []  # bounded ring for p50/p99
        self._warmup_s = None
        reg = self._reg = _tm.get_registry()
        self._m_depth = reg.gauge(
            "serving_admission_queue_depth",
            "pending requests in the bounded admission queue, per model")
        self._m_latency = reg.histogram(
            "serving_model_latency_seconds",
            "submit-to-result request latency, per model")
        self._m_p50 = reg.gauge(
            "serving_latency_p50_seconds",
            "rolling p50 request latency per model (SLO gauge)")
        self._m_p99 = reg.gauge(
            "serving_latency_p99_seconds",
            "rolling p99 request latency per model (SLO gauge)")
        self._m_requests = reg.counter(
            "serving_model_requests_total",
            "requests by model and outcome "
            "(submitted/served/shed_queue_full/shed_deadline/error)")
        self._m_shed = reg.counter(
            "serving_shed_total",
            "load-shed requests per model and reason "
            "(queue_full / deadline / shutdown)")
        self._m_warm = reg.gauge(
            "serving_warmup_seconds",
            "wall seconds the bucket warmup took at startup, per model")
        self._m_seq_len = reg.histogram(
            "serving_request_seq_len",
            "requested sequence lengths (steps) per model — the demand "
            "distribution seq grid edges derive from "
            "(datasets.iterator.seq_edges_from_demand)",
            buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192))
        if reg.enabled:
            # every outcome series exists from the start, at zero
            for outcome in ("submitted", "served", "served_direct",
                            "shed_queue_full", "shed_deadline", "error"):
                self._m_requests.inc(0, model=self.name, outcome=outcome)
        if warmup is None:
            warmup = input_spec is not None
        if warmup:
            self.warmup()

    # ---- lifecycle ----

    def warmup(self):
        """Run every registered bucket once now, so no request pays a
        kernel build. Requires ``input_spec`` (per-example shape)."""
        if self._input_spec is None:
            raise ValueError("warmup needs input_spec (per-example feature shape)")
        self._warmup_s = self._fwd.warmup(self._input_spec)
        if self._reg.enabled:
            self._m_warm.set(self._warmup_s, model=self.name)
        return self._warmup_s

    def start(self):
        if self.mesh is not None:
            raise ValueError("ServingEngine(mesh=) serves collective output() calls (every "
                             "rank passes the same batch); the request queue needs no mesh")
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"serving-{self.name}")
        self._thread.start()
        return self

    def stop(self):
        """Stop the worker and FAIL every request it never picked up with
        :class:`ServingShutdown`; ``submit()`` after stop raises."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fail_pending()

    def _pop_locked(self, dq):
        """Pop one entry off ``dq`` (caller holds the lock), releasing its
        admission rows."""
        entry = dq.popleft()
        self._pending_rows -= entry[4] or 1
        return entry

    def _fail_pending(self):
        err = ServingShutdown(
            f"serving engine {self.name!r} stopped before serving this request")
        with self._not_empty:
            drained = []
            for dq in self._queues.values():
                while dq:
                    drained.append(self._pop_locked(dq))
        for entry in drained:
            fut, tctx = entry[1], entry[6]
            if tctx is not None:
                tctx.finish(status="shed")
            if self._reg.enabled:
                self._m_shed.inc(model=self.name, reason="shutdown")
            if not fut.done():
                fut._set_error(err)
                self._count("errors")

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    @property
    def net(self):
        return self._fwd.net

    @property
    def buckets(self):
        return self._fwd.buckets

    def update_model(self, net, warm=None, *, manifest=None):
        """Hot-swap the served model. The replacement ``BucketedForward``
        (same shape grid: a swap changes weights, never shapes) is built
        and, by default when the engine knows its input spec, warmed off
        the serving path, then rebound in one assignment: the worker reads
        the forward once a batch, so batches in flight finish on the old
        model, later ones run on the new one, and no queued request is
        dropped or errored by the swap. ``manifest`` (a bundle's warm
        manifest, or a path) replaces the engine's for this and later
        swaps; a registry gates its grid first
        (``serving/registry.py``)."""
        net.to(self.device)
        manifest = _load_manifest(manifest)
        if manifest is not None:
            self._warm_manifest = manifest
        fwd = self._fwd
        fresh = BucketedForward(net, fwd.buckets, device=self.device, dtype=self._dtype,
                                mesh=self.mesh, manifest=self._warm_manifest)
        if warm is None:
            warm = self._input_spec is not None
        if warm:
            if self._input_spec is None:
                raise ValueError("update_model(warm=True) needs input_spec")
            fresh.warmup(self._input_spec)
        self._fwd = fresh
        self._count("swaps")

    def export_warm_manifest(self):
        """The warm manifest covering every grid entry the served forward
        warmed, or None when it warmed none."""
        m = self._fwd.export_manifest()
        return m if len(m) else None

    def save_warm_manifest(self, path):
        """Write the served forward's warm manifest to ``path`` (zip): a
        process that passes ``warm_manifest=path`` then warms every covered
        grid entry with no nvcc run and no tuning lookup. Returns the path,
        or None when nothing was warmed."""
        m = self.export_warm_manifest()
        return None if m is None else m.save(path)

    # ---- request paths ----

    def output(self, x):
        """Synchronous direct inference (no queue), through the same
        buckets as the batched path; counted into ``stats()``. With tracing
        on it is a ``serving.request_direct`` trace."""
        tctx = _tracectx.maybe_start("serving.request_direct", model=self.name)
        t0 = time.perf_counter()
        try:
            with _tracectx.attach(tctx):
                with _tm.span("serving.output", model=self.name):
                    out = self._fwd(x)
        except BaseException:
            if tctx is not None:
                tctx.finish(status="error")
            raise
        dt = time.perf_counter() - t0
        _cc.note_first_request()
        if tctx is not None:
            tctx.finish()
        n = _first_leaf(out).shape[0]
        self._count("served", n)
        self._note_latencies([dt], ctxs=[tctx])
        if self._reg.enabled:
            self._m_requests.inc(n, model=self.name, outcome="served_direct")
        return out

    def submit(self, x, deadline_s=None, *, batched=False, tenant=None, origin=None):
        """Queue ONE example (or, with ``batched=True``, one multi-example
        batch, examples on axis 0); returns ONE :class:`InferenceFuture`.
        A batched future resolves to the stacked ``[n, ...]`` outputs. A
        ComputationGraph request may be a dict of arrays keyed by input
        name; a batched one must carry the same leading size in every
        leaf.

        Admission bounds queued EXAMPLES: a batched submit of n rows spends
        n of the ``max_queue`` slots. A full queue sheds here
        (:class:`ServingOverloaded`); ``deadline_s`` (or the engine
        default) sheds the request later if it goes stale while queued.

        ``tenant`` attributes the request in the usage ledger
        (``serving/metering.py``); ``origin="probe"`` (or any origin) marks
        synthetic traffic: its counter series carry an ``origin`` label,
        which every default SLO rule excludes, and it stays out of the
        p50/p99 ring. It is metered all the same."""
        if self._stop.is_set():
            raise ServingShutdown(f"serving engine {self.name!r} is stopped")
        meta = None
        if tenant is not None or origin is not None:
            meta = {"tenant": tenant, "origin": origin}
        olab = _origin_labels(meta)
        fut = InferenceFuture()
        # the request's trace starts here; the worker adds its queue wait,
        # the batch's forward and the resolve. Tracing off: None, a branch.
        tctx = _tracectx.maybe_start("serving.request", model=self.name)
        if tctx is not None:
            fut.trace_id = tctx.trace_id
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else now + deadline_s
        self._count("submitted")
        if self._reg.enabled:
            self._m_requests.inc(model=self.name, outcome="submitted", **olab)
        try:
            item, nrows, seq, skey = self._admit_input(x, batched)
        except BaseException:
            if tctx is not None:
                tctx.abandon()  # never queued: don't leak the trace
            raise
        if seq is not None and self._reg.enabled:
            self._m_seq_len.observe(seq, model=self.name, **olab)
        rows = 1 if nrows is None else nrows
        try:
            with self._not_empty:
                if self._pending_rows + rows > self.max_queue:
                    raise queue.Full
                self._pending_rows += rows
                self._queues.setdefault(skey, collections.deque()).append(
                    (item, fut, now, deadline, nrows, seq, tctx, meta))
                self._not_empty.notify()
        except queue.Full:
            self._count("shed_queue_full")
            if self._reg.enabled:
                self._m_shed.inc(model=self.name, reason="queue_full", **olab)
                self._m_requests.inc(model=self.name, outcome="shed_queue_full", **olab)
            if tctx is not None:
                tctx.finish(status="shed")
            raise _overloaded(
                f"model {self.name!r}: admission queue full "
                f"({self.max_queue} pending)", "queue_full") from None
        if self._stop.is_set():
            # raced stop(): its drain may already have run, leaving this
            # request in a queue nobody reads
            self._fail_pending()
        return fut

    def _admit_input(self, x, batched):
        """(rows [n, ...], n or None, seq length or None, seq bucket key) of
        one submit, or ValueError for a request that can never be served."""
        item = _as_input(x, self._fwd.graph_inputs)
        if batched:
            # every leaf carries the examples on a shared axis 0: a dict whose
            # leaves disagree would be admitted on one count and fail the
            # co-batched requests inside the drain
            leaves = list(item.values()) if isinstance(item, dict) else [item]
            dims = {int(a.shape[0]) if a.ndim else -1 for a in leaves}
            if len(dims) != 1 or -1 in dims:
                raise ValueError("batched submit requires every input leaf to carry the "
                                 "examples on axis 0 with one shared length; got leading "
                                 f"dims {sorted(dims)}")
            nrows = dims.pop()
            if nrows == 0:
                raise ValueError("batched submit requires at least one example "
                                 "(got a 0-row batch)")
            if nrows > self.max_queue:
                # can never be admitted: a sizing error, not load
                raise ValueError(
                    f"batched submit of {nrows} rows exceeds the admission "
                    f"bound (max_queue={self.max_queue}) and could never be "
                    "admitted; split the batch or raise max_queue")
        else:
            nrows = None
            item = _tree_map(lambda a: a[None], item)
        seq = skey = None
        if self._fwd.seq_aware:
            lead = _first_leaf(item)
            if lead.ndim < 2:
                raise ValueError(
                    f"model {self.name!r} serves 2-D (batch, seq) buckets: "
                    "requests need a sequence axis ([steps, ...] per example)")
            seq = int(lead.shape[1])
            skey = self._fwd.buckets.seq.bucket_for(seq)
            if skey is None:
                raise ValueError(
                    f"model {self.name!r}: sequence of {seq} steps exceeds the "
                    f"largest registered seq bucket ({self._fwd.buckets.max_seq})")
        return item, nrows, seq, skey

    # ---- worker ----

    def _drain(self):
        """Block briefly for the first request, take everything queued in
        the seq bucket whose head has waited longest (so no bucket
        starves), then, with room left and a batch window set, wait under
        ONE shared deadline for stragglers in that bucket."""
        cap = self._fwd.buckets.max

        def oldest_key():
            # (found, key): the 1-D path queues under key None
            live = [k for k, dq in self._queues.items() if dq]
            if not live:
                return False, None
            return True, min(live, key=lambda k: self._queues[k][0][2])

        batch, rows = [], 0
        with self._not_empty:
            found, skey = oldest_key()
            if not found:
                self._not_empty.wait(timeout=0.05)
                found, skey = oldest_key()
                if not found:
                    return []
            dq = self._queues[skey]
            while dq and rows < cap:
                e = self._pop_locked(dq)
                batch.append(e)
                rows += e[4] or 1
            if rows < cap and self.batch_window_s > 0:
                deadline = time.perf_counter() + self.batch_window_s
                while rows < cap:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or not self._not_empty.wait(timeout=remaining):
                        break
                    dq = self._queues.get(skey)
                    while dq and rows < cap:
                        e = self._pop_locked(dq)
                        batch.append(e)
                        rows += e[4] or 1
        return batch

    def _worker(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            now = time.perf_counter()
            live = []
            for entry in batch:
                _x, fut, t_sub, deadline, _n, _seq, tctx, meta = entry
                if deadline is not None and now > deadline:
                    self._count("shed_deadline")
                    if self._reg.enabled:
                        olab = _origin_labels(meta)
                        self._m_shed.inc(model=self.name, reason="deadline", **olab)
                        self._m_requests.inc(model=self.name, outcome="shed_deadline", **olab)
                    if tctx is not None:
                        tctx.add_span("serving.queue_wait", t_sub, now)
                        tctx.add_span("serving.shed", now, now, reason="deadline")
                        tctx.finish(status="shed")
                    fut._set_error(_overloaded(
                        f"model {self.name!r}: deadline exceeded while queued "
                        f"({1e3 * (now - t_sub):.1f} ms)", "deadline"))
                    continue
                live.append(entry)
            if self._reg.enabled:
                self._m_depth.set(self._pending_rows, model=self.name)
            if not live:
                continue
            # a failing forward must fail THESE requests, not the loop
            try:
                # one read of the forward a batch: a hot swap rebinds it
                # between batches, never inside one
                fwd = self._fwd
                parts = [e[0] for e in live]
                batch_seq = None
                if fwd.seq_aware:
                    # one seq bucket per drain, but real lengths inside it
                    # vary: pad each entry to the batch max so the concat
                    # is rectangular
                    batch_seq = max(e[5] for e in live)
                    parts = [_pad_rows_np(p, e[4] or 1, seq_target=batch_seq)
                             for p, e in zip(parts, live)]
                n_rows = sum(e[4] or 1 for e in live)
                usage = []
                t_fwd = time.perf_counter()
                with _tm.span("serving.batch", model=self.name, size=n_rows):
                    ys = fwd(_concat(parts), _usage=usage)
                done = time.perf_counter()
                # the usage ledger, priced at the padded (batch, seq) shapes
                # the forward ran; device seconds, FLOPs and padded tokens
                # prorated by rows (host numbers: no device read)
                device_s = done - t_fwd
                padded_rows = sum(u["batch_bucket"] for u in usage)
                padded_tokens = sum(u["batch_bucket"] * u["seq_bucket"] for u in usage)
                flops = _metering.estimate_flops(fwd.param_count, padded_rows,
                                                 padded_tokens=padded_tokens)
                meter = _metering.get_meter()
                lats, ctxs, origins, off = [], [], [], 0
                for x_in, fut, t_sub, _dl, n, seq, tctx, meta in live:
                    width = n or 1
                    meter.record(
                        self.name, rows=width,
                        tokens=sum(int(np.size(a)) for a in
                                   (x_in.values() if isinstance(x_in, dict) else [x_in])),
                        seq_tokens=width * (seq or 1),
                        padded_tokens=padded_tokens * width / n_rows,
                        queue_s=now - t_sub, device_s=device_s * width / n_rows,
                        flops=flops * width / n_rows, tenant=(meta or {}).get("tenant"))
                    y = _tree_map(lambda a: a[off:off + width], ys)
                    if batch_seq is not None:
                        y = _slice_seq(y, batch_seq, seq)
                    if n is None:
                        y = _tree_map(lambda a: a[0], y)
                    off += width
                    lats.append(done - t_sub)
                    ctxs.append(tctx)
                    origins.append((meta or {}).get("origin"))
                    if tctx is not None:
                        # the device batch is one event shared by its requests
                        tctx.add_span("serving.queue_wait", t_sub, now)
                        tctx.add_span("serving.forward", t_fwd, done, size=n_rows)
                        tctx.add_span("serving.resolve", done, time.perf_counter())
                        tctx.finish()
                    fut.latency_s = done - t_sub
                    # resolve last: a waiter that wakes here sees a complete trace
                    fut._set(y)
                self._count("served", off)
                _cc.note_first_request()
                self._note_latencies(lats, outcome="served", ctxs=ctxs, origins=origins)
            except Exception as e:  # noqa: BLE001 — propagate to waiters
                for entry in live:
                    if entry[6] is not None:
                        entry[6].finish(status="error")
                    if not entry[1].done():
                        entry[1]._set_error(e)
                    if self._reg.enabled:
                        self._m_requests.inc(model=self.name, outcome="error",
                                             **_origin_labels(entry[7]))
                self._count("errors", len(live))

    def _count(self, key, n=1):
        with self._lock:
            self._counts[key] += n

    def _note_latencies(self, lats, outcome=None, ctxs=None, origins=None):
        """Record request latencies into the rolling ring; with telemetry
        on, observe each into the latency histogram (under its request's
        trace, so a bucket's exemplar names a trace), count it by
        ``outcome`` and refresh the p50/p99 gauges. ``origins`` (aligned
        with ``lats``) marks synthetic requests: they observe into
        origin-labelled series and never enter the ring or the gauges."""
        organic = [dt for i, dt in enumerate(lats) if not (origins and origins[i])]
        with self._lock:
            self._recent_latencies.extend(organic)
            del self._recent_latencies[:-512]
            recent = list(self._recent_latencies)
        if self._reg.enabled:
            for i, dt in enumerate(lats):
                olab = {"origin": str(origins[i])} if origins and origins[i] else {}
                with _tracectx.attach(ctxs[i] if ctxs else None):
                    self._m_latency.observe(dt, model=self.name, **olab)
                if outcome is not None:
                    self._m_requests.inc(model=self.name, outcome=outcome, **olab)
            if recent:
                self._m_p50.set(float(np.percentile(recent, 50)), model=self.name)
                self._m_p99.set(float(np.percentile(recent, 99)), model=self.name)

    def health(self):
        """The health export: the engine's ``stats()``, the compile cache's
        events (``compile_cache_total``: a supervisor reads from them that
        this process warm-started), the recapture counts by site
        (``telemetry/devices.py recompile_counts``) and this model's slice
        of the usage ledger."""
        from deeplearning4j_tpu_torch.telemetry import devices as _devices
        return {"stats": self.stats(), "compile_cache_events": _cc.event_counts(),
                "recompiles": _devices.recompile_counts(),
                "usage": _metering.get_meter().usage()["models"].get(self.name)}

    # ---- status ----

    def latency_percentiles(self):
        """(p50_s, p99_s) over the recent-latency ring, or (None, None)."""
        with self._lock:
            recent = list(self._recent_latencies)
        if not recent:
            return None, None
        return (float(np.percentile(recent, 50)),
                float(np.percentile(recent, 99)))

    def stats(self):
        """The status payload for this model."""
        with self._lock:
            counts = dict(self._counts)
            depth = self._pending_rows
        p50, p99 = self.latency_percentiles()
        fwd = self._fwd
        return {
            "model": self.name,
            "running": self.running,
            "device": str(self.device),
            "buckets": fwd.buckets.batch.sizes() if fwd.seq_aware else fwd.buckets.sizes(),
            "seq_buckets": fwd.buckets.seq.sizes() if fwd.seq_aware else None,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "max_queue": self.max_queue,
            "queue_depth": depth,
            "requests": counts,
            "forward": fwd.stats(),
            "aot": fwd.aot_stats(),
            "warmup_s": self._warmup_s,
            "latency_ms": {
                "p50": None if p50 is None else round(1e3 * p50, 3),
                "p99": None if p99 is None else round(1e3 * p99, 3)},
        }


def _load_manifest(manifest):
    """A ``WarmManifest`` as given, or read leniently from a path."""
    if isinstance(manifest, (str, os.PathLike)):
        return _cc.WarmManifest.load_lenient(manifest, context=f"warm manifest {manifest!r}")
    return manifest


def _signature(x):
    """A padded input's (shape, dtype) per leaf: one grid entry's key."""
    leaves = [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
    return [[list(np.shape(a)), str(np.asarray(a).dtype)] for a in leaves]


def _param_count(net):
    """Element count of a network's parameters; 0 when it exposes none
    (metering then records zero FLOPs, never an error)."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree
    try:
        return sum(int(t.numel()) for t in flatten_tree(net.params).values())
    except Exception:
        return 0
