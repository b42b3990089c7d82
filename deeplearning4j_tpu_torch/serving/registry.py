"""Multi-model serving registry: several named models behind one process.

The port of ``deeplearning4j_tpu/serving/registry.py``: named models,
each with its own continuous-batching engine, one status surface (the
``serve`` CLI verb prints it) and one health export. Each model's engine
kwargs are kept (``engine_kwargs``), so ``register_like`` registers an A/B
challenger under the incumbent's serving config, shape grid included, and
``update_model`` hot-swaps a model's weights on its registered grid.
``submit(tenant=, origin=)`` meters each request
(``serving/metering.py``). A swap bundle that ships a warm manifest is
gated first: a manifest whose entries were warmed on a DIFFERENT shape
grid is rejected with a counted ``serving_bundle_rejected_total``
increment (JAX ``:28-39``, ``:129-153``), never silently attached; one on
the registered grid is attached to the swap.
"""

from __future__ import annotations

import os
import threading

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.utils import compile_cache as _cc


def manifest_grid_signatures(manifest):
    """The set of 2-D grid signatures a warm manifest's SERVING entries
    were warmed on — ``None`` in the set stands for batch-only (1-D)
    entries whose kind carries no ``:grid=`` tag. Empty when the manifest
    holds no serving entries at all."""
    grids = set()
    for kind, _sig in manifest.keys():
        if not str(kind).startswith("serving"):
            continue
        grids.add(kind.split(":grid=", 1)[1] if ":grid=" in kind else None)
    return grids


class ModelRegistry:
    """Named :class:`ServingEngine` instances."""

    def __init__(self):
        self._lock = threading.RLock()
        self._engines = {}
        self._engine_kw = {}  # name -> the kwargs register() built it with
        self._m_rejected = _tm.get_registry().counter(
            "serving_bundle_rejected_total",
            "hot-swap bundles refused per model and reason (grid_mismatch: the "
            "bundle's warm manifest was warmed on a different shape grid than the "
            "registered engine serves)")

    def register(self, name, net, *, start=True, **engine_kw):
        """Build (and by default start) a serving engine for ``net`` under
        ``name``. Engine kwargs (``input_spec``, ``buckets``,
        ``seq_buckets``, ``max_batch_size``, ``max_queue``,
        ``default_deadline_s``, ``device``, ...) pass through; with an
        ``input_spec`` the engine warms every bucket before this returns."""
        def duplicate():
            return ValueError(f"model {name!r} already registered")
        with self._lock:
            # check BEFORE building: the constructor warms every bucket
            if name in self._engines:
                raise duplicate()
        engine = ServingEngine(net, name=name, **engine_kw)
        with self._lock:
            if name in self._engines:  # raced a concurrent register
                raise duplicate()
            self._engines[name] = engine
            self._engine_kw[name] = dict(engine_kw)
        if start:
            engine.start()
        return engine

    def engine(self, name) -> ServingEngine:
        with self._lock:
            try:
                return self._engines[name]
            except KeyError:
                raise KeyError(f"no model {name!r} registered; known: "
                               f"{sorted(self._engines)}") from None

    def engine_kwargs(self, name):
        """The engine kwargs ``name`` was registered with (a copy)."""
        self.engine(name)  # the helpful KeyError on an unknown name
        with self._lock:
            return dict(self._engine_kw.get(name, {}))

    def register_like(self, src_name, name, net, *, start=True, **overrides):
        """A/B helper: register ``net`` under ``name`` with the SAME engine
        kwargs as ``src_name`` (input spec, shape grid, deadlines, device),
        ``overrides`` on top, so the challenger pads and buckets as the
        incumbent does."""
        kw = self.engine_kwargs(src_name)
        kw.update(overrides)
        return self.register(name, net, start=start, **kw)

    def update_model(self, name, net, warm=None, *, manifest=None):
        """Hot swap of one named model (in-flight batches finish on the old
        model; no queued request is dropped), on the engine's registered
        shape grid. ``manifest`` (the replacement bundle's warm manifest, a
        ``WarmManifest`` or a path) is gated BEFORE the swap: one warmed on
        another (batch, seq) grid than this engine serves is a config error,
        rejected with a ``ValueError`` and a
        ``serving_bundle_rejected_total{reason=grid_mismatch}`` count; one
        on the grid is attached to the swap. A missing file swaps cold, and
        silently."""
        engine = self.engine(name)
        if manifest is not None:
            manifest = self._gate_bundle_grid(engine, manifest)
        engine.update_model(net, warm=warm, manifest=manifest)

    def _gate_bundle_grid(self, engine, manifest):
        """``manifest`` (read leniently from a path) once its serving
        entries' grid is the engine's; None for an unreadable file."""
        if isinstance(manifest, (str, os.PathLike)):
            manifest = _cc.WarmManifest.load_lenient(
                manifest, context=f"swap bundle manifest {manifest!r}")
            if manifest is None:  # unreadable or missing file: a cold swap, not a gate
                return None
        declared = manifest_grid_signatures(manifest)
        if not declared:
            return manifest  # no serving entries to disagree with
        fwd = engine._fwd
        registered = fwd.buckets.signature() if fwd.seq_aware else None
        if declared != {registered}:
            def show(g):
                return sorted("batch-only" if s is None else s for s in g)
            if _tm.get_registry().enabled:
                self._m_rejected.inc(model=engine.name, reason="grid_mismatch")
            raise ValueError(
                f"model {engine.name!r}: swap bundle's warm manifest was warmed on shape "
                f"grid(s) {show(declared)} but the registered engine serves "
                f"{show({registered})} — re-export the manifest on the registered grid "
                "(counted in serving_bundle_rejected_total)")
        return manifest

    def unregister(self, name):
        """Stop ``name``'s engine and drop it."""
        with self._lock:
            engine = self._engines.pop(name)
            self._engine_kw.pop(name, None)
        engine.stop()

    def names(self):
        with self._lock:
            return sorted(self._engines)

    def submit(self, name, x, deadline_s=None, *, batched=False, tenant=None, origin=None):
        """Enqueue ``x`` on ``name``'s engine; returns its future.
        ``tenant`` attributes it in the usage ledger, ``origin`` marks
        synthetic traffic (``ServingEngine.submit``)."""
        return self.engine(name).submit(x, deadline_s=deadline_s, batched=batched,
                                        tenant=tenant, origin=origin)

    def output(self, name, x):
        """``name``'s engine's synchronous forward of ``x``."""
        return self.engine(name).output(x)

    def status(self):
        """Per-model engine stats."""
        with self._lock:
            engines = list(self._engines.values())
        return {"models": {e.name: e.stats() for e in engines}}

    def health(self):
        """Per-model engine health exports."""
        with self._lock:
            engines = list(self._engines.values())
        return {"models": {e.name: e.health() for e in engines}}

    def stop(self):
        """Stop and drop every engine."""
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
            self._engine_kw.clear()
        for e in engines:
            e.stop()


_default = None
_default_lock = threading.Lock()


def get_model_registry() -> ModelRegistry:
    """The process-wide default registry (what the ``serve`` verb uses)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ModelRegistry()
    return _default


def reset():
    """Stop every engine in the default registry and drop it (tests)."""
    global _default
    with _default_lock:
        reg, _default = _default, None
    if reg is not None:
        reg.stop()
