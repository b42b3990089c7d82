"""Multi-model serving registry: several named models behind one process.

The port of ``deeplearning4j_tpu/serving/registry.py``: named models,
each with its own continuous-batching engine, and one status surface (the
``serve`` CLI verb prints it). Each model's engine kwargs are kept
(``engine_kwargs``). Hot swap, A/B registration (``update_model``,
``register_like``), warm manifest gating, per-tenant metering
(``submit``'s ``tenant=``/``origin=``) and ``health`` wait for the
serving extras (ROADMAP queue 1, item 7.3).
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.serving.engine import ServingEngine


class ModelRegistry:
    """Named :class:`ServingEngine` instances."""

    def __init__(self):
        self._lock = threading.RLock()
        self._engines = {}
        self._engine_kw = {}  # name -> the kwargs register() built it with

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
        ``tenant``/``origin`` are per-tenant metering, which is not ported:
        they raise rather than be dropped."""
        if tenant is not None or origin is not None:
            raise NotImplementedError(
                "submit(tenant=, origin=) is serving/metering.py, which is not ported yet "
                "(ROADMAP queue 1, item 7.3)")
        return self.engine(name).submit(x, deadline_s=deadline_s, batched=batched)

    def output(self, name, x):
        """``name``'s engine's synchronous forward of ``x``."""
        return self.engine(name).output(x)

    def status(self):
        """Per-model engine stats."""
        with self._lock:
            engines = list(self._engines.values())
        return {"models": {e.name: e.stats() for e in engines}}

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
