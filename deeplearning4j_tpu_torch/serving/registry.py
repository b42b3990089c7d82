"""Multi-model serving registry: several named models behind one process.

The port of ``deeplearning4j_tpu/serving/registry.py``: named models,
each with its own continuous-batching engine, and one status surface (the
``serve`` CLI verb prints it). Hot swap, A/B registration and warm
manifest gating are not ported yet.
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.serving.engine import ServingEngine


class ModelRegistry:
    """Named :class:`ServingEngine` instances."""

    def __init__(self):
        self._lock = threading.RLock()
        self._engines = {}

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
