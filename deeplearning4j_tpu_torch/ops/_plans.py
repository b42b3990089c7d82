"""Launch plans resolved once per (call key, tuning-DB binding).

Each kernel wrapper asks its ``PlanCache`` for the plan of a call. The
first time a call key is seen under the bound DB (``tuning/db.py
plan_binding``), the cache resolves it: the hand-picked ``plan()``, or,
with a DB bound, the tuned config of the call's shape bucket where it
validates at this call (``tuning/space.py``). Later launches with that
key read the kept plan: no file read, no ``os.stat``, no DB lookup, so the
DB's hit/miss counters move once per distinct plan. A rebound DB empties
every cache. ``seed`` puts a plan from a warm manifest's entry in place
without a lookup, and ``pinned`` one of the tuner's candidates for the
length of a block; every resolution a warm-up makes is noted on its
recording (``_build.note_plan``).
"""

from __future__ import annotations

import contextlib
import json
import threading

import torch

from deeplearning4j_tpu_torch.ops import _build

#: the kernels' dtypes by the name call keys and DB keys carry
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_caches = []
_hooked = [False]
_db_mod = [None]


def _db():
    mod = _db_mod[0]
    if mod is None:
        from deeplearning4j_tpu_torch.tuning import db as mod
        _db_mod[0] = mod
    if not _hooked[0]:
        mod.on_rebind(clear_all)
        _hooked[0] = True
    return mod


def dtype_name(dtype):
    """"float32" for torch.float32 (or the string itself)."""
    return str(dtype).removeprefix("torch.")


def binding_token():
    """(the bound DB or None, a token that changes with the binding and
    with every ``record`` into the bound DB)."""
    db = _db().plan_binding()
    return db, (None if db is None else (id(db), db.version))


def clear_all():
    for cache in _caches:
        cache.clear()


def register(cache):
    """Empty ``cache`` (anything with ``clear()``) on every rebind too."""
    _caches.append(cache)
    return cache


class PlanCache:
    """Plans of one kernel library's calls. ``resolve(db, key, *extra)``
    returns ``(config, plan)``: the config is the tunable fields the plan
    took (``tuning/space.py``), ``db`` the bound TuningDB or None;
    ``configured(key, config)`` returns the plan a config gives at a key,
    or the reason (a string) it does not validate there."""

    def __init__(self, kernel, resolve, configured):
        self.kernel = kernel
        self._resolve = resolve
        self._configured = configured
        self._plans = {}
        self._lock = threading.Lock()
        _caches.append(self)

    def get(self, key, *extra):
        """The plan of a call with ``key`` (hashable, JSON-able: ints,
        strings, booleans and tuples of them); ``extra`` reaches
        ``resolve`` only (a card's occupancy query)."""
        db, token = binding_token()
        hit = self._plans.get((key, token))
        if hit is None:
            hit = self._resolve(db, key, *extra)
            with self._lock:
                self._plans[(key, token)] = hit
        _build.note_plan(self.kernel, key, hit[0], hit[1])
        return hit[1]

    def seed(self, key, config, fields):
        """Keep the plan ``config`` gives at ``key`` under the current
        binding, without a DB lookup; False (nothing kept) when it does not
        validate or differs from ``fields``, the plan the entry recorded."""
        pl = self._configured(key, config)
        if isinstance(pl, str) or json.loads(json.dumps(pl._asdict())) != dict(fields):
            return False
        _db_obj, token = binding_token()
        with self._lock:
            self._plans[(key, token)] = (dict(config), pl)
        return True

    @contextlib.contextmanager
    def pinned(self, key, config):
        """Launches with ``key`` take the plan ``config`` gives there (the
        tuner's candidates) until the block ends, then what they took
        before; ValueError where ``config`` does not validate at ``key``."""
        pl = self._configured(key, config)
        if isinstance(pl, str):
            raise ValueError(f"{self.kernel} config {config} refused at {key}: {pl}")
        _db_obj, token = binding_token()
        slot = (key, token)
        with self._lock:
            before = self._plans.get(slot)
            self._plans[slot] = (dict(config), pl)
        try:
            yield pl
        finally:
            with self._lock:
                if before is None:
                    self._plans.pop(slot, None)
                else:
                    self._plans[slot] = before

    def clear(self):
        with self._lock:
            self._plans.clear()

    def __len__(self):
        with self._lock:
            return len(self._plans)


def cache_for(kernel):
    """The PlanCache of a kernel library by its name ("conv_stats",
    "lstm_seq", "flash_attn"), importing its module; KeyError otherwise."""
    import importlib
    modules = {"conv_stats": "conv_stats", "lstm_seq": "lstm_seq", "flash_attn": "attention"}
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.ops.{modules[kernel]}")
    return mod.PLANS
