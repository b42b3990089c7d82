"""Persistent kernel-tuning database + process-wide runtime lookup.

The port of ``deeplearning4j_tpu/tuning/db.py``, with the same JSON
document, key layout and counters. Winners are keyed **kernel id x shape
bucket x dtype x backend fingerprint** and persisted as one JSON artifact
(env ``DL4J_TPU_TUNING_DB``, populated by the ``tune`` CLI verb) that the
ops-layer dispatch seams consult. The kernel ids and key shapes are the
JAX dispatch seams': ``attention`` (B, T, H, D), ``conv_matmul`` (n, cin,
cout) with n the GEMM's rows, ``conv3x3`` (b, h, w, cin, cout) (output
h, w: a stride-2 call keys as the stride-1 call of its output size) and
``lstm`` (t, b, h). A config is the ``plan()`` fields the compiled
library takes at run time (``tuning/space.py``).

The backend fingerprint is ``utils/compile_cache.backend_fingerprint()``
(``torch-<ver>/cuda-<ver>/<device>/sm_<cc>``), so a DB the JAX package
wrote loads here and misses, and the reverse holds too. A winner is keyed
by the device its candidates ran on (``record(device=)``): a search run
on the CPU, where every candidate is the same plain version, keys as
``torch-<ver>/cpu`` and never reaches a card's lookup.

Degradation: a corrupt or newer-versioned DB warns, counts a
``mismatch_drop``, and degrades to the hand-picked ``plan()`` defaults —
never a crash. Every interaction counts into
``tuning_db_total{event=hit|miss|tune|reject|mismatch_drop}``:

* ``hit``/``miss`` — a dispatch seam found / did not find a tuned config
  for the (bucketed) call shape;
* ``tune`` — a searched winner was recorded;
* ``reject`` — a candidate failed the parity gate during search
  (``tuning/measure.py``) and was discarded;
* ``mismatch_drop`` — a corrupt/newer-version DB artifact was refused.

The seams resolve a plan once per (call key, DB binding) and keep it
(``ops/_plans.py``), so the counters move once per distinct plan, as the
JAX package's move once per trace, and a launch reads no file.
``plan_binding()`` is that view of the active DB: resolved once, and
renewed by ``set_db`` (which empties the seams' caches) or by an
``active_db()`` that finds the environment's file changed.
``active_fingerprint`` folds into warm-manifest signatures
(``utils/compile_cache.full_signature``), so a re-tuned DB misses stale
manifest entries instead of serving plans tuned under the old DB.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings

__all__ = ["ENV_DB", "TuningDB", "active_db", "active_fingerprint",
           "bucket_shape", "count_event", "event_counts", "plan_binding",
           "set_db", "tuned_config"]

#: environment variable naming the tuning-DB JSON artifact
ENV_DB = "DL4J_TPU_TUNING_DB"

DB_VERSION = 1


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _counter():
    from deeplearning4j_tpu_torch import telemetry as _tm
    return _tm.get_registry().counter(
        "tuning_db_total",
        "kernel-tuning DB interactions by event: hit (dispatch found a "
        "tuned config for the call's shape bucket), miss (no entry — "
        "hand-picked defaults apply), tune (a searched winner was "
        "recorded), reject (a candidate failed the parity gate during "
        "search), mismatch_drop (corrupt or newer-version DB artifact "
        "refused at load — defaults apply)")


def count_event(event, n=1):
    """Count one ``tuning_db_total`` interaction."""
    _counter().inc(n, event=event)


def event_counts():
    """{event: count} snapshot of ``tuning_db_total``."""
    from deeplearning4j_tpu_torch import telemetry as _tm
    c = _tm.get_registry().get("tuning_db_total")
    if c is None:
        return {}
    return {ls.get("event", ""): c.value(**ls) for ls in c.labelsets()}


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def bucket_shape(shape):
    """Each dim rounded up to the next power of two — one tuned entry
    covers the whole bucket (a T=1000 call reuses the T=1024 winner)."""
    out = []
    for d in shape:
        d = int(d)
        out.append(d if d <= 1 else 1 << (d - 1).bit_length())
    return tuple(out)


def _dtype_str(dtype):
    """Canonical dtype spelling ("float32", "bfloat16") whatever form the
    caller holds — a torch dtype, a numpy dtype or a string."""
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    try:
        import numpy as np
        return str(np.dtype(dtype))
    except TypeError:
        return str(getattr(dtype, "name", dtype) or dtype)


def _key(kernel, shape, dtype, backend_fp):
    bucket = ",".join(str(d) for d in bucket_shape(shape))
    return f"{kernel}|{bucket}|{_dtype_str(dtype)}|{backend_fp}"


class TuningDB:
    """Searched kernel winners, keyed (kernel, shape bucket, dtype,
    backend fingerprint), JSON round-trip. ``version`` moves with every
    ``record`` (the seams' plan caches key on it)."""

    def __init__(self, path=None):
        self.path = path
        self.entries = {}  # key -> {"config": {...}, "score_ms": ...}
        self.version = 0
        self._lock = threading.Lock()

    @staticmethod
    def backend_fingerprint(device=None):
        from deeplearning4j_tpu_torch.utils.compile_cache import backend_fingerprint
        return backend_fingerprint(device)

    def __len__(self):
        with self._lock:
            return len(self.entries)

    def record(self, kernel, shape, dtype, config, score_ms=None, meta=None, device=None):
        """Persist a parity-gated winner for this shape bucket, measured on
        ``device`` (default: the process's card, else the CPU), under that
        device's backend fingerprint (counts ``tune``). Overwrites any
        previous winner for the key — a re-tune IS the refresh."""
        entry = {"config": dict(config),
                 "kernel": kernel,
                 "shape_bucket": list(bucket_shape(shape)),
                 "dtype": _dtype_str(dtype)}
        if score_ms is not None:
            entry["score_ms"] = round(float(score_ms), 6)
        if meta:
            entry.update(meta)
        key = _key(kernel, shape, dtype, self.backend_fingerprint(device))
        with self._lock:
            self.entries[key] = entry
            self.version += 1
        count_event("tune")
        return entry

    def lookup(self, kernel, shape, dtype):
        """The tuned config dict for this call's shape bucket on the
        process's card (else the CPU), or None. Counts ``hit``/``miss``."""
        key = _key(kernel, shape, dtype, self.backend_fingerprint())
        with self._lock:
            entry = self.entries.get(key)
        if entry is None:
            count_event("miss")
            return None
        count_event("hit")
        return dict(entry["config"])

    def fingerprint(self):
        """Content hash of the entries — folded into warm-manifest
        signatures (utils/compile_cache.full_signature)."""
        with self._lock:
            doc = json.dumps(self.entries, sort_keys=True)
        return hashlib.sha256(doc.encode()).hexdigest()[:16]

    # -- persistence ---------------------------------------------------

    def save(self, path=None):
        """Atomic JSON write (tmp + rename)."""
        path = path or self.path
        if not path:
            raise ValueError("TuningDB.save: no path (pass one or construct with path=)")
        with self._lock:
            entries = dict(self.entries)
        doc = {"tuning_db_version": DB_VERSION,
               "backend_note": self.backend_fingerprint(),
               "entries": entries}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.path = path
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            doc = json.load(f)
        ver = doc.get("tuning_db_version", 0)
        if not isinstance(doc.get("entries"), dict):
            raise ValueError("not a tuning DB (no entries map)")
        if ver > DB_VERSION:
            raise ValueError(f"tuning DB version {ver} is newer than supported {DB_VERSION}")
        db = cls(path)
        db.entries = dict(doc["entries"])
        return db

    @classmethod
    def load_lenient(cls, path, context="tuning DB"):
        """``load`` that degrades instead of raising: a corrupt or
        newer-version artifact warns, counts ``mismatch_drop``, and
        returns None. A missing file is the normal before-first-tune
        state (silent)."""
        try:
            return cls.load(path)
        except FileNotFoundError:
            return None
        except Exception as e:  # noqa: BLE001 — any unreadable artifact degrades
            warnings.warn(f"{context} at {path!r} is unusable ({e}) — ignoring it; "
                          "the hand-picked kernel defaults apply", stacklevel=3)
            count_event("mismatch_drop")
            return None


# ---------------------------------------------------------------------------
# process-wide runtime lookup (the dispatch seams' entry point)
# ---------------------------------------------------------------------------

_rt_lock = threading.Lock()
_rt = {"explicit": False, "db": None, "path": None, "mtime": None}
_UNSET = object()
#: the seams' binding: the active DB as last resolved (``plan_binding``)
_bound = [_UNSET]
#: callables emptied on every rebind (the seams' plan caches)
_rebind_hooks = []


def on_rebind(fn):
    """Call ``fn()`` whenever the active DB is rebound."""
    _rebind_hooks.append(fn)


def _rebound(db):
    _bound[0] = db
    for fn in list(_rebind_hooks):
        fn()


def set_db(db):
    """Bind ``db`` as the process's active tuning DB (tests, the tune CLI,
    chip_smoke). ``set_db(None)`` returns to env-var resolution."""
    with _rt_lock:
        _rt["explicit"] = db is not None
        _rt["db"] = db
        _rt["path"] = None
        _rt["mtime"] = None
    _rebound(db if db is not None else _UNSET)


def active_db():
    """The active TuningDB: an explicit ``set_db`` binding, else the
    ``$DL4J_TPU_TUNING_DB`` artifact (cached by path+mtime), else None. A
    changed artifact rebinds the seams."""
    with _rt_lock:
        if _rt["explicit"]:
            return _rt["db"]
        path = os.environ.get(ENV_DB)
        if not path:
            changed = _rt["db"] is not None
            _rt["db"], _rt["path"], _rt["mtime"] = None, None, None
            db = None
        else:
            try:
                mtime = os.stat(path).st_mtime_ns
            except OSError:
                mtime = None  # missing file: cache the miss until it appears
            changed = not (_rt["path"] == path and _rt["mtime"] == mtime)
            if changed:
                _rt["path"], _rt["mtime"] = path, mtime
                _rt["db"] = TuningDB.load_lenient(path) if mtime is not None else None
            db = _rt["db"]
    if changed or _bound[0] is _UNSET:
        _rebound(db)
    return db


def plan_binding():
    """The DB the seams resolve plans under: the active DB as last
    resolved, without a file read or an ``os.stat`` once it is known."""
    db = _bound[0]
    return active_db() if db is _UNSET else db


def active_fingerprint():
    """Content fingerprint of the active DB, or None when no DB is bound
    (or it is empty) — the manifest-signature ingredient."""
    db = active_db()
    return None if db is None or not len(db) else db.fingerprint()


def tuned_config(kernel, shape, dtype):
    """The tuned config for this call, or None (no DB bound, or no entry
    for the bucket — hand-picked defaults apply). Never raises."""
    try:
        db = active_db()
        if db is None:
            return None
        return db.lookup(kernel, shape, dtype)
    except Exception:  # noqa: BLE001 — a tuning lookup must never kill a launch
        return None
