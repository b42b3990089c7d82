"""Compile-artifact tier: the persistent kernel cache and warm manifests.

The port of ``deeplearning4j_tpu/utils/compile_cache.py``. In the JAX
package a cold start costs XLA compiling each jit signature. The port has
no such compile; a new process pays three other things instead:

1. **nvcc building each ``csrc/*.cu`` library** (``ops/_build.py``): once
   a source, seconds to tens of seconds each, and by far the largest.
2. **The launch plan of each kernel call**: ``plan()``'s hand-picked
   fields, or a tuning DB's winner for the call's bucket
   (``ops/_plans.py``, ``tuning/``), resolved once per distinct call.
3. **The first eager run of a signature, or its CUDA-graph capture** (the
   K-step engine, ``nn/fused.py``): kernel attributes, cuDNN's algorithm
   choice, the allocator's pools, the graph itself.

A CUDA graph cannot be serialized, so the third cost is paid again in every
process. The two tiers take the first two off the restart:

* **Tier (a), the persistent kernel cache.** ``enable_persistent_cache``
  (env ``DL4J_TPU_COMPILE_CACHE``) moves the build directory. Libraries
  stay keyed by the source's hash, and the key also takes the nvcc flags
  and nvcc's version, so a library built with other flags or another
  compiler is never reused. Without the variable the directory stays
  ``_build/``. ``kernel_builds_total{source}`` and
  ``kernel_build_seconds{source}`` count every nvcc run.
* **Tier (b), the warm manifest.** :class:`WarmManifest` keeps the JAX
  package's zip container: a ``manifest.json`` (``manifest_version`` 1,
  ``model_fp``, ``backend_fp``, ``entries`` of ``{kind, signature,
  file}``), one file an entry. An entry is JSON, never pickle: the launch
  plans the signature's warm-up resolved (kernel library, call key, the
  tuned config and the plan's fields) and the keys of the kernel libraries
  it launched. The manifest also carries those libraries' bytes, once
  each, with the release of the nvcc that built them (``libraries`` in
  ``manifest.json``). On a hit a library is installed into the build
  directory only when its key is the one ``ops/_build.library_key``
  computes for the checkout's source and flags with that release, and
  this host has the same nvcc or none (``ops/_build.library_state``); any
  other counts ``mismatch_drop`` and the entry is not served (the warm-up
  runs live and builds it). A manifest that came inside a checkpoint
  bundle installs libraries only where the caller chose the build
  directory (``enable_persistent_cache``); otherwise an entry whose
  libraries are not built here warms live. A **hit** means the signature
  warms with no nvcc run and no tuning lookup: the plans are seeded from
  the entry. The eager warm-up or the graph capture still runs, and is
  counted as a ``capture``, never as a hit.

Every manifest key goes through ``full_signature``, which folds the active
tuning DB's fingerprint in: a re-tuned DB misses, and a stale plan is never
served. ``backend_fingerprint()`` is ``torch-<ver>/cuda-<ver>/<device
name>/sm_<cc>`` (``torch-<ver>/cpu`` without a card), so each package
opens the other's manifest and refuses it by fingerprint
(``mismatch_drop``); the port never unpickles anything.

Trust model: loading a manifest installs native code (the libraries it
ships are loaded into the process by ``ctypes``), so a manifest is a
trusted deployment artifact, as the checkpoint it ships with: never an
untrusted upload.

Observability: ``compile_cache_total{event=hit|miss|capture|serialize|
serialize_fail|deserialize_fail|mismatch_drop}`` counts every manifest
interaction, and the ``time_to_first_step_ms`` / ``time_to_first_request_ms``
gauges record the realized cold-start tax (``health()``). Every signature
warms through :func:`aot_compile`: the manifest first, then the live
warm-up, then the write-back, each counted.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import time
import warnings
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import _build

__all__ = ["ENV_CACHE_DIR", "WarmManifest", "aot_compile", "attach_if_matches",
           "attach_manifest", "backend_fingerprint", "enable_persistent_cache",
           "full_signature", "model_fingerprint", "note_first_request", "note_first_step",
           "signature_of", "status"]

#: environment variable naming the persistent kernel-cache directory
ENV_CACHE_DIR = _build.ENV_CACHE_DIR

MANIFEST_VERSION = 1


def _process_start_anchor():
    """The perf_counter value at PROCESS start — /proc-derived on Linux so
    the first-step/first-request gauges include interpreter + torch import;
    falls back to module-import time elsewhere."""
    try:
        with open("/proc/self/stat", "rb") as f:
            # fields after the parenthesized comm; starttime is stat
            # field 22 -> index 19 here, in clock ticks since boot
            fields = f.read().rsplit(b")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime_s = float(f.read().split()[0])
        age_s = uptime_s - start_ticks / os.sysconf("SC_CLK_TCK")
        if age_s > 0:
            return time.perf_counter() - age_s
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter()


#: perf_counter at process start — the zero point of the cold-start gauges
PROCESS_T0 = _process_start_anchor()

_lock = threading.Lock()
_first_marks: dict = {}


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _instruments():
    from deeplearning4j_tpu_torch import telemetry as _tm
    reg = _tm.get_registry()
    return (reg,
            reg.counter(
                "compile_cache_total",
                "warm-manifest interactions by event: hit (entry's libraries "
                "installed and plans seeded: no nvcc run, no tuning lookup), "
                "miss (no entry, or one whose libraries this process may not "
                "install and has not built — live warm-up), capture (a warm-up "
                "or graph capture ran), serialize (entry written into the manifest), "
                "serialize_fail (a launched library is not in the build "
                "directory), deserialize_fail (entry present but unreadable "
                "or its plans do not validate — live warm-up), mismatch_drop "
                "(manifest or library built for another model/backend/"
                "source, refused)"),
            reg.gauge(
                "time_to_first_step_ms",
                "wall ms from process start to the first completed train "
                "dispatch — the realized training cold-start tax"),
            reg.gauge(
                "time_to_first_request_ms",
                "wall ms from process start to the first served inference "
                "request — the realized serving cold-start tax"))


def count_event(event, n=1):
    """Count one ``compile_cache_total`` interaction."""
    _, c, _, _ = _instruments()
    c.inc(n, event=event)


def event_counts():
    """{event: count} snapshot of ``compile_cache_total`` (for health())."""
    from deeplearning4j_tpu_torch import telemetry as _tm
    c = _tm.get_registry().get("compile_cache_total")
    if c is None:
        return {}
    return {ls.get("event", ""): c.value(**ls) for ls in c.labelsets()}


def note_first_step():
    """Stamp ``time_to_first_step_ms`` once per process (first completed
    train dispatch). Later calls are a dict read and a branch."""
    return _note_first("step", "time_to_first_step_ms")


def note_first_request():
    """Stamp ``time_to_first_request_ms`` once per process (first served
    inference request)."""
    return _note_first("request", "time_to_first_request_ms")


def _note_first(mark, gauge_name):
    if mark in _first_marks:                # cheap unlocked fast path
        return None
    with _lock:
        if mark in _first_marks:
            return None
        ms = 1e3 * (time.perf_counter() - PROCESS_T0)
        _first_marks[mark] = ms
    _, _, g_step, g_req = _instruments()
    (g_step if gauge_name == "time_to_first_step_ms" else g_req).set(ms)
    return ms


def first_marks():
    """{mark: ms} of the stamped first-step/first-request marks."""
    with _lock:
        return dict(_first_marks)


def reset_marks():
    """Forget the once-per-process gauges (``telemetry.reset()``)."""
    with _lock:
        _first_marks.clear()


def status():
    """The health ``compile_cache`` payload: the build directory, nvcc runs
    and their seconds by source, event counts, and the realized cold-start
    gauges."""
    marks = first_marks()
    return {
        "persistent_cache_dir": str(_build.build_dir()),
        "kernel_builds": dict(_build.builds),
        "kernel_build_seconds": dict(_build.build_seconds),
        "events": event_counts(),
        "time_to_first_step_ms": marks.get("step"),
        "time_to_first_request_ms": marks.get("request"),
    }


# ---------------------------------------------------------------------------
# persistent kernel cache (tier a)
# ---------------------------------------------------------------------------

def enable_persistent_cache(cache_dir=None):
    """Build the kernel libraries into (and load them from) ``cache_dir``.

    ``cache_dir`` defaults to ``$DL4J_TPU_COMPILE_CACHE``; with neither
    set this is a no-op returning None (callers wire it unconditionally)
    and the libraries stay in ``_build/``. Returns the absolute directory."""
    if cache_dir is None:
        cache_dir = os.environ.get(ENV_CACHE_DIR)
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(str(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    return cache_dir


# ---------------------------------------------------------------------------
# fingerprints + signatures
# ---------------------------------------------------------------------------

def backend_fingerprint(device=None):
    """The backend a manifest's libraries and plans are bound to:
    ``torch-<ver>/cuda-<ver>/<device name>/sm_<major><minor>`` of the card
    (``device``, by default card 0 where there is one), or
    ``torch-<ver>/cpu`` for a CPU ``device`` or without a card."""
    dev = None if device is None else torch.device(device)
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    if dev is not None and dev.type == "cuda":
        idx = 0 if dev.index is None else dev.index
        major, minor = torch.cuda.get_device_capability(idx)
        return (f"torch-{torch.__version__}/cuda-{torch.version.cuda}/"
                f"{torch.cuda.get_device_name(idx)}/sm_{major}{minor}")
    return f"torch-{torch.__version__}/cpu"


def _flatten(tree, prefix=""):
    """(path, leaf) pairs of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaf_sig(leaf):
    if torch.is_tensor(leaf):
        return [list(leaf.shape), str(leaf.dtype).removeprefix("torch.")]
    if isinstance(leaf, np.ndarray):
        return [list(leaf.shape), str(leaf.dtype)]
    if leaf is None:
        return None
    return [[], type(leaf).__name__]


def model_fingerprint(net):
    """Architecture fingerprint: the config JSON and the param/state tree
    paths, shapes and dtypes. Free of values: a retrained checkpoint of the
    same architecture reuses its manifest."""
    h = hashlib.sha256()
    conf = getattr(net, "conf", None)
    try:
        h.update(conf.to_json().encode())
    except AttributeError:
        h.update(repr(type(net)).encode())
    for path, leaf in _flatten((getattr(net, "params", None), getattr(net, "state", None))):
        h.update(path.encode())
        h.update(json.dumps(_leaf_sig(leaf)).encode())
    return h.hexdigest()


def signature_of(args):
    """Canonical input-signature string of nested tensors / arrays: the
    tree's paths + per-leaf (shape, dtype). The manifest key a warm process
    recomputes without running anything."""
    return json.dumps([[p, _leaf_sig(leaf)] for p, leaf in _flatten(args)],
                      separators=(",", ":"))


def full_signature(signature):
    """``signature`` with the active TuningDB's content fingerprint folded
    in (a no-op without a bound, populated DB): plans resolve from the DB,
    so a re-tuned DB must miss the entries warmed under the old one. The
    one helper every manifest key goes through."""
    from deeplearning4j_tpu_torch.tuning.db import active_fingerprint
    fp = active_fingerprint()
    return str(signature) if not fp else f"{signature}|tuning:{fp}"


# ---------------------------------------------------------------------------
# warm manifest (tier b)
# ---------------------------------------------------------------------------

def _tuplify(x):
    return tuple(_tuplify(v) for v in x) if isinstance(x, list) else x


class WarmManifest:
    """Warm-up records keyed by (kind, input signature), scoped to ONE
    (model fingerprint, backend fingerprint) pair, and the kernel libraries
    they launched.

    ``put`` writes a warm-up's recording (``ops/_build.recording``) as an
    entry and takes the libraries' bytes from the build directory;
    ``warm`` serves one back: installs its libraries (unless
    ``install_libraries`` is False: then only libraries already built here
    serve) and seeds its plans.
    Every interaction counts into ``compile_cache_total``.
    ``save``/``load`` round-trip the manifest as a zip, and
    ``to_bytes``/``from_bytes`` embed it in a checkpoint bundle
    (``utils/serialization.save_bundle``)."""

    def __init__(self, model_fp=None, backend_fp=None):
        self.model_fp = model_fp
        self.backend_fp = backend_fp or backend_fingerprint()
        self._entries = {}    # (kind, signature) -> entry bytes (JSON)
        self._libraries = {}  # library key -> (source name, bytes, nvcc release)
        #: whether ``warm`` may write the shipped libraries into the build
        #: directory (``utils/serialization.load_bundle`` asks the caller)
        self.install_libraries = True
        self._mlock = threading.Lock()

    @classmethod
    def for_net(cls, net):
        """A fresh manifest scoped to ``net``'s architecture on this backend."""
        return cls(model_fingerprint(net))

    def matches(self, net):
        """True when this manifest was built for ``net``'s architecture on
        the running backend — the load-time gate before anything is used."""
        return (self.model_fp == model_fingerprint(net)
                and self.backend_fp == backend_fingerprint())

    def __len__(self):
        with self._mlock:
            return len(self._entries)

    def keys(self):
        with self._mlock:
            return sorted(self._entries)

    def has(self, kind, signature):
        """Uncounted membership probe (export paths — not a cache read)."""
        with self._mlock:
            return (str(kind), str(signature)) in self._entries

    def libraries(self):
        """{library key: source name} of the shipped libraries."""
        with self._mlock:
            return {k: lib[0] for k, lib in self._libraries.items()}

    # -- entries -------------------------------------------------------

    def put(self, kind, signature, recording):
        """Write ``recording`` (what one warm-up launched) under (kind,
        signature), with the bytes of every library it launched. Returns
        True; False (counted ``serialize_fail``, nothing kept) when a
        launched library is not in the build directory."""
        libs = {}
        for name in sorted(recording.libraries):
            got = _build.library_bytes(_build.source_named(name))
            if got is None:
                count_event("serialize_fail")
                return False
            libs[got[0]] = (name, *got[1:])
        plans = [{"kernel": kernel, "key": key, "config": config, "plan": fields}
                 for (kernel, key), (config, fields) in sorted(
                     recording.plans.items(), key=lambda kv: json.dumps(kv[0]))]
        blob = json.dumps({"plans": plans, "libraries": sorted(libs)},
                          sort_keys=True).encode()
        with self._mlock:
            self._entries[(str(kind), str(signature))] = blob
            self._libraries.update(libs)
        count_event("serialize")
        return True

    def warm(self, kind, signature):
        """Serve the entry of (kind, signature): install its libraries and
        seed its plans, counting ``hit``; None when there is no entry
        (``miss``), it cannot be read or its plans do not validate here
        (``deserialize_fail``), or a library of it was built for another
        source, flags or nvcc (``mismatch_drop``), or is not built here and
        may not be installed (``miss``)."""
        with self._mlock:
            blob = self._entries.get((str(kind), str(signature)))
            libs = dict(self._libraries)
        if blob is None:
            count_event("miss")
            return None
        try:
            entry = json.loads(blob)
            plans = [(p["kernel"], _tuplify(p["key"]), p["config"], p["plan"])
                     for p in entry["plans"]]
            wanted = [(key, libs[key]) for key in entry["libraries"]]
        except (ValueError, KeyError, TypeError):
            count_event("deserialize_fail")
            return None
        for key, (source, data, release) in wanted:
            state = _build.library_state(source, key, release)
            if state == "mismatch":
                count_event("mismatch_drop")
                return None
            if state == "absent":
                if not self.install_libraries:
                    count_event("miss")
                    return None
                _build.install_library(source, key, data, release)
        from deeplearning4j_tpu_torch.ops import _plans
        try:
            seeded = all(_plans.cache_for(kernel).seed(key, config, fields)
                         for kernel, key, config, fields in plans)
        except (KeyError, TypeError, ValueError):
            seeded = False
        if not seeded:
            count_event("deserialize_fail")
            return None
        count_event("hit")
        return entry

    # -- persistence ---------------------------------------------------

    def _write_zip(self, z):
        with self._mlock:
            entries = dict(self._entries)
            libraries = dict(self._libraries)
        names = []
        for i, ((kind, sig), blob) in enumerate(sorted(entries.items())):
            fname = f"entry_{i:04d}.json"
            names.append({"kind": kind, "signature": sig, "file": fname})
            z.writestr(fname, blob)
        libs = []
        for key, (source, data, release) in sorted(libraries.items()):
            fname = f"lib_{key}.so"
            libs.append({"key": key, "source": source, "nvcc": release, "file": fname})
            z.writestr(fname, data)
        z.writestr("manifest.json", json.dumps({
            "manifest_version": MANIFEST_VERSION,
            "model_fp": self.model_fp,
            "backend_fp": self.backend_fp,
            "torch_version": torch.__version__,
            "entries": names,
            "libraries": libs}, indent=1))

    @classmethod
    def _read_zip(cls, z):
        meta = json.loads(z.read("manifest.json"))
        if meta.get("manifest_version", 0) > MANIFEST_VERSION:
            raise ValueError(f"warm manifest version {meta['manifest_version']} is "
                             f"newer than supported {MANIFEST_VERSION}")
        m = cls(meta.get("model_fp"), meta.get("backend_fp"))
        for e in meta.get("entries", ()):
            # raw bytes: parsed as JSON only when served, never unpickled
            m._entries[(e["kind"], e["signature"])] = z.read(e["file"])
        for lib in meta.get("libraries", ()):
            m._libraries[lib["key"]] = (lib["source"], z.read(lib["file"]), lib.get("nvcc"))
        return m

    def save(self, path):
        """Write the manifest zip (atomic: tmp + rename)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
                self._write_zip(z)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def load(cls, path):
        with zipfile.ZipFile(path) as z:
            return cls._read_zip(z)

    @classmethod
    def load_lenient(cls, source, context="warm manifest"):
        """``load`` (path) / ``from_bytes`` (bytes) that degrades instead of
        raising: a truncated or non-zip artifact warns, counts a
        ``deserialize_fail``, and returns None. A missing file is the
        normal first cold start: silent."""
        try:
            if isinstance(source, bytes):
                return cls.from_bytes(source)
            return cls.load(source)
        except FileNotFoundError:
            return None
        except Exception:  # noqa: BLE001 — any unreadable artifact degrades
            warnings.warn(
                f"{context} is unreadable (corrupt or not a manifest zip) — ignoring "
                "it; the next warm-up builds and resolves live", stacklevel=3)
            count_event("deserialize_fail")
            return None

    def to_bytes(self):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            self._write_zip(z)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            return cls._read_zip(z)


# ---------------------------------------------------------------------------
# the one site where a signature warms
# ---------------------------------------------------------------------------

def aot_compile(fn, *args, manifest=None, kind="eager", signature=None, serialize_back=True):
    """Manifest-first warm-up of one signature: the site where every
    signature warms.

    The manifest first: on a hit its libraries are installed and its plans
    seeded. Then the live path: ``fn(*args)`` (the eager warm-up or the
    graph capture) runs either way, recording what it launches, and counts
    a ``capture``. Then the write-back: on a miss, with ``manifest`` and
    ``serialize_back``, the recording is written into the manifest, so the
    next restart is warm. Returns ``(fn's result, source)``, source
    ``"manifest"`` or ``"compile"``."""
    sig = full_signature(signature if signature is not None else signature_of(args))
    source = "compile"
    if manifest is not None and manifest.warm(kind, sig) is not None:
        source = "manifest"
    with _build.recording() as rec:
        out = fn(*args)
    count_event("capture")
    if source == "compile" and manifest is not None and serialize_back:
        manifest.put(kind, sig, rec)
    return out, source


def attach_if_matches(net, manifest, context):
    """The restore-side refusal policy: attach ``manifest`` when it was
    built for ``net`` on this backend; otherwise warn with ``context``,
    count a ``mismatch_drop``, and return None (the checkpoint itself
    still restores — the next fit warms live)."""
    if manifest is None:
        return None
    if manifest.matches(net):
        attach_manifest(net, manifest)
        return manifest
    warnings.warn(
        f"{context}: warm manifest was built for model={manifest.model_fp!r} on "
        f"backend={manifest.backend_fp!r} — not this net/backend; dropping it (state "
        "restored; the next fit warms live)", stacklevel=3)
    count_event("mismatch_drop")
    return None


def attach_manifest(net, manifest):
    """Bind ``manifest`` to ``net`` so the fused fit engine
    (``nn/fused.py``) warms its signatures from it. A manifest built for
    another architecture or backend is refused."""
    if manifest is not None and not manifest.matches(net):
        raise ValueError(
            "warm manifest does not match this net/backend "
            f"(manifest model={manifest.model_fp!r} backend={manifest.backend_fp!r}, "
            f"net model={model_fingerprint(net)!r} backend={backend_fingerprint()!r})")
    net._warm_manifest = manifest
    return net
