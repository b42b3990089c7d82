"""Fleet supervisor: spawn N serving workers, probe them, replace the dead.

The port of ``deeplearning4j_tpu/fleet/supervisor.py``. Every worker is
a subprocess running ``python -m deeplearning4j_tpu_torch.fleet.worker``
from the same checkpoint and warm manifest. A replacement's warm start is
judged from its ready line and recorded in the respawn ledger under the
JAX package's field names (``warm``, ``aot``, ``spawn_s``). The JAX
package's verdict (every bucket deserialized, zero lazy compiles) has no
counterpart here: a port worker still runs each bucket's warm-up forward
(or graph capture). Its verdict is the port's meaning of warm: every grid
entry served from the manifest (kernel libraries installed, launch plans
seeded, so no tuning lookup), none missed, and no nvcc run in the process
(``kernel_builds`` on the ready line).

Liveness is HTTP ``/health`` probes on an interval; a worker is declared
dead after ``max_missed_probes`` consecutive failures (or the moment its
process exits). On death the supervisor respawns from the same spec,
pushes the fresh endpoint to the attached :class:`FleetRouter` (stable
worker id, new address: metric labels stay bounded), and the router's
in-flight retries land on the survivors meanwhile.

Hot swap fans out ``ModelRegistry``-style: :meth:`update_model` POSTs
``/swap`` to every worker sequentially; each worker's swap is
warm-then-atomic internally, and the sequential fan-out keeps N-1 workers
serving at full capacity while each replacement forward warms.

Workers serve on ``device`` (default ``"cuda"``: every worker opens its
own CUDA context on the card; a host without one fails the spawn).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.fleet.router import _http_json
from deeplearning4j_tpu_torch.fleet.worker import ORIGIN_HEADER as _ORIGIN_HEADER


def default_worker_env():
    """Subprocess env for a fleet worker: this process's environment with
    the repo root on ``PYTHONPATH``, so ``-m`` resolves the package from
    any cwd. The device is the worker's ``--device``, never the env's."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    pp = env.get("PYTHONPATH")
    env["PYTHONPATH"] = repo if not pp else repo + os.pathsep + pp
    return env


class _WorkerProc:
    """One spawned worker: process handle + the state the monitor loop
    tracks. stdout/stderr are drained by daemon reader threads into
    bounded rings (a full pipe would wedge the worker)."""

    def __init__(self, wid, generation, proc):
        self.wid = wid
        self.generation = generation
        self.proc = proc
        self.port = None
        self.ready = threading.Event()
        self.ready_doc = None
        self.ready_at = None  # monotonic time the ready line landed
        #: the worker's monotonic+epoch clock pair off its ready line and
        #: the offset (its clock minus ours) estimated at receipt — the
        #: clock-alignment seed the cluster timeline re-anchors with
        self.clock = None
        self.clock_offset_s = 0.0
        self.missed = 0
        self.last_health = None
        self.out_ring = deque(maxlen=50)
        self.err_ring = deque(maxlen=50)

    @property
    def address(self):
        return None if self.port is None else f"http://127.0.0.1:{self.port}"

    def snapshot(self):
        return {"worker_id": self.wid, "generation": self.generation,
                "pid": self.proc.pid, "port": self.port,
                "alive": self.proc.poll() is None,
                "missed_probes": self.missed,
                "clock": self.clock,
                "clock_offset_s": self.clock_offset_s,
                "last_health": self.last_health}


class FleetSupervisor:
    """Spawn, probe, and elastically replace N fleet worker processes."""

    def __init__(self, n_workers, *, model_path=None, zoo=None,
                 name="default", buckets=None, seq_buckets=None,
                 input_shape=None,
                 warm_manifest=None, compile_cache=None, max_queue=256,
                 max_batch=32, deadline_ms=None, batch_window_ms=1.0,
                 env=None, worker_command=None, python=None,
                 spawn_timeout_s=180.0, probe_interval_s=0.5,
                 probe_timeout_s=2.0, max_missed_probes=3,
                 respawn_backoff_base_s=0.5, respawn_backoff_cap_s=30.0,
                 crashloop_window_s=5.0, device="cuda"):
        if model_path is None and zoo is None and worker_command is None:
            raise ValueError("FleetSupervisor needs model_path=, zoo=, "
                             "or a custom worker_command=")
        self.n_workers = int(n_workers)
        self.model_path = model_path
        self.zoo = zoo
        self.name = name
        self.buckets = buckets
        self.seq_buckets = seq_buckets
        self.input_shape = input_shape
        self.warm_manifest = warm_manifest
        self.compile_cache = compile_cache
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.deadline_ms = deadline_ms
        self.batch_window_ms = batch_window_ms
        self._env = env
        self._worker_command = worker_command
        self._python = python or sys.executable
        self.spawn_timeout_s = spawn_timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.max_missed_probes = max_missed_probes
        self.respawn_backoff_base_s = float(respawn_backoff_base_s)
        self.respawn_backoff_cap_s = float(respawn_backoff_cap_s)
        self.crashloop_window_s = float(crashloop_window_s)
        self.device = str(device)
        self._lock = threading.Lock()
        self._workers = {}        # wid -> _WorkerProc
        self._respawns = []       # ledger: one dict per replacement
        self._backoff = {}        # wid -> {level, not_before, gen}
        self._router = None
        self._stop = threading.Event()
        self._monitor = None
        reg = self._reg = _tm.get_registry()
        self._m_respawn = reg.counter(
            "fleet_respawn_total",
            "dead workers elastically replaced by the supervisor, "
            "labeled by worker and whether the replacement warm-started "
            "(warm=true: every grid entry from the manifest, no nvcc build)")
        self._m_probe = reg.counter(
            "fleet_probe_total",
            "supervisor liveness probes by result (ok/missed/dead)")
        self._m_backoff = reg.counter(
            "fleet_respawn_backoff_total",
            "respawns deferred by the crash-loop backoff (a worker that "
            "died within crashloop_window_s of becoming ready, or whose "
            "respawn itself failed, waits min(cap, base*2^level) before "
            "the next attempt), labeled by worker")

    # ---- spawning ----

    def _command(self, wid):
        """argv for one worker process. ``worker_command`` (tests, exotic
        deployments) overrides; it must print the same ready line."""
        if self._worker_command is not None:
            return list(self._worker_command(wid))
        cmd = [self._python, "-m", "deeplearning4j_tpu_torch.fleet.worker",
               "--worker-id", wid, "--port", "0", "--name", self.name,
               "--device", self.device,
               "--max-queue", str(self.max_queue),
               "--max-batch", str(self.max_batch),
               "--batch-window-ms", str(self.batch_window_ms)]
        if self.model_path:
            cmd += ["--model-path", self.model_path]
        else:
            cmd += ["--zoo", self.zoo]
        if self.buckets:
            cmd += ["--buckets",
                    ",".join(str(int(b)) for b in self.buckets)]
        if self.seq_buckets:
            cmd += ["--seq-buckets",
                    ",".join(str(int(b)) for b in self.seq_buckets)]
        if self.input_shape:
            cmd += ["--input-shape",
                    ",".join(str(int(d)) for d in self.input_shape)]
        if self.deadline_ms is not None:
            cmd += ["--deadline-ms", str(self.deadline_ms)]
        if self.warm_manifest:
            cmd += ["--warm-manifest", self.warm_manifest]
        if self.compile_cache:
            cmd += ["--compile-cache", self.compile_cache]
        return cmd

    def _spawn(self, wid, generation):
        env = self._env if self._env is not None else default_worker_env()
        proc = subprocess.Popen(self._command(wid), env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        w = _WorkerProc(wid, generation, proc)

        def read_out():
            for line in proc.stdout:
                line = line.rstrip("\n")
                w.out_ring.append(line)
                if not w.ready.is_set() and line.lstrip().startswith("{"):
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue
                    if doc.get("fleet_worker_ready"):
                        w.ready_doc = doc
                        w.port = int(doc["port"])
                        w.clock = doc.get("clock")
                        if w.clock:
                            # the stamp happened within the pipe latency
                            # of now: offset clamps to 0 on a shared
                            # clock (same host), keeps a real skew
                            from deeplearning4j_tpu_torch.telemetry import (
                                timeline as _timeline)
                            recv = time.time()
                            w.clock_offset_s, _ = \
                                _timeline.estimate_offset(
                                    w.clock.get("unix"), recv - 0.25,
                                    recv)
                        w.ready.set()
            proc.stdout.close()

        def read_err():
            for line in proc.stderr:
                w.err_ring.append(line.rstrip("\n"))
            proc.stderr.close()

        threading.Thread(target=read_out, daemon=True,
                         name=f"fleet-out-{wid}").start()
        threading.Thread(target=read_err, daemon=True,
                         name=f"fleet-err-{wid}").start()
        return w

    def _await_ready(self, w):
        """Block until the worker's ready line (bound port + warmup
        counters) or raise with its stderr tail."""
        deadline = time.monotonic() + self.spawn_timeout_s
        while not w.ready.wait(timeout=0.2):
            if w.proc.poll() is not None:
                tail = "\n".join(list(w.err_ring)[-10:]) or "<no stderr>"
                raise RuntimeError(
                    f"fleet worker {w.wid} (gen {w.generation}) exited "
                    f"rc={w.proc.returncode} before ready:\n{tail}")
            if time.monotonic() > deadline:
                w.proc.kill()
                raise RuntimeError(
                    f"fleet worker {w.wid} (gen {w.generation}) not "
                    f"ready after {self.spawn_timeout_s:.0f}s")
        w.ready_at = time.monotonic()  # crash-loop window anchor
        return w

    @staticmethod
    def replacement_is_warm(ready_doc):
        """Judge a worker's warm start from its ready line: every warmed
        grid entry came from the manifest (libraries installed, plans
        seeded), none missed, and the process ran no nvcc build."""
        doc = ready_doc or {}
        aot = doc.get("aot") or {}
        return bool(aot.get("warmed")) \
            and aot.get("manifest_hits") == aot.get("warmed") \
            and not aot.get("manifest_misses") \
            and not sum((doc.get("kernel_builds") or {}).values())

    def start(self):
        """Spawn all workers CONCURRENTLY (their warmups overlap), wait
        for every ready line, push endpoints to the attached router, and
        start the monitor loop."""
        with self._lock:
            spawned = {f"w{i}": self._spawn(f"w{i}", 0)
                       for i in range(self.n_workers)}
            self._workers = spawned
        try:
            for w in spawned.values():
                self._await_ready(w)
        except Exception:
            self.stop()
            raise
        self._push_endpoints()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fleet-supervisor",
                                         daemon=True)
        self._monitor.start()
        return self

    # ---- routing integration ----

    def attach(self, router):
        """Bind a :class:`FleetRouter`: it receives the live endpoint set
        now and after every respawn."""
        self._router = router
        if self.addresses():
            self._push_endpoints()
        return router

    def addresses(self):
        with self._lock:
            return [(w.wid, w.address) for w in self._workers.values()
                    if w.port is not None]

    def _push_endpoints(self):
        if self._router is not None:
            self._router.set_endpoints(self.addresses())

    # ---- monitoring / elastic replacement ----

    def _probe(self, w):
        """One liveness probe. True when the worker answered /health."""
        if w.address is None:
            return False
        try:
            # stamped synthetic: the worker counts this GET into its
            # origin=probe series, never the organic ones
            _code, doc = _http_json(w.address + "/health",
                                    timeout=self.probe_timeout_s,
                                    headers={_ORIGIN_HEADER: "probe"})
            w.last_health = doc
            return bool(doc.get("ok"))
        except Exception:  # noqa: BLE001 — probe failure IS the signal
            return False

    def _monitor_loop(self):
        while not self._stop.wait(timeout=self.probe_interval_s):
            with self._lock:
                workers = list(self._workers.values())
            for w in workers:
                if self._stop.is_set():
                    return
                exited = w.proc.poll() is not None
                if not exited and self._probe(w):
                    w.missed = 0
                    if self._reg.enabled:
                        self._m_probe.inc(result="ok")
                    if self._router is not None:
                        # a healthy probe REVIVES a worker the router
                        # wrote off on a transient stall — a
                        # false-positive mark_dead must not shrink the
                        # pool until the process actually dies
                        self._router.mark_alive(w.wid)
                    continue
                w.missed += 1
                if self._reg.enabled:
                    self._m_probe.inc(result="missed")
                if not exited and w.missed < self.max_missed_probes:
                    continue
                if self._in_backoff(w):
                    continue  # crash-loop: defer the respawn this tick
                self._replace(w, reason=("exited rc="
                                         f"{w.proc.returncode}" if exited
                                         else f"{w.missed} missed probes"))

    def _in_backoff(self, w):
        """Capped exponential backoff between respawns of a crash-looping
        worker, so a worker that dies the moment it comes up (bad model
        path after a botched hot-swap, OOM on load) cannot spin the
        supervisor — and the node — hot. A worker that lived at least
        ``crashloop_window_s`` after its ready line respawns immediately
        and resets the level; one that died inside the window (or whose
        respawn attempt itself failed: no ready line at all) waits
        ``min(cap, base * 2^level)`` first, each deferral scheduled once
        per death and counted ``fleet_respawn_backoff_total``."""
        now = time.monotonic()
        deferred = False
        with self._lock:  # status() snapshots this map concurrently
            bo = self._backoff.setdefault(w.wid,
                                          {"level": 0, "not_before": 0.0,
                                           "gen": None})
            if bo["gen"] != w.generation:  # first tick observing THIS death
                bo["gen"] = w.generation
                lived = None if w.ready_at is None else now - w.ready_at
                if lived is not None and lived >= self.crashloop_window_s:
                    bo["level"] = 0
                    bo["not_before"] = 0.0
                else:
                    bo["level"] = min(bo["level"] + 1, 16)
                    delay = min(self.respawn_backoff_base_s
                                * (2 ** (bo["level"] - 1)),
                                self.respawn_backoff_cap_s)
                    bo["not_before"] = now + delay
                    deferred = True
            backing_off = now < bo["not_before"]
        if deferred and self._reg.enabled:
            self._m_backoff.inc(worker=w.wid)
        return backing_off

    def _replace(self, dead, reason):
        """Elastic replacement: same spec (bundle + warm manifest), fresh
        process, counter-asserted warm start, endpoints re-pushed."""
        if self._reg.enabled:
            self._m_probe.inc(result="dead")
        if self._router is not None:
            # survivors take the traffic while the replacement warms
            self._router.mark_dead(dead.wid, error=reason)
        try:
            dead.proc.kill()
        except OSError:
            pass
        t0 = time.monotonic()
        event = {"worker_id": dead.wid, "generation": dead.generation + 1,
                 "reason": reason, "warm": None, "spawn_s": None}
        try:
            fresh = self._spawn(dead.wid, dead.generation + 1)
            with self._lock:
                self._workers[dead.wid] = fresh
            self._await_ready(fresh)
            event["spawn_s"] = round(time.monotonic() - t0, 3)
            event["warm"] = self.replacement_is_warm(fresh.ready_doc)
            event["aot"] = (fresh.ready_doc or {}).get("aot")
            event["kernel_builds"] = (fresh.ready_doc or {}).get("kernel_builds")
            self._push_endpoints()
        except Exception as e:  # noqa: BLE001 — keep supervising
            # the respawn itself failed: record it and let the next
            # monitor tick try again (the worker slot stays dead)
            event["error"] = str(e)[:300]
            with self._lock:
                # when _spawn itself raised (bad command, Popen failure),
                # the dead generation is still installed — _in_backoff's
                # per-death gen marker would never re-arm and the monitor
                # would retry every probe tick forever. Escalate the
                # backoff HERE for that case.
                spawn_failed = self._workers.get(dead.wid) is dead
                if spawn_failed:
                    bo = self._backoff.setdefault(
                        dead.wid, {"level": 0, "not_before": 0.0,
                                   "gen": None})
                    bo["gen"] = dead.generation
                    bo["level"] = min(bo["level"] + 1, 16)
                    bo["not_before"] = time.monotonic() + min(
                        self.respawn_backoff_base_s
                        * (2 ** (bo["level"] - 1)),
                        self.respawn_backoff_cap_s)
            if spawn_failed and self._reg.enabled:
                self._m_backoff.inc(worker=dead.wid)
        with self._lock:
            self._respawns.append(event)
        if self._reg.enabled:
            self._m_respawn.inc(worker=dead.wid,
                                warm=str(bool(event["warm"])).lower())

    # ---- operations ----

    def kill_worker(self, wid, sig=signal.SIGKILL):
        """Chaos hook: deliver ``sig`` to one worker process (tests and
        the bench's kill-a-worker leg). The monitor loop notices and
        replaces it like any other death."""
        with self._lock:
            w = self._workers[wid]
        os.kill(w.proc.pid, sig)
        return w.proc.pid

    def update_model(self, model_path, warm=None):
        """Hot-swap every worker from ``model_path``, warm-then-atomic
        per worker, sequentially (N-1 workers keep serving at full
        capacity during each warmup). Returns {wid: swap response}."""
        out = {}
        for wid, addr in self.addresses():
            try:
                _code, doc = _http_json(
                    addr + "/swap",
                    {"model_path": model_path, "warm": warm},
                    timeout=max(self.spawn_timeout_s, 30.0))
                out[wid] = doc
            except Exception as e:  # noqa: BLE001 — per-worker verdict
                out[wid] = {"ok": False, "error": str(e)[:300]}
        return out

    def status(self):
        """The supervisor's /fleet payload: worker table (with each
        worker's CACHED last /health probe — cross-worker aggregation
        without re-probing) + the respawn ledger."""
        with self._lock:
            workers = [w.snapshot() for w in self._workers.values()]
        return {"n_workers": self.n_workers, "workers": workers,
                "respawns": list(self._respawns),
                "probe_interval_s": self.probe_interval_s,
                "max_missed_probes": self.max_missed_probes,
                "backoff": {wid: dict(bo)
                            for wid, bo in self._backoff.items()}}

    def stop(self):
        """Graceful stop: /shutdown every worker, then make sure the
        processes are gone (terminate -> kill)."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.proc.poll() is not None:
                continue
            if w.address is not None:
                try:
                    _http_json(w.address + "/shutdown", {}, timeout=2.0)
                except Exception:  # noqa: BLE001 — force-kill below
                    pass
        for w in workers:
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait(timeout=5)
