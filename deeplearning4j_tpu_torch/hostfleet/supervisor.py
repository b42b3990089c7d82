"""TrainingFleetSupervisor: spawn N training hosts, watch the round
clock, and turn a dead host into a rollback + reshard instead of a job
restart.

The port of ``deeplearning4j_tpu/hostfleet/supervisor.py``. The serving
fleet's supervisor (fleet/supervisor.py) replaces ONE dead worker because
serving workers are independent; training hosts are NOT: they meet in a
collective every round, so one SIGKILLed host wedges the survivors
mid-exchange. The recovery unit is therefore the GENERATION:

1. **detect**: a process exit (poll) is the fast path; the round
   WATCHDOG (no worker heartbeat/round/exchange progress for
   ``round_timeout_s``) is the backstop that bounds a wedge the
   supervisor cannot see a corpse for. Never wall-time-gated: the
   deadline only bounds, it never asserts speed.
2. **tear down**: every process of the generation is SIGKILLed (the
   survivors are wedged in a dead collective; there is nothing to drain;
   a SIGSTOPped host still holds its CUDA context until then) and the
   generation's exchange server closes.
3. **re-form**: a new generation spawns at the new world size (N-1, or
   N again under ``respawn=True``) with a fresh ``torch.distributed``
   rendezvous, every process restoring the last good layout-free bundle
   RESHARDED into the new topology (``ParallelTrainer.adopt_net_state``
   re-derives the zero1/fsdp layouts for the new mesh), and training
   resumes from the round boundary the bundle pinned.

Every transition is counted: ``hostfleet_generations_total{reason=
host_death|respawn|clean}``, ``hostfleet_rollback_rounds_total`` (rounds
trained then re-run: the price of the fault, never silent), and the
``distributed_hosts_alive`` gauge rides ``/health``. Published snapshots
optionally fan to serving via ``serve_update`` (``registry_updater`` /
``fleet_updater``: the continuous tier's hook, unchanged).

The supervisor touches no device: it passes ``device`` (default
``cuda``, checked here so a job without a card fails at once) to every
host. The JAX package's ``local_devices > 1`` (virtual CPU devices a
host, through ``XLA_FLAGS``) has no counterpart in PyTorch and is
refused.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.fleet.supervisor import default_worker_env
from deeplearning4j_tpu_torch.hostfleet.exchange import ExchangeServer
from deeplearning4j_tpu_torch.telemetry import federate as _federate
from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx

__all__ = ["TrainingFleetSupervisor"]


def _reserve_port():
    """A bound socket on a free port, for a generation's rendezvous. It
    stays bound (``SO_REUSEADDR``, never listening) while the generation
    lives, so no other bind to port 0 and no outgoing connection on this
    host takes the port before host 0's store listens on it (the store
    sets ``SO_REUSEADDR`` too)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s


class _HostProc:
    """One training host: process handle + the line-protocol state the
    monitor reads. stdout/stderr are drained by daemon reader threads
    into bounded rings (a full pipe would wedge the worker)."""

    def __init__(self, idx, generation, proc):
        self.idx = idx
        self.generation = generation
        self.proc = proc
        self.ready = threading.Event()
        self.ready_doc = None
        self.done_doc = None
        self.error_doc = None
        self.rc0_seen_at = None  # clean exit observed, done line pending
        self.last_round = -1
        self.out_ring = deque(maxlen=80)
        self.err_ring = deque(maxlen=80)
        # cluster-observability state: the ready line's clock pair seeds
        # this host's clock-offset estimate; hostfleet.round trace docs
        # ride the round lines into this ring (the postmortem source)
        self.clock = None
        self.clock_offset_s = 0.0
        self.round_traces = deque(maxlen=16)

    def snapshot(self):
        return {"host": self.idx, "generation": self.generation,
                "pid": self.proc.pid, "alive": self.proc.poll() is None,
                "ready": self.ready.is_set(), "last_round": self.last_round,
                "done": self.done_doc is not None,
                "error": self.error_doc,
                "clock_offset_s": self.clock_offset_s}

    def timeline_source(self):
        """This host's traces as a cluster-timeline source (None while
        it has produced no round traces)."""
        if not self.round_traces:
            return None
        return _timeline.source(
            f"gen{self.generation}:host{self.idx}",
            {"hostfleet.round": list(self.round_traces)},
            clock_offset_s=self.clock_offset_s,
            meta={"host": self.idx, "generation": self.generation,
                  "pid": self.proc.pid})


class _Generation:
    def __init__(self, gen_id, world, procs, exchange, hb_dir, coord_sock=None):
        self.gen_id = gen_id
        self.world = world
        self.procs = procs
        self.exchange = exchange
        self.hb_dir = hb_dir
        self.coord_sock = coord_sock
        self.started_at = time.monotonic()
        self.last_progress = time.monotonic()

    def note_progress(self):
        self.last_progress = time.monotonic()

    def progress_age_s(self):
        last = self.last_progress
        if self.exchange is not None:
            last = max(last, self.exchange.last_progress)
        return time.monotonic() - last

    def max_round(self):
        return max((p.last_round for p in self.procs), default=-1)


class TrainingFleetSupervisor:
    """Run one elastic multi-host training job to ``total_rounds``."""

    def __init__(self, n_hosts, *, workdir, total_rounds,
                 dispatches_per_round=1, gen_seed=123, batch=8, features=12,
                 hidden=16, classes=3, seed=0, shard_params="zero1",
                 local_devices=1, respawn=False, exchange="auto",
                 round_timeout_s=90.0, spawn_timeout_s=180.0,
                 poll_interval_s=0.2, max_generations=6, round_sleep_s=0.0,
                 serve_registry=False, serve_update=None, init_timeout_s=20,
                 init_retries=2, env=None, python=None, device="cuda"):
        if int(local_devices) != 1:
            raise ValueError(
                f"local_devices={local_devices}: a host of the port trains on one "
                "device (its card, or the CPU); virtual devices per host have no "
                "PyTorch counterpart. Run more hosts instead.")
        from deeplearning4j_tpu_torch.utils.device import resolve_device
        self.device = str(resolve_device(device))
        self.n_hosts = int(n_hosts)
        self.workdir = str(workdir)
        self.bundle = os.path.join(self.workdir, "bundle.zip")
        self.total_rounds = int(total_rounds)
        self.dispatches_per_round = int(dispatches_per_round)
        self.gen_seed = int(gen_seed)
        self.batch = int(batch)
        self.features, self.hidden, self.classes = features, hidden, classes
        self.seed = int(seed)
        self.shard_params = shard_params
        self.local_devices = int(local_devices)
        self.respawn = bool(respawn)
        self.exchange = exchange
        self.round_timeout_s = float(round_timeout_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.max_generations = int(max_generations)
        self.round_sleep_s = float(round_sleep_s)
        self.serve_registry = bool(serve_registry)
        self.serve_update = serve_update
        self.init_timeout_s = int(init_timeout_s)
        self.init_retries = int(init_retries)
        self._env = env
        self._python = python or sys.executable
        self._lock = threading.Lock()
        self._gen = None
        self._gen_count = 0
        self.generations = []     # ledger: one dict per ENDED generation
        self.chaos_kills = []     # kill_host() bookkeeping
        self.tally = {"host_death": 0, "respawn": 0, "clean": 0,
                      "rollback_rounds": 0, "serve_updates_ok": 0,
                      "serve_updates_error": 0}
        self._last_snapshot_round = -1
        self._result = None
        self._failure = None
        self._done = threading.Event()
        self._stop = threading.Event()
        self._monitor = None
        reg = self._reg = _tm.get_registry()
        self._m_gens = reg.counter(
            "hostfleet_generations_total",
            "training-fleet generation transitions, by reason (host_death "
            "= torn down after a death/stall and re-formed one host "
            "smaller, respawn = re-formed at full size, clean = ran to "
            "completion)")
        self._m_rollback = reg.counter(
            "hostfleet_rollback_rounds_total",
            "rounds trained then re-run because a host death rolled the "
            "fleet back to the last good bundle (the counted price of "
            "each fault, never silent)")
        self._m_serve = reg.counter(
            "hostfleet_serve_updates_total",
            "snapshot -> serving handoffs fanned by the training "
            "supervisor, by outcome")
        self._g_alive = reg.gauge(
            "distributed_hosts_alive",
            "training hosts the supervisor currently believes alive "
            "(rides /health)")
        if reg.enabled:
            # pre-register the handoff outcome series at zero: an error
            # series born at the first failed handoff is invisible to
            # the SLO delta discipline for a window (the prober idiom)
            for outcome in ("ok", "error"):
                self._m_serve.inc(0, outcome=outcome)

    # ---- spawning ----

    def _worker_argv(self, idx, world, gen_id, coord_port, ex_port, resume,
                     hb_dir):
        argv = [self._python, "-m", "deeplearning4j_tpu_torch.hostfleet.worker",
                "--process-id", str(idx), "--num-processes", str(world),
                "--generation", str(gen_id),
                "--bundle", self.bundle,
                "--total-rounds", str(self.total_rounds),
                "--dispatches-per-round", str(self.dispatches_per_round),
                "--gen-seed", str(self.gen_seed),
                "--batch", str(self.batch),
                "--features", str(self.features),
                "--hidden", str(self.hidden),
                "--classes", str(self.classes),
                "--seed", str(self.seed),
                "--shard-params", self.shard_params,
                "--heartbeat-dir", hb_dir,
                "--exchange", self.exchange,
                "--round-timeout-s", str(self.round_timeout_s),
                "--init-timeout-s", str(self.init_timeout_s),
                "--init-retries", str(self.init_retries),
                "--device", self.device]
        if coord_port is not None:
            argv += ["--coordinator", f"127.0.0.1:{coord_port}"]
        if ex_port is not None:
            argv += ["--exchange-port", str(ex_port)]
        if resume:
            argv += ["--resume"]
        if self.round_sleep_s:
            argv += ["--round-sleep-s", str(self.round_sleep_s)]
        if self.serve_registry and idx == 0:
            argv += ["--serve-registry"]
        return argv

    def _worker_env(self):
        return dict(self._env) if self._env is not None else default_worker_env()

    def _spawn_generation(self, world, resume):
        with self._lock:
            gen_id = self._gen_count
            self._gen_count += 1
        hb_dir = os.path.join(self.workdir, f"gen{gen_id}_hb")
        os.makedirs(hb_dir, exist_ok=True)
        exchange = None
        if world > 1 and self.exchange != "gspmd":
            exchange = ExchangeServer(world,
                                      round_timeout_s=self.round_timeout_s)
        coord_sock = _reserve_port() if world > 1 else None
        coord_port = coord_sock.getsockname()[1] if coord_sock is not None else None
        env = self._worker_env()
        procs = []
        for i in range(world):
            argv = self._worker_argv(
                i, world, gen_id, coord_port,
                exchange.port if exchange is not None else None,
                resume, hb_dir)
            proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            procs.append(_HostProc(i, gen_id, proc))
        gen = _Generation(gen_id, world, procs, exchange, hb_dir, coord_sock)
        for p in procs:
            threading.Thread(target=self._read_out, args=(gen, p),
                             daemon=True,
                             name=f"hostfleet-out-g{gen_id}h{p.idx}").start()
            threading.Thread(target=self._read_err, args=(p,), daemon=True,
                             name=f"hostfleet-err-g{gen_id}h{p.idx}").start()
        if self._reg.enabled:
            self._g_alive.set(world)
        return gen

    # ---- stdout line protocol ----

    def _read_out(self, gen, p):
        for line in p.proc.stdout:
            line = line.rstrip("\n")
            p.out_ring.append(line)
            gen.note_progress()
            if not line.lstrip().startswith("{"):
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if doc.get("hostfleet_ready"):
                p.ready_doc = doc
                clk = doc.get("clock")
                if isinstance(clk, dict) and clk.get("unix") is not None:
                    # the pair was stamped within pipe latency of this
                    # read — bound the sample by a pessimistic window;
                    # same-host clocks clamp to offset 0 inside it
                    recv = time.time()
                    p.clock = clk
                    p.clock_offset_s, _ = _timeline.estimate_offset(
                        clk["unix"], recv - 0.25, recv)
                p.ready.set()
            elif "round" in doc and "snapshot" not in doc:
                p.last_round = max(p.last_round, int(doc["round"]))
                tr = doc.get("trace")
                if isinstance(tr, dict):
                    # the round's hostfleet.round trace rides the line:
                    # keep it for the postmortem timeline and offer it to
                    # the local ring so /traces (and the merged cluster
                    # view) shows which host stalled a generation
                    p.round_traces.append(tr)
                    if self._reg.enabled:
                        _tracectx.get_ring().offer(tr)
            elif "snapshot" in doc:
                with self._lock:
                    self._last_snapshot_round = max(
                        self._last_snapshot_round, int(doc["round"]))
                self._fan_serve_update(doc["snapshot"])
            elif doc.get("hostfleet_done"):
                p.done_doc = doc
            elif doc.get("hostfleet_error"):
                p.error_doc = doc
        p.proc.stdout.close()

    def _read_err(self, p):
        for line in p.proc.stderr:
            p.err_ring.append(line.rstrip("\n"))
        p.proc.stderr.close()

    def _fan_serve_update(self, path):
        """Hand a published snapshot to serving (registry_updater /
        fleet_updater — ContinuousTrainer's hook contract). A handoff
        error is counted, never fatal to training."""
        if self.serve_update is None:
            return
        try:
            self.serve_update(path)
            with self._lock:
                self.tally["serve_updates_ok"] += 1
            if self._reg.enabled:
                self._m_serve.inc(outcome="ok")
        except Exception:  # noqa: BLE001 — serving lag must not kill training
            with self._lock:
                self.tally["serve_updates_error"] += 1
            if self._reg.enabled:
                self._m_serve.inc(outcome="error")

    # ---- lifecycle ----

    def start(self):
        os.makedirs(self.workdir, exist_ok=True)
        # plug this job into the cluster observability plane: member
        # counters federate into /metrics?federate=1, member round
        # traces into /traces?cluster=1 (bound methods compare equal,
        # so re-registration stays idempotent)
        _federate.register_target_provider(self.federate_targets)
        _timeline.register_source_provider(self.timeline_sources)
        gen = self._spawn_generation(self.n_hosts,
                                     resume=os.path.exists(self.bundle))
        with self._lock:
            self._gen = gen
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="hostfleet-supervisor",
                                         daemon=True)
        self._monitor.start()
        return self

    def federate_targets(self):
        """Hostfleet members run no HTTP server — their counters arrive
        on done lines in the ``series_map`` wire form; re-shape those
        into registry snapshots for the federated scrape (a host that
        has not finished yet simply contributes no target)."""
        with self._lock:
            gen = self._gen
        targets = []
        for p in (gen.procs if gen is not None else []):
            counters = (p.done_doc or {}).get("counters")
            if counters:
                targets.append(
                    (f"gen{p.generation}:host{p.idx}",
                     _federate.snapshot_from_series_maps(counters)))
        return targets

    def timeline_sources(self):
        """Cluster-timeline sources for the live generation's hosts."""
        with self._lock:
            gen = self._gen
        return [s for s in (p.timeline_source()
                            for p in (gen.procs if gen is not None else []))
                if s is not None]

    def _monitor_loop(self):
        while not self._stop.wait(timeout=self.poll_interval_s):
            with self._lock:
                gen = self._gen
            if gen is None:
                return
            procs = gen.procs
            rcs = [p.proc.poll() for p in procs]
            if all(rc == 0 and p.done_doc is not None
                   for rc, p in zip(rcs, procs)):
                self._finish_clean(gen)
                return
            # a clean exit races its own final stdout flush: give the
            # reader a short grace window before calling a done-line-less
            # rc=0 a death
            now = time.monotonic()
            dead = []
            for p, rc in zip(procs, rcs):
                if rc is None or (rc == 0 and p.done_doc is not None):
                    continue
                if rc == 0:
                    if p.rc0_seen_at is None:
                        p.rc0_seen_at = now
                    if now - p.rc0_seen_at < 3.0:
                        continue
                dead.append((p, rc))
            if dead:
                p, rc = dead[0]
                detail = (p.error_doc or {}).get("hostfleet_error") \
                    or f"host {p.idx} exited rc={rc}"
                if not self._handle_death(gen,
                                          detail=f"host_exit: {detail}"):
                    return
                continue
            # the round WATCHDOG: a wedged collective shows as zero
            # progress (no lines, no heartbeats, no completed exchange)
            # past the deadline — bound it, tear down, re-form
            budget = (self.round_timeout_s
                      if any(p.ready.is_set() for p in procs)
                      else max(self.round_timeout_s, self.spawn_timeout_s))
            if gen.progress_age_s() > budget and not self._hb_fresh(gen,
                                                                    budget):
                if not self._handle_death(
                        gen, detail=(f"watchdog_stall: no round progress "
                                     f"for {budget:.0f}s")):
                    return

    def _hb_fresh(self, gen, budget):
        """Heartbeat files are the line protocol's disk twin — a worker
        whose stdout pipe stalled still proves liveness by rewriting its
        heartbeat each round."""
        try:
            newest = max((os.path.getmtime(os.path.join(gen.hb_dir, f))
                          for f in os.listdir(gen.hb_dir)), default=0.0)
        except OSError:
            return False
        return newest > 0 and (time.time() - newest) <= budget

    def _teardown(self, gen):
        for p in gen.procs:
            if p.proc.poll() is None:
                try:
                    p.proc.kill()  # survivors are wedged in a dead
                    #                collective; nothing to drain
                except OSError:
                    pass
        for p in gen.procs:
            try:
                p.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        if gen.exchange is not None:
            gen.exchange.close()
        if gen.coord_sock is not None:
            gen.coord_sock.close()

    def _handle_death(self, gen, detail):
        """Tear the generation down, account the rollback, re-form at the
        new world size. Returns False when the job is declared failed
        (no hosts left / generation budget exhausted) — the monitor
        exits; every path sets a counted outcome, never a hang."""
        alive = sum(1 for p in gen.procs if p.proc.poll() is None)
        if self._reg.enabled:
            self._g_alive.set(alive)
        self._teardown(gen)
        postmortem = self._dump_postmortem(gen, detail)
        with self._lock:
            snapshot_round = self._last_snapshot_round
        resumable = os.path.exists(self.bundle)
        # rounds that had started beyond the bundle re-run after restore:
        # any completed-but-unsnapshotted ones plus the round in flight
        # (a generation that never even became ready lost nothing)
        lost = max(0, gen.max_round() - snapshot_round)
        if any(p.ready.is_set() for p in gen.procs):
            lost += 1  # the round in flight when the host died
        reason = "respawn" if self.respawn else "host_death"
        entry = {"generation": gen.gen_id, "world": gen.world,
                 "reason": reason, "detail": detail,
                 "rounds_completed": gen.max_round() + 1,
                 "resumed_from_round": snapshot_round + 1,
                 "rollback_rounds": lost, "resumable": resumable,
                 "postmortem": postmortem}
        if resumable:
            # preserve the exact restore artifact for reference legs /
            # postmortems (the live bundle keeps moving after resume)
            keep = os.path.join(self.workdir,
                                f"rollback_gen{gen.gen_id}.zip")
            shutil.copyfile(self.bundle, keep)
            entry["rollback_bundle"] = keep
        with self._lock:
            self.generations.append(entry)
            self.tally[reason] += 1
            self.tally["rollback_rounds"] += lost
        if self._reg.enabled:
            self._m_gens.inc(reason=reason)
            if lost:
                self._m_rollback.inc(lost)
        next_world = self.n_hosts if self.respawn else gen.world - 1
        if next_world < 1:
            return self._fail(f"no hosts left after {detail}")
        if self._gen_count >= self.max_generations:
            return self._fail(
                f"generation budget ({self.max_generations}) exhausted; "
                f"last death: {detail}")
        fresh = self._spawn_generation(next_world, resume=resumable)
        with self._lock:
            self._gen = fresh
        return True

    def _dump_postmortem(self, gen, detail):
        """Write each host's round traces + clock offset to
        ``<workdir>/postmortem_gen<N>/host<i>.json`` — the directory
        ``traces --cluster`` merges to identify the dead host's last
        round after the generation's processes are gone. Best-effort:
        a failed write never blocks the re-form."""
        pm_dir = os.path.join(self.workdir, f"postmortem_gen{gen.gen_id}")
        wrote = False
        for p in gen.procs:
            if not p.round_traces:
                continue
            doc = {"reason": detail, "host": p.idx,
                   "generation": gen.gen_id, "pid": p.proc.pid,
                   "instance": f"gen{gen.gen_id}:host{p.idx}",
                   "clock": p.clock, "clock_offset_s": p.clock_offset_s,
                   "dumped_at": time.time(),
                   "traces": {"hostfleet.round": list(p.round_traces)}}
            try:
                os.makedirs(pm_dir, exist_ok=True)
                with open(os.path.join(pm_dir, f"host{p.idx}.json"),
                          "w") as f:
                    json.dump(doc, f)
                wrote = True
            except OSError:
                continue
        return pm_dir if wrote else None

    def _fail(self, msg):
        with self._lock:
            self._gen = None
        self._failure = msg
        if self._reg.enabled:
            self._g_alive.set(0)
        self._done.set()
        return False

    def _finish_clean(self, gen):
        with self._lock:
            self.tally["clean"] += 1
        if self._reg.enabled:
            self._m_gens.inc(reason="clean")
        dones = sorted((p.done_doc for p in gen.procs),
                       key=lambda d: d["process"])
        self._result = {
            "digests": [d["digest"] for d in dones],
            "iterations": [d["iteration"] for d in dones],
            "final_world": gen.world,
            "final_generation": gen.gen_id,
            "mode": dones[0].get("mode"),
            "layout": (gen.procs[0].ready_doc or {}).get("layout"),
            "serving_probe_diff": dones[0].get("serving_probe_diff"),
            "step_recompiles": [d.get("step_recompiles") for d in dones],
            "worker_counters": {d["process"]: d.get("counters")
                                for d in dones},
            "worker_goodput": {d["process"]: d.get("goodput")
                               for d in dones},
            "generations": list(self.generations),
            "tally": dict(self.tally),
            "chaos_kills": list(self.chaos_kills),
            "bundle": self.bundle,
        }
        if gen.coord_sock is not None:
            gen.coord_sock.close()
        with self._lock:
            self._gen = None
        self._done.set()

    # ---- operations ----

    def kill_host(self, idx, sig=signal.SIGKILL):
        """Chaos hook: deliver ``sig`` to one training host of the
        current generation (the bench's kill-a-host leg). The watchdog /
        exit path notices and re-forms like any other death."""
        with self._lock:
            gen = self._gen
        if gen is None:
            raise RuntimeError("no live generation to kill in")
        p = gen.procs[idx]
        os.kill(p.proc.pid, sig)
        with self._lock:
            self.chaos_kills.append({"generation": gen.gen_id, "host": idx,
                                     "pid": p.proc.pid, "signal": int(sig),
                                     "after_round": p.last_round})
        return p.proc.pid

    def wait_for_round(self, rnd, timeout=120.0, host=None):
        """Block until a host of the CURRENT generation reports round
        ``rnd`` complete (``host=None``: any host)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._done.is_set():
                raise RuntimeError(
                    f"job ended while waiting for round {rnd}: "
                    f"{self._failure or 'completed'}")
            with self._lock:
                gen = self._gen
            if gen is not None:
                got = (gen.max_round() if host is None
                       else gen.procs[host].last_round
                       if host < len(gen.procs) else -1)
                if got >= rnd:
                    return got
            time.sleep(0.05)
        raise TimeoutError(f"round {rnd} not reached in {timeout:.0f}s")

    def wait(self, timeout=600.0):
        """Block until the job completes (returns the result dict) or
        fails (raises with the counted reason)."""
        if not self._done.wait(timeout=timeout):
            self.stop()
            raise TimeoutError(f"hostfleet job not done in {timeout:.0f}s")
        if self._failure is not None:
            raise RuntimeError(f"hostfleet job failed: {self._failure}")
        return self._result

    def status(self):
        with self._lock:
            gen = self._gen
        return {"n_hosts": self.n_hosts,
                "generation": None if gen is None else gen.gen_id,
                "world": None if gen is None else gen.world,
                "hosts": [] if gen is None
                else [p.snapshot() for p in gen.procs],
                "last_snapshot_round": self._last_snapshot_round,
                "generations": list(self.generations),
                "tally": dict(self.tally),
                "done": self._done.is_set(), "failure": self._failure}

    def stop(self):
        self._stop.set()
        _federate.unregister_target_provider(self.federate_targets)
        _timeline.unregister_source_provider(self.timeline_sources)
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        with self._lock:
            gen = self._gen
            self._gen = None
        if gen is not None:
            self._teardown(gen)
        if self._reg.enabled:
            self._g_alive.set(0)
