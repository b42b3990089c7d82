"""Cross-host round-boundary exchange for the elastic training fleet.

The port of ``deeplearning4j_tpu/hostfleet/exchange.py``, a copy: the
module is numpy and the standard library only, and its mean equals the
JAX package's bit for bit. Two transports compose the multi-host tier
(hostfleet/worker.py picks one per job):

* **gspmd**: every process joins one ``torch.distributed`` group and the
  ``ParallelTrainer``'s collectives span all hosts inside the step. No
  code in this module runs; the "exchange" is the step itself. Processes
  that share one card join over gloo (NCCL refuses two ranks on one GPU).
* **hostavg**: the host-mediated path (reference analog:
  ``ParameterAveragingTrainingMaster``'s driver-side average, SURVEY
  §2.5): each host runs ``dispatches_per_round`` local sharded steps,
  then params + updater state are averaged across hosts at the ROUND
  boundary.

The server lives IN THE SUPERVISOR process (the Spark-driver analog) and
touches no device: workers send a flat leaf list (host numpy arrays), the
server sums float leaves in **process-id order** (one fixed reduction
order: bit-identical replies on every run, the property the digest-parity
gate leans on), divides by the world size, and replies the same averaged
list to every contributor. Non-float leaves take process 0's value. A
round that never completes (a contributor died) is bounded: waiters get
an ``exchange_timeout`` error reply instead of wedging, and the client's
``poll`` deadline bounds a dead SERVER the same way.
"""

from __future__ import annotations

import threading
from multiprocessing.connection import Client, Listener

import numpy as np

__all__ = ["ExchangeClient", "ExchangeError", "ExchangeServer"]

_AUTHKEY = b"dl4j-tpu-hostfleet"


class ExchangeError(RuntimeError):
    """The round exchange failed (peer death, timeout, server gone) —
    the worker exits with a distinct rc instead of wedging."""


def _mean_in_pid_order(contribs, world):
    """Leaf-wise mean over ``{pid: leaves}``: float leaves summed in
    ascending-pid order (ONE reduction order — deterministic bits),
    non-float leaves taken from the lowest pid."""
    pids = sorted(contribs)
    first = contribs[pids[0]]
    out = []
    for i, leaf in enumerate(first):
        a = np.asarray(leaf)
        if not np.issubdtype(a.dtype, np.floating):
            out.append(a)
            continue
        acc = a.copy()
        for pid in pids[1:]:
            acc += np.asarray(contribs[pid][i])
        out.append(acc / a.dtype.type(world))
    return out


class _Round:
    """Rendezvous state for one (generation, round) barrier."""

    def __init__(self):
        self.contribs = {}
        self.reply = None
        self.failed = None
        self.done = threading.Event()


class ExchangeServer:
    """Supervisor-side averaging rendezvous for one generation.

    ``world`` contributors per round; every contributor blocks until all
    arrived (or ``round_timeout_s`` passed), then receives the averaged
    leaves. Doubles as the supervisor's progress probe: ``last_round``
    and ``last_progress_s`` advance with every completed exchange."""

    def __init__(self, world, *, round_timeout_s=120.0, host="127.0.0.1"):
        self.world = int(world)
        self.round_timeout_s = float(round_timeout_s)
        self._listener = Listener((host, 0), authkey=_AUTHKEY)
        self.address = self._listener.address
        self._lock = threading.Lock()
        self._rounds = {}
        self._closed = threading.Event()
        self.last_round = -1
        self.rounds_completed = 0
        import time
        self._clock = time.monotonic
        self.last_progress = self._clock()
        threading.Thread(target=self._accept_loop,
                         name="hostfleet-exchange-accept",
                         daemon=True).start()

    @property
    def port(self):
        return self.address[1]

    def last_progress_s(self):
        """Seconds since the last completed exchange (or server start)."""
        return self._clock() - self.last_progress

    # ---- server internals ----

    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                conn = self._listener.accept()
            except OSError:
                return  # listener closed
            except Exception:  # noqa: BLE001 — auth failure etc.; keep serving
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="hostfleet-exchange-conn",
                             daemon=True).start()

    def _serve_conn(self, conn):
        try:
            while not self._closed.is_set():
                if not conn.poll(0.2):
                    continue
                msg = conn.recv()
                conn.send(self._contribute(msg["round"], msg["process"],
                                           msg["leaves"]))
        except (EOFError, OSError):
            pass  # worker went away (death or clean exit)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _contribute(self, rnd, pid, leaves):
        with self._lock:
            state = self._rounds.setdefault(rnd, _Round())
            state.contribs[pid] = leaves
            if len(state.contribs) == self.world:
                state.reply = _mean_in_pid_order(state.contribs, self.world)
                self.last_round = max(self.last_round, rnd)
                self.rounds_completed += 1
                self.last_progress = self._clock()
                state.done.set()
                # prune long-finished rounds: a contributor reaching round
                # r cannot still be waiting on r-4 (each worker exchanges
                # strictly in round order), so their payloads can go
                for old in [k for k in self._rounds if k < rnd - 4]:
                    del self._rounds[old]
        if not state.done.wait(timeout=self.round_timeout_s):
            with self._lock:
                if not state.done.is_set():
                    state.failed = (
                        f"exchange round {rnd} incomplete after "
                        f"{self.round_timeout_s:.0f}s: have "
                        f"{sorted(state.contribs)} of {self.world} "
                        "contributors (a host died mid-round)")
                    state.done.set()
        if state.failed is not None:
            return {"error": state.failed}
        return {"leaves": state.reply}

    def close(self):
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # wake any round still waiting on a dead contributor so its conn
        # threads send the error reply and exit instead of outliving us
        with self._lock:
            for state in self._rounds.values():
                if not state.done.is_set():
                    state.failed = "exchange server closed (generation torn down)"
                    state.done.set()


class ExchangeClient:
    """Worker-side handle: one connection, one ``allreduce_mean`` per
    round. Every call is deadline-bounded — a dead server or a wedged
    round surfaces as :class:`ExchangeError`, never a hang."""

    def __init__(self, port, process_id, *, host="127.0.0.1",
                 timeout_s=120.0):
        self.process_id = int(process_id)
        self.timeout_s = float(timeout_s)
        try:
            self._conn = Client((host, int(port)), authkey=_AUTHKEY)
        except OSError as e:
            raise ExchangeError(f"cannot reach exchange server on port "
                                f"{port}: {e}") from e

    def allreduce_mean(self, rnd, leaves):
        """Average ``leaves`` (flat list of host arrays) with every other
        host for round ``rnd``; returns the averaged list."""
        try:
            self._conn.send({"round": int(rnd), "process": self.process_id,
                             "leaves": leaves})
            # poll deadline covers the whole barrier: slowest host's round
            # + the server's own timeout
            if not self._conn.poll(self.timeout_s + 5.0):
                raise ExchangeError(
                    f"no exchange reply for round {rnd} within "
                    f"{self.timeout_s + 5.0:.0f}s")
            reply = self._conn.recv()
        except (EOFError, OSError) as e:
            raise ExchangeError(
                f"exchange connection lost in round {rnd}: {e}") from e
        if "error" in reply:
            raise ExchangeError(reply["error"])
        return reply["leaves"]

    def close(self):
        try:
            self._conn.close()
        except OSError:
            pass
