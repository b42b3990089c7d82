"""Fleet admission/routing front: one door in front of N worker processes.

The port of ``deeplearning4j_tpu/fleet/router.py`` (host code: the same
admission, batching, retry and trace semantics; the JAX tree helpers give
way to ``utils/trees.py``). The router owns the fleet's admission
contract (the serving engine's shed semantics, one level up): a bounded
queue of pending EXAMPLES sheds at submit when full (``ServingOverloaded``,
``serving_shed_total{reason=queue_full}``),
requests stale past their deadline are shed before wasting a dispatch,
and every terminal outcome is COUNTED — a request is answered, retried
onto a live worker, or counted-shed; never silently dropped.

Dispatch is load-aware continuous batching at fleet level: dispatcher
threads drain whatever is queued (one shared straggler window, like the
engine's drain), pick the live worker with the LEAST outstanding rows
whose bounded in-flight window has room, and ship the whole batch as ONE
``/submit`` round trip. A connection failure marks the worker dead
(``fleet_failover_total``) and the batch retries onto the next-best live
worker (``fleet_retry_total``) — inference is stateless, so the replay is
idempotent by construction. A worker-side 429 ``queue_full`` also
retries (another worker may have room); a worker-side ``deadline`` shed
is terminal (the request is stale everywhere).

Liveness: the router marks workers dead on dispatch failures and
:meth:`FleetRouter.health` aggregates every worker's ``/health``
(``fleet.fleet_status(probe=True)`` serves it). The supervisor pushes topology changes — respawned workers
arrive via :meth:`set_endpoints` with fresh addresses under stable
worker ids, so per-worker metric labels stay bounded across respawns.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.fleet.worker import (ORIGIN_HEADER,
                                                   PARENT_SPAN_HEADER,
                                                   TRACE_ID_HEADER)
from deeplearning4j_tpu_torch.serving.engine import (InferenceFuture, ServingShutdown,
                                                     _as_input, _origin_labels, _overloaded)
from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx


class _Worker:
    """Router-side state for one worker endpoint. ``outstanding`` (rows
    in flight to it) is the load signal; mutated only under the router
    lock."""

    __slots__ = ("wid", "address", "alive", "outstanding", "dispatched",
                 "failures", "last_error")

    def __init__(self, wid, address):
        self.wid = wid
        self.address = address
        self.alive = True
        self.outstanding = 0
        self.dispatched = 0
        self.failures = 0
        self.last_error = None

    def snapshot(self):
        return {"worker_id": self.wid, "address": self.address,
                "alive": self.alive, "outstanding_rows": self.outstanding,
                "dispatched": self.dispatched, "failures": self.failures,
                "last_error": self.last_error}


def _http_json(url, payload=None, timeout=10.0, headers=None):
    """One JSON round trip. Returns (status_code, doc); raises OSError
    family (URLError / ConnectionError / timeout) when the worker is
    unreachable — the caller's failover signal. ``headers``: extra
    request headers (the trace-propagation pair rides here)."""
    if payload is None:
        req = urllib.request.Request(url, headers=dict(headers or {}))
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        # the worker is ALIVE and answered (shed/error codes carry JSON)
        try:
            doc = json.loads(e.read().decode())
        except Exception:
            doc = {"error": str(e)}
        return e.code, doc


class FleetRouter:
    """Single admission/routing front over a pool of fleet workers.

    ``submit()`` mirrors :meth:`ServingEngine.submit` (same future type,
    same shed exceptions, same batched-rows contract) so a client moves
    from one engine to a fleet without changing shape.
    """

    def __init__(self, endpoints=(), *, name="fleet", max_queue=256,
                 max_inflight_rows=64, max_dispatch_rows=32,
                 default_deadline_s=None, batch_window_s=0.0,
                 concurrency=4, retries=2, request_timeout_s=30.0,
                 probe_timeout_s=2.0, no_worker_grace_s=15.0,
                 seq_aware=False):
        self.name = name
        #: seq-aware fronts read each request's sequence length (leaf
        #: axis 1) into the entry meta, so the meta-uniform chunking seam
        #: below also makes wire chunks SEQ-uniform — a short prompt is
        #: never concatenated into (and padded up to) a long batch before
        #: it even reaches a worker's 2-D bucket grid
        self.seq_aware = bool(seq_aware)
        self.max_queue = max_queue
        self.max_inflight_rows = max_inflight_rows
        self.max_dispatch_rows = max_dispatch_rows
        self.default_deadline_s = default_deadline_s
        self.batch_window_s = batch_window_s
        self.retries = retries
        self.request_timeout_s = request_timeout_s
        self.probe_timeout_s = probe_timeout_s
        #: how long a deadline-less request may wait for ANY live worker
        #: (e.g. mid-respawn) before it is counted-shed as no_worker —
        #: the backstop that keeps "never silently dropped" true even
        #: when the whole pool is down
        self.no_worker_grace_s = no_worker_grace_s
        self._queue: queue.Queue = queue.Queue()
        self._pending_rows = 0
        self._lock = threading.Lock()
        self._workers = {}  # wid -> _Worker
        self._stop = threading.Event()
        self._threads = []
        self._counts = {"submitted": 0, "served": 0, "served_rows": 0,
                        "shed_queue_full": 0, "shed_deadline": 0,
                        "shed_no_worker": 0, "shed_worker": 0,
                        "errors": 0, "retries": 0, "failovers": 0}
        self._recent_latencies = []
        reg = self._reg = _tm.get_registry()
        self._m_requests = reg.counter(
            "fleet_requests_total",
            "fleet front requests by outcome (submitted/served/"
            "shed_queue_full/shed_deadline/shed_no_worker/shed_worker/"
            "error)")
        self._m_shed = reg.counter(
            "serving_shed_total",
            "load-shed requests per model and reason "
            "(queue_full / deadline / shutdown)")
        self._m_dispatch = reg.counter(
            "fleet_dispatch_total",
            "fleet batches shipped per worker and result (ok/shed/error)")
        self._m_retry = reg.counter(
            "fleet_retry_total",
            "fleet batches retried onto another worker, labeled by the "
            "worker that failed")
        self._m_failover = reg.counter(
            "fleet_failover_total",
            "workers marked dead by the router (dispatch/probe failures)")
        self._m_alive = reg.gauge(
            "fleet_worker_alive",
            "1 when the router considers this worker live, else 0")
        self._m_outstanding = reg.gauge(
            "fleet_outstanding_rows",
            "rows currently in flight to this worker (the load signal "
            "least-outstanding dispatch balances on)")
        self._m_depth = reg.gauge(
            "fleet_admission_queue_depth",
            "pending examples in the fleet front's bounded queue")
        self._m_p50 = reg.gauge(
            "fleet_latency_p50_seconds",
            "rolling p50 fleet request latency (submit to resolve)")
        self._m_p99 = reg.gauge(
            "fleet_latency_p99_seconds",
            "rolling p99 fleet request latency (submit to resolve)")
        self._m_latency = reg.histogram(
            "fleet_request_latency_seconds",
            "fleet submit-to-resolve request latency")
        if reg.enabled:
            # pre-register every outcome series at zero (the prober
            # idiom): a shed/error series born mid-storm contributes
            # nothing to the SLO delta window it first appears in
            for outcome in ("submitted", "served", "shed_queue_full",
                            "shed_deadline", "shed_no_worker",
                            "shed_worker", "error"):
                self._m_requests.inc(0, outcome=outcome)
        self.set_endpoints(endpoints)
        for i in range(concurrency):
            t = threading.Thread(target=self._dispatch_loop,
                                 name=f"fleet-dispatch-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    # ---- topology ----

    def set_endpoints(self, endpoints):
        """Replace the worker set. ``endpoints``: iterable of addresses
        or ``(worker_id, address)`` pairs (the supervisor pushes pairs so
        metric labels stay stable across respawns — a respawned worker
        keeps its id under a fresh address, and arrives alive again)."""
        pairs = []
        for i, e in enumerate(endpoints):
            if isinstance(e, str):
                pairs.append((f"w{i}", e))
            else:
                pairs.append((str(e[0]), str(e[1])))
        with self._lock:
            fresh = {}
            for wid, addr in pairs:
                prev = self._workers.get(wid)
                if prev is not None and prev.address == addr:
                    fresh[wid] = prev  # same process: keep its state
                else:
                    fresh[wid] = _Worker(wid, addr)
            self._workers = fresh
            snapshot = list(fresh.values())
        if self._reg.enabled:
            for w in snapshot:
                self._m_alive.set(1.0 if w.alive else 0.0, worker=w.wid)
                self._m_outstanding.set(w.outstanding, worker=w.wid)

    def endpoints(self):
        with self._lock:
            return [(w.wid, w.address) for w in self._workers.values()]

    def mark_dead(self, wid, error=None):
        """Mark one worker dead (router-observed failure or an external
        liveness verdict, e.g. the supervisor's probe loop)."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or not w.alive:
                return
            w.alive = False
            w.failures += 1
            w.last_error = None if error is None else str(error)[:300]
            self._counts["failovers"] += 1
        if self._reg.enabled:
            self._m_failover.inc(worker=wid)
            self._m_alive.set(0.0, worker=wid)

    def mark_alive(self, wid):
        """Revive one worker — the recovery path for a false-positive
        ``mark_dead`` (a transient stall/timeout must not shrink the
        pool forever). Called by a successful ``health()`` probe and by
        the supervisor's probe loop on every healthy answer."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.alive:
                return
            w.alive = True
            w.last_error = None
        if self._reg.enabled:
            self._m_alive.set(1.0, worker=wid)

    # ---- request path ----

    def submit(self, x, deadline_s=None, *, batched=False, tenant=None,
               origin=None):
        """Queue one example (or one multi-example batch with
        ``batched=True``); returns an :class:`InferenceFuture`. Admission
        bounds queued EXAMPLES exactly like the engine's submit: a full
        front sheds here rather than queueing without bound.

        ``tenant``/``origin`` ride the wire to the worker engine
        (demand attribution / synthetic-traffic marking): a probe-origin
        request counts into origin-labeled series (excluded by every
        default SLO rule) and never enters the front's rolling p50/p99
        ring; a tenant feeds the per-tenant usage ledger worker-side."""
        if self._stop.is_set():
            raise ServingShutdown(
                f"fleet router {self.name!r} is stopped")
        meta = None
        if tenant is not None or origin is not None:
            meta = {"tenant": tenant, "origin": origin}
        olab = {"origin": str(origin)} if origin else {}
        item = _as_input(x)
        if batched:
            dims = {(int(np.shape(l)[0]) if np.ndim(l) else -1)
                    for l in _leaves(item)}
            if len(dims) != 1 or -1 in dims:
                raise ValueError(
                    "batched submit requires every input leaf to carry "
                    "the examples on axis 0 with one shared length; got "
                    f"leading dims {sorted(dims)}")
            nrows = dims.pop()
            if nrows == 0:
                raise ValueError("batched submit requires at least one "
                                 "example (got a 0-row batch)")
            if nrows > self.max_queue:
                raise ValueError(
                    f"batched submit of {nrows} rows exceeds the "
                    f"admission bound (max_queue={self.max_queue})")
        else:
            nrows = None
            item = _tree_map(lambda a: a[None], item)
        rows = 1 if nrows is None else nrows
        if self.seq_aware:
            lead = _leaves(item)[0]
            if np.ndim(lead) < 2:
                raise ValueError(
                    f"fleet {self.name!r} is seq-aware but the input "
                    f"carries no sequence axis (leaf shape "
                    f"{tuple(np.shape(lead))})")
            # seq rides the entry meta: chunk assembly compares meta for
            # uniformity, so co-drained entries with different lengths
            # ship as separate wire payloads (each rectangular as-is)
            meta = dict(meta or {}, seq=int(np.shape(lead)[1]))
        fut = InferenceFuture()
        # the fleet-level causal trace roots HERE: dispatch attempts and
        # the worker-side device spans (grafted from the /submit response)
        # all hang under this one trace id. Tracing off: None, a branch.
        tctx = _tracectx.maybe_start("fleet.request", model=self.name)
        if tctx is not None:
            fut.trace_id = tctx.trace_id
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else now + deadline_s
        self._count("submitted")
        if self._reg.enabled:
            self._m_requests.inc(outcome="submitted", **olab)
        with self._lock:
            if self._pending_rows + rows > self.max_queue:
                full = True
            else:
                full = False
                self._pending_rows += rows
        if full:
            self._count("shed_queue_full")
            if self._reg.enabled:
                self._m_shed.inc(model=self.name, reason="queue_full",
                                 **olab)
                self._m_requests.inc(outcome="shed_queue_full", **olab)
            if tctx is not None:
                tctx.add_span("fleet.shed", now, time.perf_counter(),
                              reason="queue_full")
                tctx.finish(status="shed")
            raise _overloaded(
                f"fleet {self.name!r}: admission queue full "
                f"({self.max_queue} pending)", "queue_full")
        self._queue.put((item, fut, now, deadline,
                         None if tctx is None else tctx.handoff(), nrows,
                         meta))
        if self._stop.is_set():
            # raced stop(): its drain may already be done — fail
            # stragglers rather than hang their waiters
            self._fail_pending()
        if self._reg.enabled:
            self._m_depth.set(self._pending_rows)
        return fut

    def output(self, x, deadline_s=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(x, deadline_s=deadline_s).get(
            timeout=self.request_timeout_s)

    # ---- dispatch ----

    def _take(self, block=True, timeout=None):
        item = self._queue.get(block=block, timeout=timeout)
        with self._lock:
            self._pending_rows -= item[5] or 1
        return item

    def _drain(self):
        """Fleet-level continuous batching: block briefly for the first
        entry, then take everything queued (no per-slot waits), bounded
        by ``max_dispatch_rows`` per shipped batch — and never assembled
        past the per-worker in-flight window, or the batch could fit on
        no worker and spin forever."""
        cap = min(self.max_dispatch_rows, self.max_inflight_rows)

        def rows(b):
            return sum(it[5] or 1 for it in b)
        try:
            batch = [self._take(timeout=0.05)]
        except queue.Empty:
            return []
        try:
            while rows(batch) < cap:
                batch.append(self._take(block=False))
        except queue.Empty:
            if self.batch_window_s > 0:
                deadline = time.perf_counter() + self.batch_window_s
                while rows(batch) < cap:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._take(timeout=remaining))
                    except queue.Empty:
                        break
        return batch

    def _shed(self, entries, reason, exc_msg):
        """Terminal counted shed for a batch of entries — the 'never
        silently dropped' contract's third leg."""
        err = _overloaded(exc_msg, reason)
        now = time.perf_counter()
        for _x, fut, _t, _dl, tctx, _n, _meta in entries:
            if tctx is not None:
                # close the trace BEFORE waking the waiter: a shed is a
                # terminal outcome worth ringing (the overload p99 story)
                tctx.add_span("fleet.shed", now, now, reason=reason)
                tctx.finish(status="shed")
            if not fut.done():
                fut._set_error(err)
        n = len(entries)
        count_key = (f"shed_{reason}" if reason in
                     ("queue_full", "deadline", "no_worker") else
                     "shed_worker")
        self._count(count_key, n)
        if self._reg.enabled:
            metric_reason = {"no_worker": "no_worker",
                             "deadline": "deadline",
                             "queue_full": "queue_full"}.get(reason,
                                                            "worker_shed")
            # per entry, not bulk: synthetic entries shed into their own
            # origin-labeled series (organic shed SLIs stay untouched)
            for e in entries:
                olab = _origin_labels(e[6])
                self._m_shed.inc(model=self.name, reason=metric_reason,
                                 **olab)
                self._m_requests.inc(outcome=count_key, **olab)

    def _pick_worker(self, rows, exclude):
        """Least-outstanding live worker whose in-flight window has room
        for ``rows`` more; reserves the rows before returning (released
        by ``_release``). None when no such worker exists right now."""
        with self._lock:
            best = None
            for w in self._workers.values():
                if not w.alive or w.wid in exclude:
                    continue
                if w.outstanding + rows > self.max_inflight_rows \
                        and not (w.outstanding == 0
                                 and rows > self.max_inflight_rows):
                    # window full — except a single batched submit wider
                    # than the window itself, which ships alone to an
                    # IDLE worker (it could never fit otherwise)
                    continue
                if best is None or w.outstanding < best.outstanding:
                    best = w
            if best is not None:
                best.outstanding += rows
                out = best.outstanding
        if best is not None and self._reg.enabled:
            self._m_outstanding.set(out, worker=best.wid)
        return best

    def _release(self, w, rows):
        with self._lock:
            w.outstanding -= rows
            out = w.outstanding
        if self._reg.enabled:
            self._m_outstanding.set(out, worker=w.wid)

    def _any_alive(self):
        with self._lock:
            return any(w.alive for w in self._workers.values())

    def _dispatch_loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            now = time.perf_counter()
            live = []
            for entry in batch:
                _x, fut, t_sub, deadline, _tc, _n, _meta = entry
                if deadline is not None and now > deadline:
                    self._shed([entry], "deadline",
                               f"fleet {self.name!r}: deadline exceeded "
                               f"while queued "
                               f"({1e3 * (now - t_sub):.1f} ms)")
                    continue
                live.append(entry)
            if self._reg.enabled:
                self._m_depth.set(self._pending_rows)
            # ship in window-sized chunks: a drained multi-row (batched)
            # entry can push the assembly past max_inflight_rows, and an
            # over-window batch only ever fits an IDLE worker — chunking
            # keeps the co-drained single-row entries from becoming its
            # hostages (an indivisible over-window entry still ships
            # alone via _pick_worker's idle exception)
            chunk, chunk_rows, chunk_meta = [], 0, None
            for entry in live:
                r = entry[5] or 1
                # one wire payload carries ONE (tenant, origin) pair, so
                # a chunk must be meta-uniform: co-drained entries with a
                # different attribution start a fresh chunk rather than
                # inherit the lead entry's identity
                if chunk and (chunk_rows + r > self.max_inflight_rows
                              or entry[6] != chunk_meta):
                    self._dispatch(chunk)
                    chunk, chunk_rows = [], 0
                if not chunk:
                    chunk_meta = entry[6]
                chunk.append(entry)
                chunk_rows += r
            if chunk:
                self._dispatch(chunk)

    def _note_attempt(self, entries, wid, attempt, outcome, t0,
                      graft_doc=None, offset_s=0.0, **args):
        """Stamp one dispatch attempt as a child span on EVERY member
        trace — retries/failovers ride the SAME trace as numbered
        attempt spans, and a 200's worker-side trace doc grafts in under
        its attempt, giving the ring one admission→dispatch→worker-device
        →resolve story per request."""
        t1 = time.perf_counter()
        for _x, _f, _t, _dl, tctx, _n, _meta in entries:
            if tctx is None:
                continue
            span = tctx.add_span("fleet.attempt", t0, t1, worker=wid,
                                 attempt=attempt, outcome=outcome, **args)
            if graft_doc is not None:
                tctx.trace.graft(graft_doc, span["span_id"],
                                 offset_s=offset_s, instance=wid)

    def _dispatch(self, entries):
        """Ship one assembled batch, retrying across workers. Exits with
        every entry's future resolved (answer / shed / error)."""
        rows = sum(e[5] or 1 for e in entries)
        xs = _tree_map(lambda *leaves: np.concatenate(leaves),
                       *[e[0] for e in entries])
        # the batch's effective deadline is its EARLIEST member's
        deadlines = [e[3] for e in entries if e[3] is not None]
        deadline = min(deadlines) if deadlines else None
        t_disp = time.perf_counter()
        for _x, _f, t_sub, _dl, tctx, _n, _meta in entries:
            if tctx is not None:
                # fleet-level queue wait, distinct from the worker-side
                # serving.queue_wait that grafts in after dispatch
                tctx.add_span("fleet.queue_wait", t_sub, t_disp)
        attempt = 0
        tried = set()
        t_wait0 = time.perf_counter()
        # chunks are meta-uniform, so the lead entry speaks for the batch
        meta = entries[0][6] or {}
        span_args = ({} if meta.get("seq") is None
                     else {"seq_len": meta["seq"]})
        while True:
            if self._stop.is_set():
                self._fail_entries(entries, ServingShutdown(
                    f"fleet router {self.name!r} stopped before "
                    f"dispatching this request"))
                return
            remaining = (None if deadline is None
                         else deadline - time.perf_counter())
            if remaining is not None and remaining <= 0:
                self._shed(entries, "deadline",
                           f"fleet {self.name!r}: deadline exceeded "
                           f"before a worker could serve the request")
                return
            w = self._pick_worker(rows, tried)
            if w is None:
                if tried and not self._untried_alive(tried):
                    # every live worker already failed or shed THIS
                    # batch: terminal counted shed (a retry loop over
                    # the same pool would spin, not help)
                    self._shed(entries, "no_worker" if not
                               self._any_alive() else "worker",
                               f"fleet {self.name!r}: every live worker "
                               f"failed or shed this request")
                    return
                if (not self._any_alive()
                        and time.perf_counter() - t_wait0
                        > self.no_worker_grace_s):
                    # whole pool down past the grace window (respawns
                    # take seconds, not this long): counted shed
                    self._shed(entries, "no_worker",
                               f"fleet {self.name!r}: no live worker "
                               f"within {self.no_worker_grace_s:.1f}s")
                    return
                # window full / mid-respawn: wait briefly for capacity
                time.sleep(0.005)
                continue
            attempt += 1
            t_att = time.perf_counter()
            sent_unix = time.time()
            try:
                payload = {"rows": _tree_map(lambda a: a.tolist(), xs)}
                if remaining is not None:
                    payload["deadline_ms"] = max(1e3 * remaining, 1.0)
                # demand attribution rides the payload
                if meta.get("tenant") is not None:
                    payload["tenant"] = meta["tenant"]
                if meta.get("origin") is not None:
                    payload["origin"] = meta["origin"]
                if meta.get("seq") is not None:
                    # the seq length the router batched on, declared so
                    # the worker can cross-check it against the rows it
                    # decodes (routing/metering/trace all see ONE bucket)
                    payload["seq_len"] = meta["seq"]
                timeout = self.request_timeout_s
                if remaining is not None:
                    timeout = min(timeout, remaining + 5.0)
                # ONE trace carrier per wire hop: the worker roots a
                # single remote-parented trace under the first entry's
                # identity, and the returned doc grafts into EVERY
                # member's trace (the batch is one device-side event)
                lead = entries[0][4]
                headers = (None if lead is None else
                           {TRACE_ID_HEADER: lead.trace_id,
                            PARENT_SPAN_HEADER: str(lead.span_id)})
                code, doc = _http_json(w.address + "/submit", payload,
                                       timeout=timeout, headers=headers)
            except Exception as e:  # noqa: BLE001 — connection failure
                # the failover leg: worker unreachable mid-request
                self._release(w, rows)
                self.mark_dead(w.wid, error=e)
                tried.add(w.wid)
                self._count("retries")
                if self._reg.enabled:
                    self._m_retry.inc(worker=w.wid)
                    self._m_dispatch.inc(worker=w.wid, result="error")
                self._note_attempt(entries, w.wid, attempt, "error",
                                   t_att, error=str(e)[:120])
                continue  # idempotent replay onto the next-best worker
            recv_unix = time.time()
            self._release(w, rows)
            with self._lock:
                w.dispatched += 1
            if code == 200:
                if self._reg.enabled:
                    self._m_dispatch.inc(worker=w.wid, result="ok")
                # clock offset from THIS round trip (NTP single sample,
                # clamped to 0 inside the RTT uncertainty) re-anchors the
                # worker's span timestamps onto our timeline
                offset_s, _unc = _timeline.estimate_offset(
                    (doc.get("clock") or {}).get("unix"),
                    sent_unix, recv_unix)
                self._note_attempt(entries, w.wid, attempt, "ok", t_att,
                                   graft_doc=doc.get("trace"),
                                   offset_s=offset_s, **span_args)
                self._resolve(entries, doc)
                return
            if code == 429:
                if self._reg.enabled:
                    self._m_dispatch.inc(worker=w.wid, result="shed")
                self._note_attempt(entries, w.wid, attempt, "shed",
                                   t_att, reason=doc.get("reason"))
                if doc.get("reason") == "deadline":
                    # stale everywhere — retrying cannot help
                    self._shed(entries, "deadline",
                               f"fleet {self.name!r}: worker "
                               f"{w.wid} shed the request (deadline)")
                    return
                # that worker's queue is full; another may have room
                tried.add(w.wid)
                self._count("retries")
                if self._reg.enabled:
                    self._m_retry.inc(worker=w.wid)
                if not self._untried_alive(tried):
                    self._shed(entries, "worker",
                               f"fleet {self.name!r}: every live worker "
                               f"shed the request (queue_full)")
                    return
                continue
            if code == 503:
                # stopping worker: treat like a dead one and fail over
                self.mark_dead(w.wid, error="worker shutting down")
                tried.add(w.wid)
                self._count("retries")
                if self._reg.enabled:
                    self._m_retry.inc(worker=w.wid)
                    self._m_dispatch.inc(worker=w.wid, result="error")
                self._note_attempt(entries, w.wid, attempt, "shutdown",
                                   t_att)
                continue
            # 4xx/5xx: a real error answer — the request itself is bad
            # or the model failed; replaying identical bytes would fail
            # identically, so propagate (counted, never silent)
            if self._reg.enabled:
                self._m_dispatch.inc(worker=w.wid, result="error")
            self._note_attempt(entries, w.wid, attempt, "error", t_att,
                               code=code)
            self._fail_entries(entries, RuntimeError(
                f"fleet worker {w.wid} answered {code}: "
                f"{doc.get('error', doc)}"))
            return

    def _untried_alive(self, tried):
        with self._lock:
            return any(w.alive and w.wid not in tried
                       for w in self._workers.values())

    def _resolve(self, entries, doc):
        # arrays FIRST: raw JSON nested lists would explode into
        # per-scalar leaves under tree_map (a dict stays the multi-output
        # pytree, each head one [n, ...] array)
        outputs = doc.get("outputs")
        if isinstance(outputs, dict):
            outputs = {k: np.asarray(v) for k, v in outputs.items()}
        else:
            outputs = np.asarray(outputs)
        done = time.perf_counter()
        off = 0
        lats, origins = [], []
        for _x, fut, t_sub, _dl, tctx, n, meta in entries:
            width = n or 1
            y = _tree_map(
                lambda a: (a[off:off + width] if n is not None
                           else a[off]), outputs)
            off += width
            lats.append(done - t_sub)
            origins.append((meta or {}).get("origin"))
            if tctx is not None:
                tctx.add_span("fleet.resolve", done, time.perf_counter())
                tctx.finish()
            fut.latency_s = done - t_sub
            # resolve LAST: a waiter that wakes here must see a COMPLETE
            # trace in the ring (same discipline as the engine's worker)
            fut._set(y)
        # accounting is in REQUESTS (submit calls) everywhere, so
        # submitted == served + shed_* + errors balances for batched
        # submits too; rows ride separately as served_rows
        self._count("served", len(entries))
        self._count("served_rows", sum(e[5] or 1 for e in entries))
        self._note_latencies(lats, origins=origins)
        if self._reg.enabled:
            for e in entries:
                self._m_requests.inc(outcome="served",
                                     **_origin_labels(e[6]))

    def _fail_entries(self, entries, err, count_key="errors"):
        for _x, fut, _t, _dl, tctx, _n, meta in entries:
            if tctx is not None:
                tctx.finish(status="error")
            if not fut.done():
                fut._set_error(err)
            if self._reg.enabled:
                self._m_requests.inc(outcome="error",
                                     **_origin_labels(meta))
        self._count(count_key, len(entries))

    def _fail_pending(self):
        err = ServingShutdown(
            f"fleet router {self.name!r} stopped before serving this "
            f"request")
        while True:
            try:
                _x, fut, _t, _dl, tctx, _n, _meta = self._take(block=False)
            except queue.Empty:
                break
            if tctx is not None:
                # never completed its causal story — don't ring it
                tctx.abandon()
            if not fut.done():
                fut._set_error(err)
                self._count("errors")
                if self._reg.enabled:
                    self._m_shed.inc(model=self.name, reason="shutdown")

    def _count(self, key, n=1):
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def _note_latencies(self, lats, origins=None):
        """Synthetic requests (``origins`` aligned with ``lats``) observe
        into origin-labeled histogram series but never enter the rolling
        p50/p99 ring — same isolation discipline as the engine's."""
        organic = [dt for i, dt in enumerate(lats)
                   if not (origins and origins[i])]
        with self._lock:
            self._recent_latencies.extend(organic)
            del self._recent_latencies[:-512]
            recent = list(self._recent_latencies)
        if self._reg.enabled:
            for i, dt in enumerate(lats):
                self._m_latency.observe(
                    dt, **({"origin": str(origins[i])}
                           if origins and origins[i] else {}))
            if recent:
                self._m_p50.set(float(np.percentile(recent, 50)))
                self._m_p99.set(float(np.percentile(recent, 99)))

    # ---- lifecycle / status ----

    def stop(self):
        """Stop dispatching and FAIL every pending request promptly —
        a stopped front must not leave waiters blocked."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._fail_pending()

    def health(self):
        """Cross-worker /health aggregation: every worker probed live,
        CONCURRENTLY (a dead worker costs one probe timeout total, not
        one per worker — this runs inside the UIServer's single-threaded
        /fleet?probe=1 handler). A healthy answer revives a worker the
        router had written off; an unreachable one is marked dead and
        appears with ``ok: false``. Probes are stamped ``origin=probe``
        on the wire, so worker-side accounting never mistakes them for
        organic traffic; each worker's usage-ledger slice is folded into
        a per-model ``usage`` aggregate (the fleet-wide demand signal)."""
        eps = self.endpoints()
        slots = [None] * len(eps)

        def probe(i, wid, addr):
            try:
                _code, doc = _http_json(addr + "/health",
                                        timeout=self.probe_timeout_s,
                                        headers={ORIGIN_HEADER: "probe"})
                slots[i] = doc  # each thread owns exactly slot i
                self.mark_alive(wid)
            except Exception as e:  # noqa: BLE001 — probe failure
                self.mark_dead(wid, error=e)
                slots[i] = {"ok": False, "error": str(e)[:300]}

        threads = [threading.Thread(target=probe, args=(i, wid, addr),
                                    daemon=True)
                   for i, (wid, addr) in enumerate(eps)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout_s + 1.0)
        out = {wid: (slots[i] if slots[i] is not None
                     else {"ok": False, "error": "probe hung"})
               for i, (wid, _addr) in enumerate(eps)}
        alive = sum(1 for doc in out.values() if doc.get("ok"))
        usage = {}
        for doc in out.values():
            model = (doc.get("stats") or {}).get("model")
            if model and isinstance(doc.get("usage"), dict):
                _merge_usage(usage.setdefault(model, {}), doc["usage"])
        return {"workers": out, "alive": alive, "total": len(out),
                "usage": usage}

    def federated_metrics(self, timeout_s=None):
        """One scrape for the whole fleet: every worker's ``/metrics``
        merged under stable ``instance`` labels (the worker ids the
        supervisor keeps across respawns). Dead members are counted
        (``federate_scrape_total{outcome="error"}``), never a hang —
        the aggregation semantics of telemetry.federate."""
        from deeplearning4j_tpu_torch.telemetry import federate as _fed
        targets = [(wid, addr + "/metrics")
                   for wid, addr in self.endpoints()]
        return _fed.federate(
            targets, timeout_s=timeout_s or self.probe_timeout_s)

    def timeline_sources(self, timeout_s=None, include_local=True):
        """Per-process timeline sources for the cluster merge: this
        router's own ring plus every worker's ``/traces`` scrape, each
        worker's clock offset estimated from ITS scrape round trip. A
        dead worker simply contributes no source (the merge proceeds —
        its last traces still arrive via flight dumps postmortem)."""
        timeout = timeout_s or self.probe_timeout_s
        eps = self.endpoints()
        slots = [None] * len(eps)

        def scrape(i, wid, addr):
            sent = time.time()
            try:
                _code, doc = _http_json(addr + "/traces", timeout=timeout)
            except Exception:  # noqa: BLE001 — dead member, no source
                return
            off, _unc = _timeline.estimate_offset(
                (doc.get("clock") or {}).get("unix"), sent, time.time())
            slots[i] = _timeline.source(wid, doc.get("traces") or {},
                                        clock_offset_s=off)

        threads = [threading.Thread(target=scrape, args=(i, wid, addr),
                                    daemon=True)
                   for i, (wid, addr) in enumerate(eps)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 1.0)
        sources = []
        if include_local:
            sources.append(_timeline.source(
                f"router:pid{os.getpid()}",
                _tracectx.get_ring().snapshot()))
        sources.extend(s for s in slots if s is not None)
        return sources

    def latency_percentiles(self):
        with self._lock:
            recent = list(self._recent_latencies)
        if not recent:
            return None, None
        return (float(np.percentile(recent, 50)),
                float(np.percentile(recent, 99)))

    def slo_snapshot(self):
        """The hedging-policy seam: per-worker burn signals (outstanding
        rows = the queue_wait pressure a request would join, liveness,
        dispatch/failure history) + the front's live shed ratio + the
        SLO engine's serving-tagged verdicts, one read-only doc. Inert
        today — a future hedge policy decides 'queued behind a slow
        member' vs 'the model is just slow' from exactly these signals
        (the per-attempt worker spans grafted into each trace give the
        per-request version; this is the steady-state one)."""
        from deeplearning4j_tpu_torch.telemetry import slo as _slo
        with self._lock:
            counts = dict(self._counts)
            workers = {w.wid: {"alive": w.alive,
                               "outstanding": w.outstanding,
                               "dispatched": w.dispatched,
                               "failures": w.failures}
                       for w in self._workers.values()}
            pending = self._pending_rows
        submitted = counts.get("submitted", 0)
        shed = sum(v for k, v in counts.items() if k.startswith("shed_"))
        p50, p99 = self.latency_percentiles()
        return {"model": self.name,
                "queue_depth": pending,
                "submitted": submitted,
                "shed": shed,
                "shed_ratio": (shed / submitted) if submitted else 0.0,
                "latency_s": {"p50": p50, "p99": p99},
                "workers": workers,
                "alerts": _slo.alerts(tag="serving")}

    def stats(self):
        """The fleet front's status payload (rides /fleet)."""
        with self._lock:
            counts = dict(self._counts)
            workers = [w.snapshot() for w in self._workers.values()]
            pending = self._pending_rows
        p50, p99 = self.latency_percentiles()
        return {
            "name": self.name,
            "max_queue": self.max_queue,
            "max_inflight_rows": self.max_inflight_rows,
            "queue_depth": pending,
            "requests": counts,
            "workers": workers,
            "latency_ms": {
                "p50": None if p50 is None else round(1e3 * p50, 3),
                "p99": None if p99 is None else round(1e3 * p99, 3)},
        }


def _merge_usage(dst, src):
    """Fold one worker's usage-ledger slice (numeric fields + a
    ``tenants`` breakdown) into the fleet aggregate, in place."""
    for k, v in src.items():
        if isinstance(v, (int, float)):
            dst[k] = dst.get(k, 0) + v
        elif k == "tenants" and isinstance(v, dict):
            tenants = dst.setdefault("tenants", {})
            for tenant, fields in v.items():
                _merge_usage(tenants.setdefault(tenant, {}), fields)
    return dst


def _leaves(tree):
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves
    return list(tree_leaves(tree))


def _tree_map(fn, *trees):
    from deeplearning4j_tpu_torch.utils.trees import tree_map
    return tree_map(fn, *trees)
