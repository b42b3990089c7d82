"""Fleet serving worker: one process, one ServingEngine, one HTTP wire.

The port of ``deeplearning4j_tpu/fleet/worker.py``. A :class:`FleetWorker`
wraps a started :class:`~deeplearning4j_tpu_torch.serving.ServingEngine`
behind the JAX package's local HTTP protocol on ``127.0.0.1``:

    POST /submit    {"rows": [...], "deadline_ms": f} -> {"outputs": [...]}
    GET  /health    liveness + engine stats + compile-cache counters +
                    kernel launches and builds
    GET  /stats     the engine's stats payload
    GET  /usage     per-model/per-tenant usage ledger (metering)
    GET  /metrics   the registry snapshot the federation scrapes
    GET  /traces    the slow-trace ring the cluster timeline scrapes
    POST /swap      {"model_path": p} -> warm-then-atomic hot swap
    POST /shutdown  clean stop (engine drained, waiters failed promptly)

``/submit`` carries multi-example batches (``rows`` leading axis =
examples; a dict body is the ComputationGraph multi-input form), so the
router's fleet-level continuous batching pays one HTTP round trip per
device batch. Answers travel as JSON lists of the engine's float32
outputs (every float32 is a double, so the wire loses nothing). Sheds
surface as HTTP 429 with the reason (``queue_full`` / ``deadline``); a
stopped engine answers 503.

Run as a subprocess (what :class:`FleetSupervisor` spawns)::

    python -m deeplearning4j_tpu_torch.fleet.worker --model-path ckpt.zip \
        --warm-manifest wm.zip --buckets 1,8 --port 0 --worker-id w0

The worker serves on ``--device`` (default ``cuda``); a host without the
card raises before the ready line, so the spawner sees the worker fail
rather than serve on the CPU. It prints one machine-readable ready line
after warmup, ``{"fleet_worker_ready": true, "port": <bound>, "aot":
{...}, "kernel_builds": {...}, ...}``, carrying the bound port and the
warm-up counters, so the spawner can judge a warm start from the line
alone: in the port that is every grid entry served from the manifest
(its kernel libraries installed, its launch plans seeded: no tuning
lookup) and no nvcc run (``ops/_build.builds``). Libraries build and
install through a per-process temporary file and an atomic rename, so
workers sharing one build directory never read a half-written library.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deeplearning4j_tpu_torch.serving.engine import (ServingOverloaded,
                                                     ServingShutdown,
                                                     shed_reason)
from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx

#: the trace-propagation headers the router stamps on /submit (Dapper
#: style: the worker ADOPTS the router's trace id and parents its root
#: under the router's attempt span)
TRACE_ID_HEADER = "X-DL4J-Trace-Id"
PARENT_SPAN_HEADER = "X-DL4J-Parent-Span"
#: synthetic-traffic marker: router/supervisor health probes and the
#: prober's canaries stamp this so every wire hop counts them into
#: origin-labeled series (which the default SLO rules exclude) instead
#: of the organic ones
ORIGIN_HEADER = "X-DL4J-Origin"

#: the GET routes the wire counter buckets path labels into — an unknown
#: or mistyped path charts as "/other" instead of minting a new metric
#: series per distinct request string (label-cardinality hygiene)
GET_ROUTES = ("/health", "/stats", "/usage", "/metrics", "/traces")


def _tree_to_jsonable(y):
    """Outputs as JSON-ready nested lists (dict heads for multi-output
    graphs). float32 -> Python float is exact (every float32 is a
    double), so the wire costs no precision."""
    from deeplearning4j_tpu_torch.utils.trees import tree_map
    return tree_map(lambda a: np.asarray(a).tolist(), y)


def kernel_launches():
    """This process's launches of each hand-written kernel so far (the
    wrappers' own counts, ``ops/*.py``)."""
    from deeplearning4j_tpu_torch.ops import attention, conv_stats, lstm_seq
    return {"lstm_seq": int(lstm_seq.launches), "flash_attn": int(attention.launches),
            **{k: int(v) for k, v in conv_stats.launches.items()}}


def kernel_builds():
    """nvcc runs in this process, by kernel source (``ops/_build.py``)."""
    from deeplearning4j_tpu_torch.ops import _build
    return {k: int(v) for k, v in _build.builds.items()}


def _rows_from_json(rows):
    """The submit payload's ``rows`` back into engine inputs: a dict is
    the multi-input pytree (per-key [n, ...] arrays), anything else one
    [n, ...] array."""
    if isinstance(rows, dict):
        return {k: np.asarray(v, dtype=np.float32) for k, v in rows.items()}
    return np.asarray(rows, dtype=np.float32)


class FleetWorker:
    """HTTP front for ONE serving engine (usable in-process for tests;
    the supervisor runs it via this module's ``main()`` in a fresh
    process). ``port=0`` binds an ephemeral port; ``self.port`` is the
    actually-bound one."""

    def __init__(self, engine, *, worker_id="w0", port=0):
        self.engine = engine
        self.worker_id = worker_id
        self._t0 = time.time()
        self._swap_lock = threading.Lock()
        self._swaps = 0
        from deeplearning4j_tpu_torch.telemetry import get_registry
        self._reg = get_registry()
        self._m_http = self._reg.counter(
            "fleet_worker_http_total",
            "worker HTTP GETs by path and origin (health-check probes "
            "carry origin=probe, so wire-level SLIs can exclude them)")
        worker = self

        class Handler(BaseHTTPRequestHandler):
            # one request = one short-lived handler thread
            # (ThreadingHTTPServer); all shared state lives on the worker
            daemon_threads = True

            def log_message(self, *args):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                doc = json.loads(raw)
                if not isinstance(doc, dict):
                    raise ValueError("request body must be a JSON object")
                return doc

            def do_GET(self):
                worker._count_get(self.path,
                                  self.headers.get(ORIGIN_HEADER))
                if self.path.startswith("/health"):
                    self._json(worker.health())
                elif self.path.startswith("/stats"):
                    self._json(worker.engine.stats())
                elif self.path.startswith("/usage"):
                    # the per-model/per-tenant usage ledger (metering)
                    self._json(worker.usage())
                elif self.path.startswith("/metrics"):
                    # the federation scrape: full registry snapshot (kind
                    # + help + series) so the aggregator can re-render
                    # OpenMetrics with an added instance label, plus the
                    # clock pair for per-scrape offset estimation
                    self._json(worker.metrics())
                elif self.path.startswith("/traces"):
                    # the timeline scrape: this process's slow-trace ring
                    # in the flight-dump 'traces' shape timeline.load_file
                    # and the cluster merge both accept
                    self._json({"worker_id": worker.worker_id,
                                "pid": os.getpid(),
                                "clock": _timeline.clock_pair(),
                                "traces":
                                    _tracectx.get_ring().snapshot()})
                else:
                    self._json({"error": f"unknown path {self.path!r}"},
                               code=404)

            def do_POST(self):
                try:
                    doc = self._body()
                except (ValueError, UnicodeDecodeError) as e:
                    self._json({"error": f"bad request body: {e}"},
                               code=400)
                    return
                if self.path.startswith("/submit"):
                    self._submit(doc)
                elif self.path.startswith("/swap"):
                    self._swap(doc)
                elif self.path.startswith("/shutdown"):
                    self._json({"ok": True, "worker_id": worker.worker_id})
                    # stop AFTER the response is on the wire, off this
                    # handler thread (stop() joins the serve loop)
                    threading.Thread(target=worker.stop,
                                     daemon=True).start()
                else:
                    self._json({"error": f"unknown path {self.path!r}"},
                               code=404)

            def _submit(self, doc):
                # wire-propagated tracing: adopt the router's trace id so
                # the device-side spans (queue_wait, device_exec, ...)
                # land on ONE trace spanning both processes; the doc rides
                # the response for the router to graft into its ring
                rctx = _tracectx.maybe_start_remote(
                    "fleet.worker_submit",
                    self.headers.get(TRACE_ID_HEADER),
                    self.headers.get(PARENT_SPAN_HEADER),
                    worker=worker.worker_id)
                try:
                    rows = _rows_from_json(doc["rows"])
                    seq_len = doc.get("seq_len")
                    if seq_len is not None:
                        # a seq-aware router declares the length it
                        # batched on; cross-check against the decoded
                        # rows so routing and engine can never silently
                        # disagree about which 2-D bucket this batch is
                        lead = (next(iter(rows.values()))
                                if isinstance(rows, dict) else rows)
                        got = (int(lead.shape[1]) if lead.ndim >= 2
                               else None)
                        if got != int(seq_len):
                            raise ValueError(
                                f"payload seq_len={seq_len} disagrees "
                                f"with the rows' sequence axis ({got})")
                    deadline_ms = doc.get("deadline_ms")
                    fut = worker.engine.submit(
                        rows, batched=True,
                        deadline_s=(None if deadline_ms is None
                                    else deadline_ms / 1e3),
                        tctx=rctx,
                        # demand attribution rides the payload (header as
                        # origin fallback): tenant feeds the usage ledger,
                        # origin=probe keeps canaries out of organic SLIs
                        tenant=doc.get("tenant"),
                        origin=(doc.get("origin")
                                or self.headers.get(ORIGIN_HEADER)))
                    y = fut.get(timeout=doc.get("timeout_s", 60))
                    resp = {"outputs": _tree_to_jsonable(y),
                            "worker_id": worker.worker_id,
                            "latency_ms": (
                                None if fut.latency_s is None
                                else round(1e3 * fut.latency_s, 3))}
                    if rctx is not None:
                        # the engine finished the trace BEFORE resolving
                        # the future, so the doc here is complete; the
                        # clock pair lets the router align our timestamps
                        resp["trace"] = rctx.trace.to_doc()
                        resp["clock"] = _timeline.clock_pair()
                    self._json(resp)
                except ServingOverloaded as e:
                    # shed, not error: the front retries or counts it
                    # (structured reason — never sniffed from message
                    # text, which embeds the free-form model name)
                    if rctx is not None:
                        rctx.finish(status="shed")  # idempotent: the
                        #   engine already closed admission/deadline sheds
                    self._json({"error": "shed",
                                "reason": shed_reason(e) or "queue_full",
                                "worker_id": worker.worker_id}, code=429)
                except ServingShutdown as e:
                    if rctx is not None:
                        rctx.abandon()
                    self._json({"error": "shutdown", "detail": str(e),
                                "worker_id": worker.worker_id}, code=503)
                except (KeyError, ValueError, TypeError) as e:
                    if rctx is not None:
                        rctx.finish(status="error")
                    self._json({"error": f"bad submit: {e}",
                                "worker_id": worker.worker_id}, code=400)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    if rctx is not None:
                        rctx.finish(status="error")
                    self._json({"error": f"{type(e).__name__}: {e}",
                                "worker_id": worker.worker_id}, code=500)

            def _swap(self, doc):
                try:
                    result = worker.swap(doc["model_path"],
                                         warm=doc.get("warm"))
                    self._json(result)
                except (KeyError, ValueError, OSError) as e:
                    self._json({"error": f"bad swap: {e}",
                                "worker_id": worker.worker_id}, code=400)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    self._json({"error": f"{type(e).__name__}: {e}",
                                "worker_id": worker.worker_id}, code=500)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        #: the ACTUALLY-BOUND port (`port=0` requests an ephemeral one, so
        #: N workers on one host never collide)
        self.port = self._httpd.server_address[1]
        self._thread = None

    @property
    def address(self):
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        if not self.engine.running:
            self.engine.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()  # release the listening socket too
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.engine.stop()

    def swap(self, model_path, warm=None):
        """ModelRegistry-style hot swap from a checkpoint/bundle path:
        the replacement forward is built and warmed OFF the serving path,
        then atomically rebound (no queued request dropped). Serialized
        under a lock so two concurrent /swap posts can't interleave their
        warm/rebind windows."""
        from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint
        with self._swap_lock:
            net = restore_checkpoint(model_path, device=self.engine.device)
            self.engine.update_model(net, warm=warm)
            self._swaps += 1
            return {"ok": True, "worker_id": self.worker_id,
                    "swaps": self._swaps,
                    "aot": self.engine.stats()["aot"],
                    "kernel_builds": kernel_builds()}

    def _count_get(self, path, origin):
        """Wire-level GET accounting: probes carry their origin label,
        organic GETs keep the unlabeled series."""
        if self._reg.enabled:
            root = "/" + (path.lstrip("/").split("?")[0].split("/")[0]
                          or "")
            root = root if root in GET_ROUTES else "/other"
            self._m_http.inc(path=root,
                             **({"origin": str(origin)} if origin else {}))

    def usage(self):
        """The /usage payload: this process's per-model/per-tenant usage
        ledger (serving/metering.py) — what fleet /health aggregation
        folds up into the offered-load-per-model signal."""
        from deeplearning4j_tpu_torch.serving import metering as _metering
        return {"worker_id": self.worker_id, "pid": os.getpid(),
                "usage": _metering.get_meter().usage()}

    def metrics(self):
        """The /metrics payload the ``federate()`` aggregator scrapes:
        the full registry snapshot (kind/help/series — a superset of the
        ``series_map`` wire form) plus this process's clock pair."""
        from deeplearning4j_tpu_torch.telemetry import get_registry
        return {"worker_id": self.worker_id, "pid": os.getpid(),
                "clock": _timeline.clock_pair(),
                "metrics": get_registry().snapshot()}

    def health(self):
        """The /health payload: liveness + the engine's export hook
        (stats, compile-cache events, recapture counters) and this
        process's kernel launches and nvcc builds: what the supervisor
        probes and the router aggregates."""
        doc = self.engine.health()
        doc.update(ok=True, worker_id=self.worker_id, pid=os.getpid(),
                   uptime_s=round(time.time() - self._t0, 3),
                   port=self.port, swaps=self._swaps,
                   kernel_launches=kernel_launches(),
                   kernel_builds=kernel_builds())
        return doc

    def describe(self):
        """The machine-readable ready line ``main()`` prints: bound port
        + warmup counters, so a spawner can judge a warm start (every grid
        entry from the manifest, no nvcc build) from the line alone."""
        stats = self.engine.stats()
        from deeplearning4j_tpu_torch.utils import compile_cache as _cc
        return {"fleet_worker_ready": True, "worker_id": self.worker_id,
                "pid": os.getpid(), "port": self.port,
                "model": self.engine.name, "buckets": stats["buckets"],
                "seq_buckets": stats.get("seq_buckets"),
                "warmup_s": stats["warmup_s"], "aot": stats["aot"],
                "device": stats["device"],
                "compile_cache_events": _cc.event_counts(),
                "kernel_builds": kernel_builds(),
                "kernel_launches": kernel_launches(),
                # clock-alignment seed: the spawner pairs this with its
                # receipt time to place this process on the cluster
                # timeline
                "clock": _timeline.clock_pair()}


def _build_parser():
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.fleet.worker",
        description="one fleet serving worker process (spawned by "
                    "FleetSupervisor; see deeplearning4j_tpu_torch/fleet/)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-path", help="checkpoint/bundle zip to serve")
    src.add_argument("--zoo", help="zoo model name (fresh init)")
    p.add_argument("--worker-id", default="w0")
    p.add_argument("--name", default="default", help="served model name")
    p.add_argument("--port", type=int, default=0,
                   help="HTTP port (default 0 = ephemeral; the bound "
                        "port is printed in the ready line)")
    p.add_argument("--buckets",
                   help="comma-separated batch buckets to AOT-warm")
    p.add_argument("--seq-buckets",
                   help="comma-separated sequence-length buckets: the "
                        "engine warms the full (batch x seq) grid and "
                        "pads each request to its seq bucket instead of "
                        "max_seq")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--input-shape",
                   help="per-example feature shape, e.g. 28,28,1 "
                        "(default: derived from the model conf)")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--deadline-ms", type=float)
    p.add_argument("--batch-window-ms", type=float, default=1.0)
    p.add_argument("--warm-manifest", metavar="PATH",
                   help="serving warm manifest: each covered bucket warms with "
                        "the manifest's kernel libraries installed and its "
                        "launch plans seeded (no nvcc run, no tuning lookup)")
    p.add_argument("--compile-cache", metavar="DIR",
                   help="persistent kernel cache directory: the CUDA libraries "
                        "build into (or install from the manifest into) DIR")
    p.add_argument("--device", default="cuda",
                   help="where the engine serves (default cuda; a host without "
                        "the card fails before the ready line)")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from deeplearning4j_tpu_torch import telemetry
    # one model loader and one input-spec derivation, shared with the
    # serve CLI verb: drift between processes of one fleet would be a
    # fingerprint mismatch
    from deeplearning4j_tpu_torch.cli import _load_model, _serve_input_spec
    from deeplearning4j_tpu_torch.serving import ServingEngine
    from deeplearning4j_tpu_torch.utils import compile_cache as _cc

    telemetry.enable()  # the supervisor/router read this worker's counters
    _cc.enable_persistent_cache(args.compile_cache)
    net = _load_model(args)
    buckets = ([int(b) for b in args.buckets.split(",") if b.strip()]
               if args.buckets else None)
    seq_buckets = ([int(b) for b in args.seq_buckets.split(",")
                    if b.strip()] if args.seq_buckets else None)
    engine = ServingEngine(
        net, name=args.name, input_spec=_serve_input_spec(args, net),
        buckets=buckets, seq_buckets=seq_buckets,
        max_batch_size=args.max_batch,
        max_queue=args.max_queue,
        default_deadline_s=(None if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
        batch_window_s=args.batch_window_ms / 1e3,
        warm_manifest=args.warm_manifest or None, device=args.device)
    worker = FleetWorker(engine, worker_id=args.worker_id, port=args.port)
    worker.start()
    # one ready line after warmup: the spawner learns the bound port and
    # judges the warm start from the aot and build counters in it
    print(json.dumps(worker.describe(), default=str), flush=True)
    serve_thread = worker._thread
    try:
        while serve_thread.is_alive():  # /shutdown ends the serve loop
            serve_thread.join(timeout=1.0)
    except KeyboardInterrupt:
        worker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
