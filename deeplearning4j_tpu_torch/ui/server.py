"""Training dashboard web server.

The port of ``deeplearning4j_tpu/ui/server.py``: the same routes and JSON
payloads, served over the port's telemetry, serving registry, fleet,
goodput ledger, flight recorder and compile cache. Reference analog:
deeplearning4j-ui-parent/deeplearning4j-play/.../PlayUIServer.java +
module/train/TrainModule.java (overview/model/system tabs) +
remote/RemoteReceiverModule.java. Here: a dependency-free stdlib HTTP
server with a self-contained HTML page (inline SVG charts). The server's
thread never touches a device tensor and launches nothing: it reads
records the listeners already fetched, host counters, and the CUDA
caching allocator's counters (a read of host memory that never waits on
the card nor disturbs a CUDA-graph capture on another thread) —

    GET  /            dashboard page (live-updating score chart)
    GET  /health                     -> run-health JSON (watchdog status,
                                        anomalies, recompiles, memory,
                                        flight-recorder state)
    GET  /serving                    -> serving-tier status JSON (per-model
                                        queue depth, p50/p99, shed counts,
                                        AOT bucket coverage)
    GET  /slo                        -> SLO engine verdicts: every rule's
                                        ok|warning|firing state, evaluated
                                        now (?federate=1 evaluates over the
                                        federated cluster scrape instead of
                                        the local registry)
    GET  /traces                     -> slow-trace flight ring JSON (the N
                                        slowest complete causal traces per
                                        root span; ?name= / ?trace_id=
                                        filter — see telemetry/tracectx;
                                        ?cluster=1 merges every registered
                                        member's ring onto one time-aligned
                                        timeline, ?format=chrome as trace
                                        events — telemetry/timeline)
    GET  /train/sessions             -> session ids
    GET  /train/overview?session=s   -> score curve + timing (JSON)
    GET  /train/model?session=s      -> per-param norms over time (JSON)
    GET  /train/model.html?session=s -> server-rendered model tab: per-layer
                                        norm/mean/std charts + summary table
                                        built from ui/components.py (the
                                        ui-components analog, rendered
                                        server-side instead of via dl4j-ui.js)
    POST /remote                     -> remote stats ingestion
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu training UI</title>
<style>body{font-family:sans-serif;margin:2em}svg{border:1px solid #ccc}</style>
</head><body>
<h2>Training overview</h2>
<div id="meta"></div>
<svg id="score" width="800" height="300"></svg>
<script>
async function draw(){
  const sessions = await (await fetch('/train/sessions')).json();
  if(!sessions.length){setTimeout(draw,2000);return;}
  const s = sessions[0];
  const data = await (await fetch('/train/overview?session='+s)).json();
  const pts = data.score;
  document.getElementById('meta').textContent =
      'session '+s+' — '+pts.length+' iterations';
  const svg = document.getElementById('score');
  if(!pts.length){setTimeout(draw,2000);return;}
  const xs = pts.map(p=>p[0]), ys = pts.map(p=>p[1]);
  const xmin=Math.min(...xs), xmax=Math.max(...xs);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const W=800,H=300,pad=40;
  const px=x=>pad+(x-xmin)/(xmax-xmin||1)*(W-2*pad);
  const py=y=>H-pad-(y-ymin)/(ymax-ymin||1)*(H-2*pad);
  svg.innerHTML='<polyline fill="none" stroke="steelblue" stroke-width="1.5" points="'
    +pts.map(p=>px(p[0])+','+py(p[1])).join(' ')+'"/>'
    +'<text x="10" y="20">score (min '+ymin.toFixed(4)+')</text>';
  setTimeout(draw, 2000);
}
draw();
</script></body></html>"""


class UIServer:
    """(reference: UIServer.getInstance().attach(statsStorage))"""

    _instance = None

    def __init__(self, port=0):
        self.storages = []
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _html(self, markup, code=200):
                body = markup.encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                server._count_request(url.path)
                if url.path == "/metrics":
                    # Prometheus text exposition of the process-wide
                    # telemetry registry (reference role: the system tab's
                    # numbers, now scrapeable by standard tooling).
                    # Served as OpenMetrics: exemplar suffixes on bucket
                    # lines are ONLY legal in openmetrics-text — a classic
                    # 0.0.4 parser would reject the line and drop the
                    # whole scrape the moment tracing stamped one.
                    # ?federate=1: ONE scrape for the whole cluster —
                    # local registry + every registered member's
                    # /metrics, merged under stable instance labels; a
                    # dead member is counted, never a hang
                    # (telemetry/federate.py). ?format=json returns the
                    # structured federation doc (members + scrape
                    # outcomes) instead of the exposition text.
                    from deeplearning4j_tpu_torch import telemetry
                    if q.get("federate", ["0"])[0] not in ("0", "",
                                                           "false"):
                        from deeplearning4j_tpu_torch.telemetry import (
                            federate as _fed)
                        fed = _fed.federate_default()
                        if q.get("format", [""])[0] == "json":
                            self._json(fed)
                            return
                        body = _fed.merged_to_prometheus(fed).encode()
                    else:
                        body = (telemetry.get_registry().to_prometheus()
                                .encode())
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/openmetrics-text; "
                                     "version=1.0.0; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/health":
                    # run-health snapshot: watchdog + recompiles + memory +
                    # flight-recorder state in one JSON (the "is this run
                    # sick, and why" endpoint next to the raw /metrics)
                    self._json(_health_payload())
                    return
                if url.path == "/slo":
                    # the verdict layer (telemetry/slo.py): evaluate the
                    # process-default engine's rules NOW over the local
                    # registry (?federate=1: over the federated merge of
                    # every registered member — one rule set, the whole
                    # cluster's series) and serve the per-rule
                    # ok|warning|firing states. ?history=1 first replays
                    # the process-default history store through the
                    # engine (oldest-first), so burn-rate windows are
                    # judged over retained samples a fresh process never
                    # lived through; the response carries the history
                    # dir layout for postmortem replay.
                    from deeplearning4j_tpu_torch.telemetry import slo as _slo
                    engine = _slo.get_engine()
                    history_info = None
                    if q.get("history", ["0"])[0] not in ("0", "",
                                                          "false"):
                        from deeplearning4j_tpu_torch.telemetry import (
                            history as _history)
                        store = _history.get_history()
                        replayed = store.replay_into(engine)
                        history_info = dict(store.describe(),
                                            replayed=replayed)
                    if q.get("federate", ["0"])[0] not in ("0", "",
                                                           "false"):
                        from deeplearning4j_tpu_torch.telemetry import (
                            federate as _fed)
                        out = engine.evaluate(_fed.federate_default())
                    else:
                        out = engine.evaluate()
                    if history_info is not None:
                        out["history"] = history_info
                    self._json(out)
                    return
                if url.path == "/query":
                    # the metrics-history range query
                    # (telemetry/history.py): ?series=metric{k=v,...}
                    # with optional t0/t1 bounds returns retained
                    # [t, value] points; &window=SECONDS adds the
                    # counter-aware rate_over verdict (per-series delta
                    # discipline — a reset can never fake a negative
                    # rate). No series: the store's layout/status doc.
                    from deeplearning4j_tpu_torch.telemetry import (
                        history as _history)
                    store = _history.get_history()
                    series = q.get("series", [None])[0]
                    if not series:
                        self._json(store.describe())
                        return
                    try:
                        t0 = q.get("t0", [None])[0]
                        t1 = q.get("t1", [None])[0]
                        out = {"series": series,
                               "points": store.query(
                                   series,
                                   None if t0 is None else float(t0),
                                   None if t1 is None else float(t1))}
                        window = q.get("window", [None])[0]
                        if window is not None:
                            out["window_s"] = float(window)
                            out["rate_per_s"] = store.rate_over(
                                series, float(window))
                        self._json(out)
                    except ValueError as e:
                        self._json({"error": str(e)}, code=400)
                    return
                if url.path == "/usage":
                    # the per-model/per-tenant usage ledger
                    # (serving/metering.py): rows, tokens, queue/device
                    # seconds, estimated FLOPs — the offered-load
                    # attribution elasticity keys on
                    from deeplearning4j_tpu_torch.serving import (
                        metering as _metering)
                    self._json(_metering.get_meter().usage())
                    return
                if url.path == "/serving":
                    # serving-tier status: per-model queue depth, SLO
                    # percentiles, shed counts, AOT bucket coverage — the
                    # process-default ModelRegistry (serving/registry.py)
                    from deeplearning4j_tpu_torch.serving import registry as _sreg
                    self._json(_sreg.get_model_registry().status())
                    return
                if url.path == "/fleet":
                    # fleet-tier status (fleet/): the process-default
                    # front's router counters + per-worker dispatch state
                    # + the supervisor's worker table, respawn ledger and
                    # cached per-worker /health (cross-worker
                    # aggregation). ?probe=1 re-probes every worker's
                    # /health live through the router.
                    from deeplearning4j_tpu_torch import fleet as _fleet
                    probe = q.get("probe", ["0"])[0] not in ("0", "",
                                                             "false")
                    self._json(_fleet.fleet_status(probe=probe))
                    return
                if url.path == "/traces":
                    # slow-trace flight ring (telemetry/tracectx.py): the
                    # N slowest complete causal traces per root-span name
                    # — the place a /metrics exemplar's trace_id resolves
                    # to a full submit->resolve timeline. ?name= filters
                    # one root; ?trace_id= returns a single trace doc.
                    # ?cluster=1: the time-aligned CLUSTER timeline —
                    # this process's ring merged with every registered
                    # member source on one wall clock
                    # (telemetry/timeline.py); ?format=chrome returns
                    # the chrome://tracing event form.
                    from deeplearning4j_tpu_torch.telemetry import (
                        tracectx as _tracectx)
                    if q.get("cluster", ["0"])[0] not in ("0", "",
                                                          "false"):
                        from deeplearning4j_tpu_torch.telemetry import (
                            timeline as _tl)
                        merged = _tl.cluster_snapshot()
                        if q.get("format", [""])[0] == "chrome":
                            self._json(_tl.to_chrome(merged))
                        else:
                            self._json(merged)
                        return
                    ring = _tracectx.get_ring()
                    tid = q.get("trace_id", [None])[0]
                    if tid:
                        doc = ring.find(tid)
                        if doc is None:
                            self._json({"error": f"no trace {tid!r} in "
                                        "the ring"}, code=404)
                        else:
                            self._json(doc)
                        return
                    name = q.get("name", [None])[0]
                    self._json({"traces": ring.snapshot(name)})
                    return
                if url.path in ("/", "/train", "/train/overview.html"):
                    self._html(_PAGE)
                    return
                if url.path == "/train/sessions":
                    out = sorted({s for st in server.storages for s in st.sessions()})
                    self._json(out)
                    return
                if url.path == "/train/overview":
                    session = q.get("session", ["default"])[0]
                    recs = server._records(session, "stats")
                    recs = [r for r in recs if "iteration" in r]
                    self._json({
                        "score": [[r["iteration"], r["score"]] for r in recs
                                  if "score" in r],
                        "iter_time_s": [[r["iteration"], r.get("iter_time_s", 0)]
                                        for r in recs],
                        "etl_time_s": [[r["iteration"], r.get("etl_time_s", 0)]
                                       for r in recs]})
                    return
                if url.path == "/train/model.html":
                    session = q.get("session", ["default"])[0]
                    self._html(_model_page(server, session))
                    return
                if url.path == "/train/model":
                    session = q.get("session", ["default"])[0]
                    recs = server._records(session, "stats")
                    series, _ = _param_series(recs)
                    self._json({k: [list(p) for p in v]
                                for k, v in series.items()})
                    return
                if url.path == "/train/system":
                    session = q.get("session", ["default"])[0]
                    self._json(_system_series(server, session))
                    return
                if url.path == "/train/system.html":
                    session = q.get("session", ["default"])[0]
                    self._html(_system_page(server, session))
                    return
                self.send_error(404)

            def do_POST(self):
                if urlparse(self.path).path != "/remote":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    rec = json.loads(self.rfile.read(length))
                except (ValueError, UnicodeDecodeError):
                    self._json({"ok": False, "error": "invalid JSON body"}, code=400)
                    return
                if not isinstance(rec, dict):
                    self._json({"ok": False, "error": "record must be a JSON object"},
                               code=400)
                    return
                if rec.get("type") == "stats" and (
                        not isinstance(rec.get("iteration"), (int, float))
                        or not isinstance(rec.get("score"), (int, float))):
                    self._json({"ok": False,
                                "error": "stats record requires numeric "
                                         "'iteration' and 'score'"}, code=400)
                    return
                server._remote_storage().put_record(rec)
                self._json({"ok": True})

        self._httpd = HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = None
        self._remote = None
        self._request_counter = None

    @classmethod
    def get_instance(cls, port=0):
        if cls._instance is None:
            cls._instance = cls(port=port).start()
        return cls._instance

    _KNOWN_PATHS = frozenset((
        "/", "/metrics", "/health", "/serving", "/fleet", "/traces",
        "/slo", "/query", "/usage",
        "/train",
        "/train/overview.html",
        "/train/sessions", "/train/overview", "/train/model",
        "/train/model.html", "/train/system", "/train/system.html",
        "/remote"))

    def _count_request(self, path):
        try:
            counter = self._request_counter
            if counter is None:
                from deeplearning4j_tpu_torch import telemetry
                counter = self._request_counter = \
                    telemetry.get_registry().counter(
                        "ui_requests_total", "UI server requests by path")
            # bucket unknown paths: a port scanner hitting random URLs must
            # not mint unbounded label series in the process-wide registry
            counter.inc(path=path if path in self._KNOWN_PATHS else "other")
        except Exception:  # metrics must never break a page load
            pass

    def _remote_storage(self):
        if self._remote is None:
            from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
            self._remote = InMemoryStatsStorage()
            self.storages.append(self._remote)
        return self._remote

    def _records(self, session, type_):
        out = []
        for st in self.storages:
            out.extend(r for r in st.get_records(session=session, type_=type_)
                       if isinstance(r, dict))
        out.sort(key=lambda r: r.get("iteration", 0))
        return out

    def attach(self, storage):
        self.storages.append(storage)
        return self

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        if UIServer._instance is self:
            UIServer._instance = None


def _health_payload():
    """The /health JSON: overall status + last anomalies + the signals that
    justify it. Status ladder: ``sick`` when the numerics watchdog has seen
    anomalies, ``warn`` on a recompile storm (any site past
    devices.RECOMPILE_STORM_THRESHOLD), else ``ok``."""
    from deeplearning4j_tpu_torch.telemetry import devices as _devices
    from deeplearning4j_tpu_torch.telemetry import flight as _flight
    from deeplearning4j_tpu_torch.telemetry import goodput as _goodput
    from deeplearning4j_tpu_torch.telemetry import health as _tm_health
    from deeplearning4j_tpu_torch.utils import compile_cache as _cc

    watchdog = _tm_health.get_monitor().summary()
    recompiles = _devices.recompile_counts()
    status = "ok"
    if any(v >= _devices.RECOMPILE_STORM_THRESHOLD
           for v in recompiles.values()):
        status = "warn"
    if watchdog["nonfinite_steps"] or watchdog["anomalies"]:
        status = "sick"
    rec = _flight.get_recorder()
    ring = rec.snapshot()
    from deeplearning4j_tpu_torch import telemetry as _reg_mod
    g_hosts = _reg_mod.get_registry().get("distributed_hosts_alive")
    return {"status": status,
            "watchdog": watchdog,
            "recompiles": recompiles,
            # elastic multi-host training (hostfleet tier): how many
            # training hosts the supervisor currently believes are alive
            # (None when no supervisor runs in this process)
            "distributed": {"hosts_alive": (None if g_hosts is None
                                            else g_hosts.value())},
            "memory": _memory_summary(),
            # the memory ledger of the training job's persistent trees
            # (per_device vs logical bytes = the realized 1/N of a
            # ZeRO-1/FSDP layout) PLUS the per-site step_peak_bytes
            # ledger (ParallelTrainer.step_memory_analysis): the
            # WITHIN-step number the steady-state gauges cannot see
            "train_memory": _devices.train_memory_summary(),
            # the cold-start tax, realized: persistent-cache dir, warm-
            # manifest hit/miss counts, time-to-first-step/request gauges
            "compile_cache": _cc.status(),
            # the wall-clock goodput ledger (telemetry/goodput.py):
            # where this run's seconds went — {"active": False} until a
            # fit loop opens the window
            "goodput": _goodput.get_ledger().snapshot(),
            "flight": {"records": len(ring),
                       "last_step": ring[-1].get("step") if ring else None,
                       "dumps": list(rec.dumps)}}


def _memory_summary():
    """``telemetry.devices.memory_summary``'s keys from the caching
    allocator's counters alone: the limit is the card's total memory from
    its cached properties, never a driver query, so a poll from this
    thread cannot wait on (or disturb) the training thread's work."""
    import torch

    out = {"devices": {}, "live_array_bytes": 0}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        if not torch.cuda.is_initialized():
            break
        stats = torch.cuda.memory_stats(i)
        used = int(stats.get("allocated_bytes.all.current", 0))
        out["devices"][f"cuda:{i}"] = {
            "bytes_in_use": used,
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0))}
        out["live_array_bytes"] += used
    return out


def _param_series(recs):
    """{param_name: [(iteration, l2, mean, std)]} + latest histogram per
    param — shared by the /train/model JSON tab and the HTML model tab."""
    series, hists = {}, {}
    for r in recs:
        if "iteration" not in r:
            continue
        for name, st in (r.get("params") or {}).items():
            if not (isinstance(st, dict) and {"l2", "mean", "std"} <= st.keys()):
                continue
            vals = (st["l2"], st["mean"], st["std"])
            if not all(isinstance(v, (int, float)) for v in vals):
                continue  # a bad /remote record must not poison the page
            series.setdefault(name, []).append((r["iteration"],) + vals)
            h = st.get("hist")
            if (isinstance(h, dict) and isinstance(h.get("counts"), list)
                    and h["counts"]
                    and all(isinstance(c, (int, float)) for c in h["counts"])
                    and isinstance(h.get("min", 0.0), (int, float))
                    and isinstance(h.get("max", 1.0), (int, float))):
                hists[name] = h
    return series, hists


def _model_page(server, session):
    """Server-rendered model tab (reference: TrainModule.java model tab),
    composed from ui/components.py."""
    import html as _html

    from deeplearning4j_tpu_torch.ui.components import (
        ChartHistogram, ChartLine, ComponentTable, ComponentText,
        DecoratorAccordion)

    recs = [r for r in server._records(session, "stats") if "iteration" in r]
    parts = ["<!DOCTYPE html><html><head>"
             "<title>model — deeplearning4j_tpu</title></head>"
             '<body style="font-family:sans-serif;margin:2em">',
             f"<h2>Model: session {_html.escape(session)}</h2>"]
    if not recs:
        parts.append(ComponentText("no stats records yet").render_html())
        parts.append("</body></html>")
        return "".join(parts)

    # score curve
    pts = [(r["iteration"], r["score"]) for r in recs
           if isinstance(r.get("score"), (int, float))]
    if pts:
        parts.append(ChartLine("score vs iteration",
                               [("score", [p[0] for p in pts],
                                 [p[1] for p in pts])]).render_svg())

    series, hists = _param_series(recs)
    rows = []
    for name, spts in sorted(series.items()):
        it = [p[0] for p in spts]
        comps = [ChartLine(f"{name}: parameter L2 norm",
                           [("l2", it, [p[1] for p in spts])]).render_svg(),
                 ChartLine(f"{name}: mean ± std",
                           [("mean", it, [p[2] for p in spts]),
                            ("std", it, [p[3] for p in spts])]).render_svg()]
        hist = hists.get(name)
        if hist:
            counts = hist["counts"]
            lo, hi = hist.get("min", 0.0), hist.get("max", 1.0)
            step = (hi - lo) / max(len(counts), 1)
            bins = [(lo + i * step, lo + (i + 1) * step, c)
                    for i, c in enumerate(counts)]
            comps.append(ChartHistogram(
                f"{name}: latest weight distribution", bins).render_svg())
        parts.append(DecoratorAccordion(
            name, [_Raw(c) for c in comps],
            default_collapsed=True).render_html())
        last = spts[-1]
        rows.append([name, f"{last[1]:.4g}", f"{last[2]:.4g}",
                     f"{last[3]:.4g}"])
    if rows:
        parts.append("<h3>Latest parameter stats</h3>")
        parts.append(ComponentTable(["parameter", "l2", "mean", "std"],
                                    rows).render_html())
    parts.append("</body></html>")
    return "".join(parts)


def _system_series(server, session):
    """Memory/timing series + hardware info for the system tab. On
    multi-host runs (workers POST via the remote router with a "process"
    tag) the per-process series are additionally split out under
    ``processes`` — the reference TrainModule's machine-selector role; the
    flat series keep process 0 so single-host dashboards are unchanged."""
    recs = [r for r in server._records(session, "stats") if "iteration" in r]
    inits = server._records(session, "init")
    out = {"hardware": (inits[-1].get("hardware", {}) if inits else {}),
           "host_rss_mb": [], "device_bytes_in_use": [], "iter_time_s": []}
    per_proc = {}
    for r in recs:
        it = r["iteration"]
        sysd = r.get("system", {})
        pp = per_proc.setdefault(int(r.get("process", 0)),
                                 {"host_rss_mb": [],
                                  "device_bytes_in_use": [],
                                  "iter_time_s": []})
        if "host_rss_mb" in sysd:
            pp["host_rss_mb"].append([it, sysd["host_rss_mb"]])
        if "device_bytes_in_use" in sysd:
            pp["device_bytes_in_use"].append(
                [it, sysd["device_bytes_in_use"]])
        if "iter_time_s" in r:
            pp["iter_time_s"].append([it, r["iter_time_s"]])
    if per_proc:
        # flat series = lowest process present (NOT hardcoded 0: a run
        # whose only listener lives on a non-zero worker still renders)
        out.update(per_proc[min(per_proc)])
    if len(per_proc) > 1:
        out["processes"] = {str(k): v for k, v in sorted(per_proc.items())}
    return out


def _system_page(server, session):
    """Server-rendered system tab (reference: TrainModule.java system tab —
    memory utilization + hardware/software info)."""
    import html as _html

    from deeplearning4j_tpu_torch.ui.components import (ChartLine, ComponentTable,
                                                  ComponentText)

    data = _system_series(server, session)
    parts = ["<!DOCTYPE html><html><head>"
             "<title>system — deeplearning4j_tpu</title></head>"
             '<body style="font-family:sans-serif;margin:2em">',
             f"<h2>System: session {_html.escape(session)}</h2>"]
    hw = data["hardware"]
    if hw:
        parts.append(ComponentTable(
            ["property", "value"],
            [[k, str(v)] for k, v in sorted(hw.items())]).render_html())
    plotted = False
    for key, title in (("host_rss_mb", "host RSS (MB)"),
                       ("device_bytes_in_use", "device HBM in use (bytes)"),
                       ("iter_time_s", "iteration time (s)")):
        pts = data[key]
        if pts:
            parts.append(ChartLine(title, [(key, [p[0] for p in pts],
                                            [p[1] for p in pts])]).render_svg())
            plotted = True
    if not plotted and not hw:
        parts.append(ComponentText("no system records yet").render_html())
    parts.append("</body></html>")
    return "".join(parts)


class _Raw:
    """Adapter letting pre-rendered SVG strings sit inside components."""

    component_type = "raw-markup"

    def __init__(self, markup):
        self.markup = markup

    def render_html(self):
        return self.markup

    def to_dict(self):
        return {"componentType": self.component_type, "markup": self.markup}
