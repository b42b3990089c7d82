"""The port's telemetry core (``deeplearning4j_tpu_torch/telemetry/``,
``utils/profiling.py``) against the JAX package's modules, on the CPU.

Each ported module gets the same operations as the JAX module and must
give the same output: the registry's Prometheus text and JSONL (apart from
timestamps), the tracer's Chrome events (apart from times), the trace
contexts' parenting across threads and the slowest-N ring, the flight
recorder's ring, dump and SIGTERM dump, the timeline's merge, Chrome view
and clock offset, and the profile tables' merge and ranking. Then the
wiring: the same tiny MultiLayerNetwork and ComputationGraph fit in both
packages with telemetry on gives the same train series, histogram counts
and iteration counter, and scores equal within f32; a burst of requests on
the port's serving engine counts and traces every request; a
``profile_round`` window brackets exactly one round in a ``torch.profiler``
trace.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from deeplearning4j_tpu import telemetry as JT
from deeplearning4j_tpu.telemetry import flight as JF
from deeplearning4j_tpu.telemetry import registry as JR
from deeplearning4j_tpu.telemetry import timeline as JTL
from deeplearning4j_tpu.telemetry import tracectx as JC
from deeplearning4j_tpu.utils import profiling as JP
from deeplearning4j_tpu_torch import telemetry as TT
from deeplearning4j_tpu_torch.telemetry import flight as TF
from deeplearning4j_tpu_torch.telemetry import registry as TR
from deeplearning4j_tpu_torch.telemetry import timeline as TTL
from deeplearning4j_tpu_torch.telemetry import tracectx as TC
from deeplearning4j_tpu_torch.utils import profiling as TP

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN_SERIES = ("train_step_seconds", "train_etl_seconds", "train_iterations_total",
                "train_score")


@pytest.fixture(autouse=True)
def _isolate():
    for t in (JT, TT):
        t.reset()
        t.disable()
    yield
    for t in (JT, TT):
        t.reset()
        t.disable()


def _record(reg):
    """The same operations on either package's registry."""
    c = reg.counter("requests_total", "requests by outcome")
    g = reg.gauge("queue_depth", "pending requests")
    h = reg.histogram("latency_seconds", "request latency", buckets=(0.01, 0.1, 1.0))
    for i in range(7):
        c.inc(outcome="ok" if i % 3 else "error")
        h.observe(0.003 * (i + 1) ** 2, model="m")
    c.inc(2.5, outcome="ok")
    g.set(4.0)
    g.inc(2.0)
    g.dec(1.0)
    return reg


def _no_time(text):
    return re.sub(r'"(ts|time|t|unix_s|wall_s)": [0-9.e+-]+', r'"\1": 0', text)


def test_registry_exports_match_jax():
    j = _record(JR.MetricsRegistry(enabled=True))
    t = _record(TR.MetricsRegistry(enabled=True))
    assert t.to_prometheus() == j.to_prometheus()
    assert t.names() == j.names()
    assert _no_time(t.to_jsonl()) == _no_time(j.to_jsonl())
    assert t.get("latency_seconds").percentile(0.5, model="m") == pytest.approx(
        j.get("latency_seconds").percentile(0.5, model="m"))


def test_disabled_registry_records_nothing():
    reg = _record(TR.MetricsRegistry(enabled=False))
    assert reg.get("requests_total").labelsets() == []


def _spans(doc):
    out = {}
    for s in doc["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _handoff(C, T):
    """A trace started here, a span recorded on another thread under the
    handoff, a span here; the finished trace's (name, parent name) pairs."""
    T.enable()
    ctx = C.start_trace("serving.request", model="m")
    token = ctx.handoff()

    def drain():
        with C.attach(token):
            with T.span("queue_wait"):
                pass

    th = threading.Thread(target=drain, name="drain-thread", daemon=True)
    th.start()
    th.join()
    with C.attach(ctx):
        with T.span("resolve"):
            pass
    assert ctx.finish() and not ctx.finish()
    doc = C.get_ring().find(ctx.trace_id)
    by = _spans(doc)
    names = {s["span_id"]: s["name"] for s in doc["spans"]}
    assert by["queue_wait"][0]["thread"] == "drain-thread"
    assert C.open_trace_count() == 0
    return sorted((s["name"], names.get(s["parent_id"])) for s in doc["spans"])


def test_tracectx_handoff_across_threads_matches_jax():
    assert _handoff(TC, TT) == _handoff(JC, JT) == [
        ("queue_wait", "serving.request"), ("resolve", "serving.request"),
        ("serving.request", None)]


def _ring(Ring):
    ring = Ring(per_name=3)
    out = []
    for tid, dur in (("a", 1.0), ("b", 3.0), ("c", 2.0), ("d", 0.5), ("e", 2.5)):
        out.append(ring.offer({"name": "r", "trace_id": tid, "duration_s": dur, "status": "ok",
                               "spans": []}))
    return out, [d["trace_id"] for d in ring.snapshot()["r"]]


def test_slow_trace_ring_matches_jax():
    assert _ring(TC.SlowTraceRing) == _ring(JC.SlowTraceRing) == (
        [True, True, True, False, True], ["b", "e", "c"])


def _chrome(T):
    T.enable()
    with T.span("fit", net="MultiLayerNetwork"):
        with T.span("fit.step", iteration=0):
            pass
        with T.span("fit.step", iteration=1) as s:
            s.set(fused_k=4)
    T.get_tracer().add_instant("marker", {"k": 1})
    evs = T.get_tracer().chrome_trace()["traceEvents"]
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")} for e in evs]


def test_tracing_chrome_export_matches_jax(tmp_path):
    got = _chrome(TT)
    assert got == _chrome(JT)
    assert [e["name"] for e in got] == ["fit.step", "fit.step", "fit", "marker"]
    path = TT.get_tracer().export(str(tmp_path / "t.json"))
    assert json.load(open(path))["traceEvents"][0]["ph"] == "X"


def test_span_forwards_to_torch_profiler_only_while_it_collects():
    import torch
    from torch.profiler import profile
    TT.enable()
    with TT.span("outside"):
        pass
    with profile() as prof:
        with TT.span("inside"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert "inside" in names and "outside" not in names


def test_flight_ring_and_dump_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    docs = []
    for F in (JF, TF):
        rec = F.FlightRecorder(capacity=4)
        for i in range(6):
            rec.note(step=i, score=0.5 * i, t=float(i))
        rec.annotate(4, grad_norm=2.0)
        rec.annotate(9, loss_nonfinite=True)  # an evicted step: a new record
        path = rec.dump("numerics:nonfinite", extra={"anomaly": {"step": 9}})
        doc = json.load(open(path))
        for k in ("pid", "dumped_at", "clock"):
            doc.pop(k, None)
        for r in doc["records"]:
            r.pop("t")
        docs.append(doc)
        assert rec.dumps == [path]
        assert F.FlightRecorder().dump("empty") is None
    assert docs[0] == docs[1]
    assert [r["step"] for r in docs[1]["records"]] == [3, 4, 5, 9]


def test_sigterm_dumps_the_ring_then_dies_default(tmp_path):
    env = dict(os.environ, DL4J_TPU_FLIGHT_DIR=str(tmp_path))
    p = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_flight_sigterm_worker.py"),
                          "7"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=HERE)
    try:
        doc = json.loads(p.stdout.readline())
        assert doc["ready"] and doc["installed"]
        os.kill(p.pid, signal.SIGTERM)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
        p.stdout.close()
        p.stderr.close()
    assert p.returncode == -signal.SIGTERM
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("dl4j_tpu_flight_")]
    assert len(dumps) == 1
    dump = json.load(open(tmp_path / dumps[0]))
    assert dump["reason"] == "signal:SIGTERM" and dump["n_records"] == 7
    assert [r["step"] for r in dump["records"]] == list(range(7))


def _rings():
    span = lambda n, t0, d: {"name": n, "span_id": 1, "parent_id": None, "t0_unix": t0,
                              "dur_s": d, "thread": "main", "args": {}}
    doc = lambda tid, t0: {"name": "train.step", "trace_id": tid, "t0_unix": t0, "dur_s": 0.5,
                           "status": "ok", "spans": [span("train.step", t0, 0.5)]}
    return ({"train.step": [doc("a", 100.0)]}, {"train.step": [doc("b", 100.2)]})


def test_timeline_merge_chrome_and_offset_match_jax():
    outs = []
    for TL in (JTL, TTL):
        r0, r1 = _rings()
        merged = TL.merge([TL.source("rank0", r0), TL.source("rank1", r1, clock_offset_s=0.1)])
        outs.append((json.dumps(merged, sort_keys=True, default=str),
                     json.dumps(TL.to_chrome(merged), sort_keys=True, default=str),
                     TL.estimate_offset(1000.5, 1000.0, 1000.2)))
    assert outs[0] == outs[1]


def _rows():
    return [{"total_self_us": 5.0, "occurrences": 2, "category": "kernel", "bound_by": None,
             "expression": "flash_attn"},
            {"total_self_us": 9.0, "occurrences": 1, "category": "kernel", "bound_by": None,
             "expression": "gemm"},
            {"total_self_us": 7.0, "occurrences": 3, "category": "kernel", "bound_by": None,
             "expression": "flash_attn"},
            {"total_self_us": 1.0, "occurrences": 1, "category": "kernel", "bound_by": None,
             "expression": None}]


def test_profile_tables_merge_and_rank_as_jax():
    for k in (None, 2):
        assert TP.rank_ops(TP.merge_rows(_rows()), k) == JP.rank_ops(JP.merge_rows(_rows()), k)
    ranked = TP.rank_ops(TP.merge_rows(_rows()))
    assert [r["expression"] for r in ranked] == ["flash_attn", "gemm", None]
    assert TP.format_rows(ranked) == JP.format_rows(ranked)


def test_top_ops_reads_a_chrome_trace(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "flash_attn", "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "flash_attn", "dur": 6.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 2.0}]}
    (tmp_path / "trace.json").write_text(json.dumps(doc))
    rows = TP.top_ops(tmp_path)
    assert [(r["expression"], r["total_self_us"], r["occurrences"]) for r in rows] == [
        ("flash_attn", 10.0, 2), ("Memcpy HtoD", 2.0, 1)]


def test_launches_without_device_events_are_counted_and_warned_of(tmp_path):
    def launch(name, ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 3.0,
                "args": {"correlation": corr}}

    def kernel(ts, corr):
        return {"ph": "X", "cat": "kernel", "name": "flash_attn", "ts": ts, "dur": 5.0,
                "args": {"correlation": corr}}

    doc = {"traceEvents": [
        launch("cudaLaunchKernel", 100.0, 1), kernel(107.0, 1),
        launch("cuLaunchKernelEx", 200.0, 2), kernel(190.0, 2),
        launch("cuLaunchKernelEx", 300.0, 3),
        launch("cudaMemcpyAsync", 400.0, 4)]}
    check = TP.launch_check(doc)
    assert check == {"launches": 3, "device_events": 2, "missing": 1,
                     "missing_by_call": {"cuLaunchKernelEx": 1}, "missing_ts": [300.0],
                     "lag_us": {"min": -10.0, "median": -1.5, "max": 7.0}}
    (tmp_path / "trace.json").write_text(json.dumps(doc))
    with pytest.warns(RuntimeWarning, match="1 of 3 launches"):
        rows = TP.top_ops(tmp_path)
    assert [(r["expression"], r["occurrences"]) for r in rows] == [("flash_attn", 2)]
    doc["traceEvents"] = doc["traceEvents"][:4]
    assert TP.launch_check(doc)["missing"] == 0


# ---------------------------------------------------------------------------
# the wiring
# ---------------------------------------------------------------------------

STEPS = 5


def _mln(L, U, I, NNC):
    return NNC(seed=3, updater=U.Sgd(learning_rate=0.1)).list(
        L.DenseLayer(n_out=8, activation="tanh"), L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(4))


def _graph(L, U, I, GB):
    b = GB(updater=U.Sgd(learning_rate=0.1), seed=3)
    b.add_inputs("in")
    b.set_input_types(I.FeedForwardType(4))
    b.add_layer("d", L.DenseLayer(n_out=8, activation="tanh"), "in")
    b.add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "d")
    b.set_outputs("out")
    return b.build()


def _data():
    rs = np.random.RandomState(1)
    return (rs.randn(4 * STEPS, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4 * STEPS)])


def _train_series(T):
    reg = T.get_registry()
    out = {}
    for name in TRAIN_SERIES:
        v = reg.get(name).snapshot()["series"][0]["value"]
        out[name] = v["count"] if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_records_the_jax_series(kind):
    """The same fit in both packages, telemetry on: one step histogram
    observation, etl observation and iteration a step, the score gauge the
    last loss, one fit span and a fit.step span a step."""
    from deeplearning4j_tpu.nn import layers as JL
    from deeplearning4j_tpu.nn import updaters as JU
    from deeplearning4j_tpu.nn.conf import inputs as JI
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNNC
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JG
    from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import serialization as ser

    x, y = _data()
    if kind == "mln":
        j = JNet(_mln(JL, JU, JI, JNNC))
        t = MultiLayerNetwork(_mln(L, U, I, NeuralNetConfig), device="cpu")
    else:
        j = JG(_graph(JL, JU, JI, JGB))
        t = ComputationGraph(_graph(L, U, I, GraphBuilder), device="cpu")
    j.init()
    t.init()
    ser.params_from_numpy(t, j.params)
    for T, net in ((JT, j), (TT, t)):
        T.enable()
        net.fit(x, y, batch_size=4)
    got, want = _train_series(TT), _train_series(JT)
    assert got["train_step_seconds"] == want["train_step_seconds"] == STEPS
    assert got["train_etl_seconds"] == want["train_etl_seconds"] == STEPS
    assert got["train_iterations_total"] == want["train_iterations_total"] == STEPS
    np.testing.assert_allclose(got["train_score"], want["train_score"], rtol=1e-5)
    np.testing.assert_allclose(got["train_score"], t.score_history[-1], rtol=0)
    events = [e["name"] for e in TT.get_tracer().chrome_trace()["traceEvents"]]
    assert events.count("fit") == 1 and events.count("fit.step") == STEPS
    assert [r["step"] for r in TF.get_recorder().snapshot()] == list(range(STEPS))


def test_fit_with_telemetry_off_records_nothing():
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    x, y = _data()
    net = MultiLayerNetwork(_mln(L, U, I, NeuralNetConfig), device="cpu")
    net.fit(x, y, batch_size=4)
    assert TT.get_registry().get("train_step_seconds").labelsets() == []
    assert TT.get_tracer().chrome_trace()["traceEvents"] == []
    assert TF.get_recorder().snapshot() == []


def test_serving_burst_counts_and_traces_every_request():
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    m = 24
    TT.enable()
    net = MultiLayerNetwork(_mln(L, U, I, NeuralNetConfig), device="cpu")
    net.init()
    eng = ServingEngine(net, name="mlp", input_spec=(4,), max_batch_size=8, max_queue=64,
                        device="cpu").start()
    try:
        xs = np.random.RandomState(0).randn(m, 4).astype(np.float32)
        futs = [eng.submit(x) for x in xs]
        outs = [f.get(timeout=30) for f in futs]
    finally:
        eng.stop()
    assert len(outs) == m and all(f.trace_id for f in futs)
    reg = TT.get_registry()
    assert reg.get("serving_model_requests_total").value(model="mlp", outcome="served") == m
    assert reg.get("serving_model_requests_total").value(model="mlp", outcome="submitted") == m
    assert reg.get("serving_model_latency_seconds").count(model="mlp") == m
    assert reg.get("serving_batch_fill_ratio").count() >= 1
    ring = TC.get_ring()
    done = [d for d in ring.snapshot().get("serving.request", [])]
    assert all(d["status"] == "ok" for d in done)
    assert len({f.trace_id for f in futs if ring.find(f.trace_id) is not None}) == min(
        m, ring.per_name)
    assert TC.open_trace_count() == 0


def test_profile_round_brackets_exactly_one_round(tmp_path):
    from deeplearning4j_tpu_torch.continuous.driver import StepDriver
    from deeplearning4j_tpu_torch.datasets.iterator import iter_batches
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.telemetry import profiling as TPR
    TT.enable()
    x, y = _data()
    net = MultiLayerNetwork(_mln(L, U, I, NeuralNetConfig), device="cpu")
    drv = StepDriver(net, lambda: iter_batches(x, y, 4, None))
    sched = drv.profile_round(2, str(tmp_path / "prof"), force=True)
    assert drv.run_round(2).dispatches == 2 and sched.armed  # round 1: not profiled
    assert not (tmp_path / "prof").exists()
    assert drv.run_round(2).dispatches == 2                   # round 2: profiled
    assert not sched.armed and sched.captured == [str(tmp_path / "prof")]
    drv.run_round(1)                                          # round 3: not profiled
    drv.sync()
    drv.close_source()
    doc = json.load(open(tmp_path / "prof" / TPR.TRACE_NAME))
    # the profiled round's two dispatches, as record_function ranges
    steps = [e for e in doc["traceEvents"] if e.get("name") == "fit.step"]
    assert len(steps) == 2
    assert not TPR.profiling_available(force=False)  # no card: a no-op unless forced
