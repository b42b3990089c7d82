"""The port's SLO engine, goodput ledger and metrics federation
(``deeplearning4j_tpu_torch/telemetry/slo.py``, ``goodput.py``,
``federate.py``) against the JAX package's modules, on the CPU.

Each scenario feeds the same metric snapshots (built from a seed with
numpy) and the same injected clock to both packages and asks for the same
answers: every rule's state and value at every ``evaluate`` (rate, ratio,
threshold, burn rate, EWMA drift, dead members and counter resets, the
default rules over random traffic), the counted transitions, the flight
dump's ``"slo"`` section; the goodput block for the same histogram deltas
and clock, ``device_peak_flops()`` (None on the CPU in both); federation's
merge, instance labels and dead member, and the SLO engine over a merge
with a dead member. Then the wiring: a port ``StepDriver`` fit opens the
ledger, whose categories sum to its window, and ``checkpoint`` notes its
seconds; ``resnet50_flops_per_example`` is the JAX package's.
"""

import json
import socket
import time

import numpy as np
import pytest

from deeplearning4j_tpu import telemetry as JT
from deeplearning4j_tpu.models.resnet import resnet50_flops_per_example as j_rn50_flops
from deeplearning4j_tpu.telemetry import federate as JF
from deeplearning4j_tpu.telemetry import flight as JFL
from deeplearning4j_tpu.telemetry import goodput as JG
from deeplearning4j_tpu.telemetry import slo as JS
from deeplearning4j_tpu_torch import telemetry as TT
from deeplearning4j_tpu_torch.models import resnet50_flops_per_example as t_rn50_flops
from deeplearning4j_tpu_torch.telemetry import federate as TF
from deeplearning4j_tpu_torch.telemetry import flight as TFL
from deeplearning4j_tpu_torch.telemetry import goodput as TG
from deeplearning4j_tpu_torch.telemetry import slo as TS

PKGS = ((JT, JS), (TT, TS))


@pytest.fixture(autouse=True)
def _isolate():
    for t in (JT, TT):
        t.reset()
        t.disable()
    yield
    for t in (JT, TT):
        t.reset()
        t.disable()


def _doc(series_by_metric, kind="counter"):
    """{metric: [(labels dict, value), ...]} -> a registry-snapshot doc."""
    return {name: {"kind": kind, "help": "",
                   "series": [{"labels": dict(lbl), "value": v} for lbl, v in series]}
            for name, series in series_by_metric.items()}


def _hdoc(name, total, count):
    return {name: {"kind": "histogram", "help": "", "series": [
        {"labels": {}, "value": {"buckets": {}, "sum": total, "count": count}}]}}


def _rules(S):
    """One rule of each kind, built from either package's module."""
    return [
        S.SloRule("errs", "rate", "errors_total", fire=1.0, warn=0.5, window_s=60.0),
        S.SloRule("shed", "ratio", "shed_total", den_metric="req_total", fire=0.2, warn=0.05,
                  window_s=120.0, min_den=10.0),
        S.SloRule("depth_high", "threshold", "queue_depth", fire=5.0, warn=3.0),
        S.SloRule("workers_low", "threshold", "workers_alive", fire=1.0, op="lt"),
        S.SloRule("burn", "burn_rate", "drops_total", fire=1.0, short_window_s=60.0,
                  long_window_s=600.0),
        S.SloRule("step_drift", "ewma_drift", "step_seconds", fire=1.5, warn=1.25,
                  min_intervals=5),
    ]


def _random_docs(seed, n=40):
    """A sampled history of every rule's metrics from numpy draws: counters
    that grow in bursts, on two members, one of which vanishes, rejoins
    with its lifetime total and restarts from zero; gauges that wander;
    a step-time histogram whose mean creeps up halfway through."""
    rs = np.random.RandomState(seed)
    errs = {"a": 0.0, "b": 0.0}
    shed = req = drops = 0.0
    h_sum, h_count = 0.0, 0
    docs = []
    for i in range(n):
        for m in errs:
            errs[m] += float(rs.randint(0, 3) * rs.randint(0, 2) * 40)
        if i == n // 2:
            errs["b"] = 0.0  # a restart: the counter resets
        req += float(rs.randint(0, 30))
        shed += float(rs.binomial(int(rs.randint(0, 30)), 0.3))
        drops += float(rs.randint(0, 4) * 30) if i > n // 3 else 0.0
        k = int(rs.randint(1, 6))
        h_count += k
        h_sum += k * (0.01 if i < n // 2 else 0.03) * (1 + 0.1 * rs.rand())
        members = [("a", errs["a"])] + ([] if n // 4 <= i < n // 3 else [("b", errs["b"])])
        doc = _doc({"errors_total": [({"instance": m}, v) for m, v in members],
                    "shed_total": [({}, shed)], "req_total": [({}, req)],
                    "drops_total": [({}, drops)]})
        doc.update(_doc({"queue_depth": [({}, float(rs.randint(0, 8)))],
                         "workers_alive": [({}, float(rs.randint(0, 4)))]}, kind="gauge"))
        doc.update(_hdoc("step_seconds", h_sum, h_count))
        docs.append((30.0 * i, doc))
    return docs


def _replay(S, rules, docs):
    eng = S.SloEngine(rules=rules)
    return [eng.evaluate(doc, now=t) for t, doc in docs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_states_match_jax_at_every_evaluate(seed):
    """Every rule's state, value and since, the firing and warning lists,
    at every one of 40 evaluations, and the counted transitions."""
    for t, _ in PKGS:
        t.enable()
    docs = _random_docs(seed)
    want = _replay(JS, _rules(JS), docs)
    got = _replay(TS, _rules(TS), docs)
    assert got == want
    assert {r["state"] for st in got for r in st["rules"]} >= {"ok", "firing"}
    assert TT.series_map("slo_alerts_total") == JT.series_map("slo_alerts_total")
    assert TT.series_map("slo_rule_state") == JT.series_map("slo_rule_state")


def test_burn_rate_spike_holds_sustained_burn_fires_as_jax():
    docs = [(30.0 * i, _doc({"drops_total": [({}, 0.0)]})) for i in range(21)]
    docs.append((630.0, _doc({"drops_total": [({}, 100.0)]})))
    docs += [(630.0 + 30.0 * i, _doc({"drops_total": [({}, 100.0 + 100.0 * i)]}))
             for i in range(1, 11)]
    rules = {S: [S.SloRule("burn", "burn_rate", "drops_total", fire=1.0)] for _, S in PKGS}
    want, got = _replay(JS, rules[JS], docs), _replay(TS, rules[TS], docs)
    assert got == want
    assert got[21]["rules"][0]["state"] == "ok" and got[-1]["firing"] == ["burn"]


def test_dead_member_and_reset_never_fire_or_mask():
    def doc(a, b=None):
        return _doc({"errors_total": [({"instance": "a"}, a)]
                     + ([] if b is None else [({"instance": "b"}, b)])})
    docs = [(0.0, doc(100, 50)), (30.0, doc(100)), (60.0, doc(100, 5000)),
            (90.0, doc(500, 5000)), (150.0, doc(20, 5000))]
    states = {}
    for _, S in PKGS:
        eng = S.SloEngine(rules=[S.SloRule("errs", "rate", "errors_total", fire=1.0,
                                           window_s=60.0)])
        states[S] = [eng.evaluate(d, now=t)["rules"][0]["state"] for t, d in docs]
    assert states[TS] == states[JS] == ["ok", "ok", "ok", "firing", "ok"]


def test_default_rules_match_jax_and_stay_silent_on_a_healthy_process():
    assert [r.describe() for r in TS.default_rules()] == [r.describe() for r in JS.default_rules()]
    TT.enable()
    eng = TS.SloEngine()
    for i in range(3):
        st = eng.evaluate(now=30.0 * i)
    assert st["firing"] == [] and st["warning"] == []
    assert TT.series_map("slo_alerts_total") == {}


def test_rule_and_engine_refusals():
    r = TS.SloRule("x", "rate", "m_total", fire=1.0)
    with pytest.raises(ValueError):
        TS.SloEngine(rules=[r, TS.SloRule("x", "rate", "n_total", fire=1.0)])
    with pytest.raises(ValueError):
        TS.SloRule("bad", "percentile", "m_total", fire=1.0)
    with pytest.raises(ValueError):
        TS.SloRule("bad", "ratio", "m_total", fire=1.0)


def test_inert_seams_and_the_evaluator_thread():
    assert TS.alerts() == JS.alerts() == {"firing": [], "warning": []}
    assert TS.firing_gate_rules() == JS.firing_gate_rules() == []
    assert TS._default_engine is None
    TT.enable()
    eng = TS.SloEngine(rules=[TS.SloRule("errs", "rate", "errors_total", fire=1.0)])
    eng.start(interval_s=0.01, source=lambda: _doc({"errors_total": [({}, 1.0)]}))
    deadline = time.time() + 10
    while eng.status()["evaluations"] < 3 and time.time() < deadline:
        time.sleep(0.01)
    eng.stop()
    assert eng.status()["evaluations"] >= 3 and eng.state("errs") == "ok"
    eng.clear()
    assert eng.status()["evaluations"] == 0


def test_flight_dump_slo_section_matches_jax(tmp_path):
    """A shed storm through the process-default engine of each package:
    the dump's ``"slo"`` section names the burning rule, the same in both."""
    sections = {}
    for (T, S), FL in zip(PKGS, (JFL, TFL)):
        T.enable()
        eng = S.get_engine()
        FL.get_recorder().note(step=1, wall_ms=3.0)
        for t, shed, sub in ((0.0, 0, 0), (60.0, 60, 120)):
            eng.evaluate(dict(_doc({"serving_shed_total": [({}, shed)]}),
                              **_doc({"serving_model_requests_total": [
                                  ({"outcome": "submitted"}, sub)]})), now=t)
        assert eng.state("serving_shed_ratio") == "firing"
        assert "serving_shed_ratio" in S.alerts()["firing"]
        path = FL.get_recorder().dump("storm", path=str(tmp_path / f"{T.__name__}.json"))
        with open(path) as f:
            sections[S] = json.load(f)["slo"]
    assert sections[TS] == sections[JS]
    assert sections[TS]["firing"] == ["serving_shed_ratio"]


# ---- goodput ------------------------------------------------------------

def _ledger_case(T, G, case):
    """The same observations, notes and clock on either package's ledger."""
    _, step_h, etl_h, _, _ = T.train_metrics()
    led = G.GoodputLedger().start(now=100.0)
    rs = np.random.RandomState(case)
    for v in rs.rand(int(rs.randint(2, 9))) * 0.5:
        step_h.observe(float(v))
    for v in rs.rand(3) * 0.1:
        etl_h.observe(float(v))
    led.note("exchange", 0.25 * case)
    led.note("checkpoint", 0.5)
    led.note("compute", 0.125 * case)
    led.note("rollback_lost", 99.0 if case == 2 else 0.3)
    led.note_tokens(800 * (case + 1))
    led.set_flops_per_step(1e9 * (case + 1))
    led.set_peak_flops(1e12)
    snaps = [led.snapshot(now=110.0)]
    led.start(now=150.0)  # a rebase carries nothing across
    step_h.observe(0.2)
    snaps.append(led.snapshot(now=160.0))
    return snaps


@pytest.mark.parametrize("case", [0, 1, 2])
def test_goodput_snapshot_matches_jax(case):
    for t, _ in PKGS:
        t.enable()
    want = _ledger_case(JT, JG, case)
    got = _ledger_case(TT, TG, case)
    assert got == want
    sec = got[0]["seconds"]
    assert sum(sec.values()) == pytest.approx(got[0]["window_s"])
    assert got[0]["mfu"] is not None and got[1]["steps"] == 1
    assert TT.series_map("goodput_seconds_total") == JT.series_map("goodput_seconds_total")


def test_goodput_guards_and_peak_flops_on_the_cpu():
    for G in (JG, TG):
        led = G.GoodputLedger()
        assert led.snapshot() == {"active": False}
        led.note("exchange", 1.0)
        led.note_tokens(100)
        assert led.snapshot() == {"active": False}
        with pytest.raises(ValueError):
            led.note("idle", 1.0)
    assert TG.device_peak_flops() is None and JG.device_peak_flops() is None
    assert t_rn50_flops() == j_rn50_flops()
    assert t_rn50_flops(160, 160) == j_rn50_flops(160, 160)


def test_step_driver_fit_opens_the_ledger_and_notes_checkpoints(tmp_path):
    """With telemetry on, a StepDriver opens the process's window; two
    rounds and a checkpoint between them: the categories sum to the window
    within 5%, every step is counted, and the checkpoint's seconds are
    noted (and counted under ``goodput_seconds_total``)."""
    from deeplearning4j_tpu_torch.continuous.driver import StepDriver
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    TT.enable()
    net = MultiLayerNetwork(text_generation_lstm(7, hidden=8, seq_len=4), device="cpu")
    net.init()
    rs = np.random.RandomState(3)
    batches = [(np.eye(7, dtype=np.float32)[rs.randint(0, 7, (4, 4))],
                np.eye(7, dtype=np.float32)[rs.randint(0, 7, (4, 4))], None) for _ in range(6)]
    assert not TG.get_ledger().active
    drv = StepDriver(net, lambda: iter(batches))
    led = TG.get_ledger()
    assert led.active
    led.start()
    drv.run_round(3)
    drv.sync()
    t0 = time.perf_counter()
    drv.checkpoint(str(tmp_path / "ckpt.zip"))
    ckpt_s = time.perf_counter() - t0
    drv.run_round(3)
    drv.sync()
    snap = led.snapshot()
    assert snap["steps"] == 6
    sec = snap["seconds"]
    assert 0 < sec["checkpoint"] <= ckpt_s
    assert abs(sum(sec.values()) - snap["window_s"]) <= 0.05 * snap["window_s"]
    assert TT.series_map("goodput_seconds_total")["category=checkpoint"] == pytest.approx(
        sec["checkpoint"], abs=1e-6)


# ---- federation ---------------------------------------------------------

def _dead_url():
    """A localhost port nothing listens on."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}/metrics"


def _members(seed):
    rs = np.random.RandomState(seed)
    return [(f"w{i}", _doc({"requests_total": [({"outcome": o}, float(rs.randint(0, 50)))
                                                for o in ("ok", "error")],
                            "shed_total": [({}, float(rs.randint(0, 5)))]}))
            for i in range(3)]


def test_federate_merge_and_dead_member_match_jax():
    for t, _ in PKGS:
        t.enable()
    dead = _dead_url()
    targets = _members(4) + [("dead", dead)]
    feds = {}
    for F in (JF, TF):
        t0 = time.monotonic()
        feds[F] = F.federate(targets, timeout_s=2.0)
        assert time.monotonic() - t0 < 10.0  # one bounded timeout, never a hang
    want, got = feds[JF], feds[TF]
    assert got["metrics"] == want["metrics"]
    assert got["scrapes"] == want["scrapes"] == {"ok": 3, "error": 1}
    assert {k: v["ok"] for k, v in got["members"].items()} == \
        {k: v["ok"] for k, v in want["members"].items()}
    assert got["members"]["dead"]["error"]
    labels = {s["labels"]["instance"] for s in got["metrics"]["requests_total"]["series"]}
    assert labels == {"w0", "w1", "w2"}
    assert TF.merged_to_prometheus(got) == JF.merged_to_prometheus(want)
    assert TT.series_map("federate_scrape_total") == JT.series_map("federate_scrape_total")
    smap = TT.series_map("federate_scrape_total")
    assert smap["instance=dead|outcome=error"] == 1 and smap["instance=w0|outcome=ok"] == 1


def test_series_maps_callables_and_default_targets():
    maps = {"recompiles_total": {"": 0, "reason=shape": 2, "a=1|b=2": 3}}
    assert TF.snapshot_from_series_maps(maps) == JF.snapshot_from_series_maps(maps)
    snap = _members(5)[0][1]
    # a callable source is called inside the scrape (the port's addition)
    assert TF.federate([("f", lambda: snap)])["metrics"] == \
        JF.federate([("f", snap)])["metrics"]
    TT.enable()

    def broken():
        raise RuntimeError("dead provider")
    TF.register_target_provider(lambda: [("g", snap)])
    TF.register_target_provider(broken)
    fed = TF.federate_default()
    assert fed["members"]["g"]["ok"] and "local" in fed["members"]
    TT.reset()  # clears the providers
    assert TF.default_targets(include_local=False) == []


def test_slo_over_a_federation_with_a_dead_member_neither_fires_nor_masks():
    dead = _dead_url()
    states = {}
    for (T, S), F in zip(PKGS, (JF, TF)):
        T.enable()
        eng = S.SloEngine(rules=[S.SloRule("errs", "rate", "errors_total", fire=1.0,
                                           window_s=60.0)])
        seen = []
        for t, live in ((0.0, 100), (30.0, 100), (60.0, 500)):
            fed = F.federate([("live", _doc({"errors_total": [({}, live)]})), ("dead", dead)],
                             timeout_s=1.0)
            seen.append(eng.evaluate(fed, now=t)["rules"][0]["state"])
        states[S] = seen
        assert T.series_map("federate_scrape_total")["instance=dead|outcome=error"] == 3
    assert states[TS] == states[JS] == ["ok", "ok", "firing"]
