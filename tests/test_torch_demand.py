"""The port's demand plane (``deeplearning4j_tpu_torch/telemetry/history.py``,
``serving/metering.py`` and the demand-derived shape buckets of
``datasets/iterator.py``) against the JAX package's modules, on the CPU.

History: the same samples give the same ring, queries and ``rate_over``
in both packages (and ``rate_over`` equals the live SLO delta tracking
within 1e-6); the port's segments load in the JAX package's ``load_dir``
and the JAX package's in the port's; restarts resume the segment
sequence, eviction is bounded, a corrupt segment is counted and never
fatal, and a replay through the SLO engine fires on a storm the reader
never lived through. Metering: the same records give the same usage, the
same rows give the same FLOPs estimate, and the port's engine meters the
same rows, tokens, padded tokens and FLOPs as the JAX engine on the same
traffic. Buckets: ``seq_edges_from_demand``, ``ShapeBuckets.from_demand``,
``with_batch``, ``round_up_to_multiple``, ``powers_of_two`` and
``signature`` equal the JAX package's; ``from_demand`` over the history
of an engine's traffic covers every requested length.
"""

import os
import time

import numpy as np
import pytest

from deeplearning4j_tpu import telemetry as JT
from deeplearning4j_tpu.datasets.iterator import BucketRegistry as JBuckets
from deeplearning4j_tpu.datasets.iterator import ShapeBuckets as JShape
from deeplearning4j_tpu.datasets.iterator import seq_edges_from_demand as j_edges
from deeplearning4j_tpu.models.misc import text_generation_lstm as j_charnn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu.serving import metering as JM
from deeplearning4j_tpu.telemetry import history as JH
from deeplearning4j_tpu.telemetry import registry as JR
from deeplearning4j_tpu.telemetry import slo as JS
from deeplearning4j_tpu_torch import telemetry as TT
from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry, ShapeBuckets
from deeplearning4j_tpu_torch.datasets.iterator import seq_edges_from_demand as t_edges
from deeplearning4j_tpu_torch.serving import ServingEngine
from deeplearning4j_tpu_torch.serving import metering as TM
from deeplearning4j_tpu_torch.telemetry import history as TH
from deeplearning4j_tpu_torch.telemetry import registry as TR
from deeplearning4j_tpu_torch.telemetry import slo as TS
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu.utils import serialization as jser

VOCAB, HIDDEN, SEQ = 11, 16, 16


@pytest.fixture(autouse=True)
def _isolate():
    for t in (JT, TT):
        t.reset()
        t.disable()
    yield
    for t in (JT, TT):
        t.reset()
        t.disable()


def _counter_docs(seed, n=20, reset_at=None):
    """n samples of a labelled counter from numpy draws (one series resets
    at ``reset_at``, one is born halfway)."""
    rs = np.random.RandomState(seed)
    a = b = 0.0
    docs = []
    for i in range(n):
        a += float(rs.randint(0, 50))
        b = 0.0 if i == reset_at else b + float(rs.randint(0, 20))
        series = [{"labels": {"model": "m"}, "value": a}]
        if i >= n // 2:
            series.append({"labels": {"model": "late"}, "value": b})
        docs.append((1000.0 + 5.0 * i, {"parity_total": {"kind": "counter", "help": "",
                                                          "series": series}}))
    return docs


# ---------------------------------------------------------------------------
# history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["foo", "foo{a=1,b=x}", ' foo{a="q"} ', "foo{}"])
def test_parse_series_matches_jax(spec):
    assert TH.parse_series(spec) == JH.parse_series(spec)


@pytest.mark.parametrize("spec", ["foo{a=1", "foo{nolabel}", "foo{=1}"])
def test_parse_series_refusals_match_jax(spec):
    for H in (JH, TH):
        with pytest.raises(ValueError):
            H.parse_series(spec)


@pytest.mark.parametrize("seed", [0, 1])
def test_queries_and_rate_over_match_jax(seed):
    """The same samples (a reset, a newborn series) in both stores: the
    ring, range queries and rate_over over several windows are equal, and
    rate_over equals the live SLO delta tracking within 1e-6."""
    docs = _counter_docs(seed, reset_at=14)
    stores = {H: H.MetricsHistory(max_samples=16) for H in (JH, TH)}
    live = TS._DeltaTrack(keep_s=3600.0)
    for t, doc in docs:
        for store in stores.values():
            store.sample_now(now=t, metrics=doc)
    for t, doc in docs[-16:]:
        live.sample(t, TS._select(doc, "parity_total", {}))
    j, p = stores[JH], stores[TH]
    assert p.samples() == j.samples() and len(p.samples()) == 16
    for series in ("parity_total", "parity_total{model=late}", "never_total"):
        assert p.query(series) == j.query(series)
        assert p.query(series, t0=1030.0, t1=1060.0) == j.query(series, t0=1030.0, t1=1060.0)
    now = docs[-1][0]
    for window in (10.0, 30.0, 60.0, 75.0):
        got = p.rate_over("parity_total", window, now=now)
        assert got == j.rate_over("parity_total", window, now=now)
        assert got is not None and got >= 0.0
        assert abs(got - live.rate(window, now)) <= 1e-6
    assert p.rate_over("parity_total", 60.0, now=now - 100.0) == \
        j.rate_over("parity_total", 60.0, now=now - 100.0)


def test_segments_cross_load_between_packages(tmp_path):
    """Each package's segments load in the other's ``load_dir`` to the same
    samples; both stores resume their own segment sequence over a dir."""
    docs = _counter_docs(3, n=7)
    dirs = {H: str(tmp_path / H.__name__) for H in (JH, TH)}
    for H in (JH, TH):
        store = H.MetricsHistory(history_dir=dirs[H], segment_samples=3, max_segments=8)
        for t, doc in docs:
            store.sample_now(now=t, metrics=doc)
        store.flush()
        assert [os.path.basename(p) for p in store.segment_paths()] == [
            f"history-{i:08d}.jsonl" for i in range(3)]
        assert not [n for n in os.listdir(dirs[H]) if n.endswith(".tmp")]
    for reader in (JH, TH):
        for writer in (JH, TH):
            samples, corrupt = reader.load_dir(dirs[writer])
            assert corrupt == 0
            assert samples == [{"t": t, "metrics": doc} for t, doc in docs]
    # a restarted store over the JAX package's dir continues its sequence
    s2 = TH.MetricsHistory(history_dir=dirs[JH], segment_samples=1)
    s2.sample_now(now=2000.0, metrics=docs[0][1])
    assert os.path.basename(s2.segment_paths()[-1]) == "history-00000003.jsonl"
    fresh, jfresh = TH.MetricsHistory(), JH.MetricsHistory()
    assert len(fresh.load(dirs[JH])) == len(jfresh.load(dirs[JH])) == 8
    assert fresh.query("parity_total{model=m}") == jfresh.query("parity_total{model=m}")


def test_loaded_ring_answers_as_jax(tmp_path):
    docs = _counter_docs(5, n=9)
    d = str(tmp_path / "hist")
    w = JH.MetricsHistory(history_dir=d, segment_samples=4)
    for t, doc in docs:
        w.sample_now(now=t, metrics=doc)
    w.flush()
    stores = {H: H.MetricsHistory() for H in (JH, TH)}
    for store in stores.values():
        store.load(d)
    assert stores[TH].query("parity_total{model=m}") == stores[JH].query("parity_total{model=m}")
    assert stores[TH].rate_over("parity_total", 30.0) == stores[JH].rate_over("parity_total", 30.0)


def test_eviction_and_corrupt_segments_counted_as_jax(tmp_path):
    counts = {}
    for T, H in ((JT, JH), (TT, TH)):
        T.enable()
        d = str(tmp_path / f"{H.__name__}_evict")
        store = H.MetricsHistory(history_dir=d, segment_samples=1, max_segments=3)
        for i in range(7):
            store.sample_now(now=float(i))
        assert [s["t"] for s in H.load_dir(d)[0]] == [4.0, 5.0, 6.0]
        with open(store.segment_paths()[0], "w") as f:
            f.write("{torn json\n")
        samples, corrupt = H.load_dir(d)
        assert corrupt == 1 and [s["t"] for s in samples] == [5.0, 6.0]
        H.MetricsHistory(history_dir=d).load()
        ring = H.MetricsHistory(max_samples=4)
        for i in range(10):
            ring.sample_now(now=1000.0 + i)
        assert [s["t"] for s in ring.samples()] == [1006.0, 1007.0, 1008.0, 1009.0]
        counts[H] = T.series_map("history_segment_total")
    assert counts[TH] == counts[JH]
    assert counts[TH]["event=evict"] == 4 and counts[TH]["event=corrupt"] == 1


def test_sampler_thread_and_default_store(tmp_path, monkeypatch):
    TT.enable()
    store = TH.MetricsHistory()
    store.start(interval_s=0.02)
    deadline = time.time() + 10
    while not store.samples() and time.time() < deadline:
        time.sleep(0.01)
    assert store.samples()
    store.stop()
    assert store.describe()["sampling"] is False
    monkeypatch.setenv(TH.HISTORY_DIR_ENV, str(tmp_path / "default"))
    h = TH.get_history()
    assert h.history_dir == str(tmp_path / "default") and TH.get_history() is h
    assert TH._dump_section()["dir"] == str(tmp_path / "default")
    TT.reset()
    assert TH._dump_section() is None


def test_replay_into_engine_fires_as_jax(tmp_path):
    """A reader that never lived through a shed storm replays its history
    into a fresh SLO engine over the default rules: the shed ratio fires,
    as in the JAX package."""
    d = str(tmp_path / "hist")
    JT.enable()
    reg = JT.get_registry()
    num = reg.counter("serving_shed_total", "t")
    den = reg.counter("serving_model_requests_total", "t")
    store = JH.MetricsHistory(history_dir=d, segment_samples=4)
    for i in range(8):
        num.inc(30, model="m", reason="queue_full")
        den.inc(50, model="m", outcome="submitted")
        store.sample_now(now=2000.0 + 30.0 * i)
    store.flush()
    states = {}
    for S, H, reg in ((JS, JH, JR.MetricsRegistry()), (TS, TH, TR.MetricsRegistry())):
        engine = S.SloEngine(rules=S.default_rules(), registry=reg)
        reader = H.MetricsHistory(registry=reg, history_dir=d)
        assert reader.replay_into(engine, samples=reader.load()) == 8
        states[S] = {r["name"]: (r["state"], r["value"]) for r in engine.status()["rules"]}
    assert states[TS] == states[JS]
    assert states[TS]["serving_shed_ratio"][0] == "firing"


# ---------------------------------------------------------------------------
# metering
# ---------------------------------------------------------------------------

def _records(M, seed):
    rs = np.random.RandomState(seed)
    meter = M.UsageMeter()
    for i in range(12):
        meter.record(["a", "b"][i % 2], rows=int(rs.randint(-1, 5)), tokens=int(rs.randint(0, 64)),
                     seq_tokens=float(rs.randint(0, 32)), padded_tokens=float(rs.randint(0, 64)),
                     queue_s=float(rs.rand() - 0.1), device_s=float(rs.rand()),
                     flops=float(rs.randint(0, 1000)), tenant=[None, "t1", "t2"][i % 3])
    return meter


@pytest.mark.parametrize("seed", [0, 1])
def test_usage_matches_jax(seed):
    for t in (JT, TT):
        t.enable()
    j, p = _records(JM, seed), _records(TM, seed)
    assert p.usage() == j.usage()
    assert p.rows_for("a") == j.rows_for("a")
    assert TT.series_map("usage_rows_total") == JT.series_map("usage_rows_total")
    assert TT.series_map("usage_flops_total") == JT.series_map("usage_flops_total")
    p.clear()
    assert p.usage()["models"] == {}


@pytest.mark.parametrize("rows,tokens", [(8, None), (3, 48), (64, 8192)])
def test_estimate_flops_matches_jax(rows, tokens):
    assert TM.estimate_flops(4187, rows, padded_tokens=tokens) == \
        JM.estimate_flops(4187, rows, padded_tokens=tokens)


def test_meter_is_reset_with_telemetry_and_ledgers_with_it_off():
    TM.get_meter().record("a", rows=-5, tokens=3)
    assert TM.get_meter().usage()["models"]["a"]["rows"] == 0
    assert TT.series_map("usage_rows_total") == {}
    TT.reset()
    assert TM.get_meter().usage()["models"] == {}


@pytest.fixture(scope="module")
def charnn_pair(tmp_path_factory):
    j = JNet(j_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ))
    j.init()
    path = tmp_path_factory.mktemp("meter") / "charnn.zip"
    jser.save_model(j, str(path))
    return j, path


def _traffic(seed):
    """(x, kwargs) of 7 submits of lengths 5-16 from two tenants, a probe
    and a batched pair."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(7):
        t = int(rs.randint(5, SEQ + 1))
        x = rs.randn(2 if i == 6 else 1, t, VOCAB).astype(np.float32)
        kw = {"tenant": ["acme", "beta", None][i % 3]}
        if i == 5:
            kw = {"origin": "probe"}
        if i == 6:
            out.append((x, dict(kw, batched=True)))
        else:
            out.append((x[0], kw))
    return out


def test_engine_metering_matches_jax_engine(charnn_pair):
    """The same submits, one at a time, to the JAX engine and the port's
    on the same weights and grid: rows, tokens, real and padded sequence
    tokens and FLOPs per tenant are equal (queue and device seconds are
    each process's clock)."""
    for t in (JT, TT):
        t.enable()
    jnet, path = charnn_pair
    engines = {JM: JEngine(jnet, name="m", input_spec=(SEQ, VOCAB), buckets=(1, 2),
                           seq_buckets=(8, 16)).start(),
               TM: ServingEngine(tser.load_model(path, device="cpu"), name="m",
                                 input_spec=(SEQ, VOCAB), buckets=(1, 2), seq_buckets=(8, 16),
                                 device="cpu").start()}
    try:
        for x, kw in _traffic(7):
            outs = [e.submit(x, **kw).get(timeout=30) for e in engines.values()]
            np.testing.assert_allclose(outs[1], np.asarray(outs[0]), atol=1e-5)
    finally:
        for e in engines.values():
            e.stop()
    keys = ("rows", "tokens", "seq_tokens", "padded_tokens", "flops")

    def counts(u):
        return {k: u[k] for k in keys}, {t: {k: v[k] for k in keys}
                                         for t, v in u["tenants"].items()}
    want = counts(JM.get_meter().usage()["models"]["m"])
    got = counts(TM.get_meter().usage()["models"]["m"])
    assert got == want
    assert got[0]["rows"] == 8 and got[1]["acme"]["rows"] == 4  # 1 + 1 + the batched 2
    assert TT.series_map("serving_request_seq_len") == JT.series_map("serving_request_seq_len")
    assert engines[TM].health()["usage"]["rows"] == 8
    # the probe kept out of the organic request series, as in the JAX package
    smap = TT.series_map("serving_model_requests_total")
    assert smap["model=m|origin=probe|outcome=submitted"] == 1
    assert smap == JT.series_map("serving_model_requests_total")


# ---------------------------------------------------------------------------
# demand-derived shape buckets
# ---------------------------------------------------------------------------

def _edges_history(R, H, lengths, buckets=(16, 32, 64, 128, 256)):
    reg = R.MetricsRegistry()
    h = reg.histogram("serving_request_seq_len", "lengths", buckets=buckets)
    for t in lengths:
        h.observe(t, model="m")
    hist = H.MetricsHistory(reg)
    hist.sample_now()
    return hist


@pytest.mark.parametrize("case", [
    ([10] * 60 + [100] * 30 + [250] * 10, 256, (0.5, 0.9)),
    ([400] * 10, 128, (0.5, 0.9)),
    ([5, 17, 33, 65, 129, 257] * 5, 512, (0.25, 0.5, 0.75, 0.99)),
    ([], 256, (0.5, 0.9)),
])
def test_seq_edges_and_from_demand_match_jax(case):
    lengths, max_seq, q = case
    jh = _edges_history(JR, JH, lengths)
    th = _edges_history(TR, TH, lengths)
    assert t_edges(max_seq, history=th, quantiles=q) == j_edges(max_seq, history=jh, quantiles=q)
    got = ShapeBuckets.from_demand([1, 2, 4], max_seq, history=th, quantiles=q)
    want = JShape.from_demand([1, 2, 4], max_seq, history=jh, quantiles=q)
    assert got.sizes() == want.sizes() and got.signature() == want.signature()


def test_grid_helpers_match_jax():
    for b, s in (([1, 2, 5], [16, 48]), ([2, 1], [32, 16]), ([3], [7, 9, 128])):
        mine, ref = ShapeBuckets(b, s), JShape(b, s)
        assert mine.signature() == ref.signature()
        for m in (1, 2, 4, 8):
            assert mine.round_up_to_multiple(m).sizes() == ref.round_up_to_multiple(m).sizes()
            assert BucketRegistry(b).round_up_to_multiple(m).sizes() == \
                JBuckets(b).round_up_to_multiple(m).sizes()
        assert mine.with_batch([4, 8]).sizes() == ref.with_batch([4, 8]).sizes()
    for mb, ms in ((8, 128), (2, 8), (64, 1000)):
        assert ShapeBuckets.powers_of_two(mb, ms).sizes() == JShape.powers_of_two(mb, ms).sizes()
    assert ShapeBuckets.powers_of_two(4, 64, min_seq=8).sizes() == \
        JShape.powers_of_two(4, 64, min_seq=8).sizes()
    # cold: no retained demand, powers of two (the default history)
    assert ShapeBuckets.from_demand([1, 2], 128).seq.sizes() == [16, 32, 64, 128]


def test_from_demand_on_served_traffic_covers_every_length(charnn_pair):
    """A port engine serves lengths 5-16 with telemetry on; its history,
    sampled during the traffic, gives a grid that serves every requested
    length (each within its smallest covering edge)."""
    TT.enable()
    _, path = charnn_pair
    engine = ServingEngine(tser.load_model(path, device="cpu"), name="demand",
                           input_spec=(SEQ, VOCAB), buckets=(1, 2), seq_buckets=(8, 16),
                           device="cpu").start()
    hist = TH.MetricsHistory()
    rs = np.random.RandomState(9)
    lengths = [int(t) for t in rs.randint(5, SEQ + 1, 24)]
    try:
        for i, t in enumerate(lengths):
            engine.submit(rs.randn(t, VOCAB).astype(np.float32)).get(timeout=30)
            if i % 8 == 7:
                hist.sample_now()
    finally:
        engine.stop()
    grid = ShapeBuckets.from_demand([1, 2], SEQ, history=hist)
    assert grid.max_seq == SEQ
    assert all(grid.bucket_for(1, t) is not None for t in lengths)
    assert grid.seq.sizes() == t_edges(SEQ, history=hist)
