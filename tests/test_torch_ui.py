"""The port's training dashboard (``deeplearning4j_tpu_torch/ui/``) held
against the JAX package's ``ui/`` on the CPU: storage files read across
the packages, components rendering the same strings, StatsListener
records from the same weights, the UI server's routes over the same
records, ``/health``'s keys and the conv listener's grids."""

import json
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import visualization as jvis
from deeplearning4j_tpu_torch import ui as tui
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ui import components as tcomp
from deeplearning4j_tpu_torch.ui import server as tserver
from deeplearning4j_tpu_torch.ui import stats as tstats
from deeplearning4j_tpu_torch.ui import visualization as tvis
from deeplearning4j_tpu_torch.utils import serialization as tser


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode(), r.headers.get("Content-Type")


def _mlp(Conf, L, I, U, seed=3):
    return Conf(seed=seed, updater=U.Adam(learning_rate=0.01)).list(
        L.DenseLayer(n_out=8, activation="tanh"),
        L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(5))


def _pair(dtype=np.float64):
    """(JAX net, port net) with the same weights, and (x, y)."""
    jnet = JNet(_mlp(JConf, JL, JI, JU))
    tnet = TNet(_mlp(TConf, TL, TI, TU), device="cpu")
    jnet.init()
    tnet.init(dtype=torch.float64 if dtype == np.float64 else None)
    if dtype == np.float64:
        jnet.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    rs = np.random.RandomState(7)
    x = rs.randn(24, 5).astype(dtype)
    y = np.eye(3, dtype=dtype)[rs.randint(0, 3, 24)]
    return jnet, tnet, x, y


# ----------------------------------------------------------------------
# storage
# ----------------------------------------------------------------------

_RECORDS = [{"type": "init", "session": "s", "num_params": 3},
            {"type": "stats", "session": "s", "iteration": 1, "score": 0.5,
             "params": {"[0]['W']": {"l2": 1.0, "mean": 0.0, "std": 0.1, "min": -1.0,
                                     "max": 1.0}}},
            {"type": "stats", "session": "t", "iteration": 2, "score": 0.25}]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_file_storage_reads_the_other_packages_file(tmp_path, writer, reader):
    mods = {"torch": tui, "jax": jui}
    path = str(tmp_path / "stats.jsonl")
    w = mods[writer].FileStatsStorage(path)
    for r in _RECORDS:
        w.put_record(r)
    w.close()
    back = mods[reader].FileStatsStorage(path)
    try:
        assert back.get_records() == _RECORDS
        assert back.sessions() == ["s", "t"]
        assert back.get_records(session="s", type_="stats") == [_RECORDS[1]]
    finally:
        back.close()


def test_in_memory_storage_listeners_and_filters():
    st, seen = tui.InMemoryStatsStorage(), []
    st.register_listener(seen.append)
    for r in _RECORDS:
        st.put_record(r)
    assert seen == _RECORDS
    assert st.get_records(type_="init") == [_RECORDS[0]]


def test_remote_router_posts_to_a_server():
    srv = tui.UIServer(port=0).start()
    try:
        router = tui.RemoteStatsStorageRouter(f"http://127.0.0.1:{srv.port}")
        router.put_record({"type": "stats", "session": "remote-s", "iteration": 1,
                           "score": 0.5})
        router.close()
        assert "remote-s" in json.loads(_get(srv.port, "/train/sessions")[0])
        assert router.dropped == 0
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# components: the same strings
# ----------------------------------------------------------------------

def _components(m):
    rs = np.random.RandomState(0)
    return [
        m.ChartLine("score", [("train", [0, 1, 2], [3.0, 2.0, 1.5]),
                              ("val", [0, 1, 2], [3.2, 2.4, 2.0])]),
        m.ChartScatter("s", [("a", [1, 2, 5], [3, 4, -1])]),
        m.ChartHistogram.of("weights", rs.randn(500), n_bins=20),
        m.ChartHorizontalBar("b", ["x", "y<z>"], [1.0, 2.0]),
        m.ChartStackedArea("st", [0, 1, 2], [("a", [1, 1, 1]), ("b", [2, 1, 0])]),
        m.ChartTimeline("t", [("lane", [(0.0, 1.0, "etl"), (1.0, 3.0, "step")])]),
        m.ComponentTable(["a", "b"], [["1", "<evil>"]]),
        m.ComponentText("hello & bye", bold=True),
        m.DecoratorAccordion("layer0", [m.ComponentText("hello", bold=True)],
                             default_collapsed=True),
    ]


@pytest.mark.parametrize("i", range(9))
def test_components_render_the_jax_strings(i):
    j, t = _components(jcomp)[i], _components(tcomp)[i]
    assert t.to_dict() == j.to_dict()
    assert t.render_html() == j.render_html()
    if hasattr(j, "render_svg"):
        assert t.render_svg() == j.render_svg()
    back = tcomp.Component.from_dict(j.to_dict())
    assert back.to_dict() == j.to_dict()


# ----------------------------------------------------------------------
# StatsListener
# ----------------------------------------------------------------------

def _close(a, b, rtol=1e-6, atol=1e-7):
    return abs(a - b) <= atol + rtol * abs(b)


def test_array_stats_match_jax_on_the_same_weights():
    """l2/mean/std/min/max within float32 reduction noise, histogram
    counts and edges equal, the same names."""
    jnet, tnet, _, _ = _pair(np.float32)
    j = jstats._array_stats(jnet.params, histogram_bins=7)
    t = tstats._array_stats(tnet.params, histogram_bins=7)
    assert set(t) == set(j)
    for name in j:
        for s in ("l2", "mean", "std", "min", "max"):
            assert _close(t[name][s], j[name][s]), (name, s, t[name][s], j[name][s])
        assert t[name]["hist"] == j[name]["hist"]


def test_array_stats_fetch_once_and_skip_empty_leaves():
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)

    tree = [{"W": torch.ones(3, 2), "b": torch.zeros(0)}, {"W": torch.arange(4.0)}]
    torch.Tensor.cpu = counting
    try:
        out = tstats._array_stats(tree)
    finally:
        torch.Tensor.cpu = real
    assert calls == [(2, 5)]  # one stacked [leaves, 5] transfer
    assert set(out) == {"[0]['W']", "[1]['W']"}
    assert out["[1]['W']"]["max"] == 3.0 and out["[0]['W']"]["std"] == 0.0


def test_listener_records_match_jax_through_a_fit():
    jnet, tnet, x, y = _pair(np.float64)
    js, ts = jui.InMemoryStatsStorage(), tui.InMemoryStatsStorage()
    jnet.add_listener(jui.StatsListener(js, session_id="p", collect_histograms=True))
    tnet.add_listener(tui.StatsListener(ts, session_id="p", collect_histograms=True))
    jnet.fit(x, y, epochs=3, batch_size=8)
    tnet.fit(x, y, epochs=3, batch_size=8)
    jr, tr = js.get_records(type_="stats"), ts.get_records(type_="stats")
    assert [r["iteration"] for r in tr] == [r["iteration"] for r in jr] == list(range(1, 10))
    for a, b in zip(tr, jr):
        assert _close(a["score"], b["score"], rtol=1e-9)
        assert set(a["params"]) == set(b["params"])
        for name in b["params"]:
            for s in ("l2", "mean", "std", "min", "max"):
                assert _close(a["params"][name][s], b["params"][name][s]), (name, s)
            assert sum(a["params"][name]["hist"]["counts"]) == \
                sum(b["params"][name]["hist"]["counts"])
        assert set(b["system"]) - {"device_bytes_in_use", "device_bytes_limit"} \
            <= set(a["system"])
    ti, ji = ts.get_records(type_="init")[0], js.get_records(type_="init")[0]
    assert ti["num_params"] == ji["num_params"] and ti["num_layers"] == ji["num_layers"]
    assert set(ti["hardware"]) == set(ji["hardware"])
    assert ti["hardware"]["platform"] == "cpu"
    assert len(ts.get_records(type_="epoch_end")) == len(js.get_records(type_="epoch_end"))


def test_listener_under_k_steps_sees_the_dispatchs_last_params():
    """At K=4 the K callbacks of a dispatch fire after it: every one reads
    the K-th step's parameters, as in the JAX package's fused loop."""
    _, tnet, x, y = _pair(np.float32)
    st = tui.InMemoryStatsStorage()
    tnet.add_listener(tui.StatsListener(st, session_id="k"))
    tnet.fit(x[:16], y[:16], batch_size=4, steps_per_dispatch=4)
    recs = st.get_records(type_="stats")
    assert [r["iteration"] for r in recs] == [1, 2, 3, 4]
    final = tstats._array_stats(tnet.params)
    for r in recs:
        assert r["params"] == final
    assert len({r["score"] for r in recs}) == 4  # the K losses are the steps' own


# ----------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------

def _dashboard_records():
    recs = [{"type": "init", "session": "s1",
             "hardware": {"platform": "gpu", "n_devices": 1, "device_kind": "card"}}]
    for proc in (0, 1):
        for i in range(4):
            r = {"type": "stats", "session": "s1", "iteration": i, "score": 2.0 - 0.1 * i,
                 "iter_time_s": 0.01 * (i + 1), "etl_time_s": 0.001,
                 "params": {"[0]['W']": {"l2": 1.0 + i * 0.01, "mean": 0.0, "std": 0.05,
                                         "hist": {"counts": [2, 5, 2], "min": -0.1,
                                                  "max": 0.1}}},
                 "system": {"host_rss_mb": 100.0 * (proc + 1) + i,
                            "device_bytes_in_use": 1000 * (i + 1)}}
            if proc:
                r["process"] = proc
            recs.append(r)
    # a corrupt /remote record and an XSS session id
    recs.append({"type": "stats", "session": "s<x>", "iteration": 0, "score": 1.0,
                 "params": {"W": {"l2": "corrupt", "mean": 0, "std": 0}}})
    recs.append({"type": "stats", "session": "s<x>", "iteration": 1, "score": float("nan"),
                 "params": {"W": {"l2": 1.0, "mean": 0.0, "std": 0.1}}})
    return recs


_ROUTES = ["/train/sessions", "/train/overview?session=s1", "/train/model?session=s1",
           "/train/system?session=s1", "/train/model.html?session=s1",
           "/train/system.html?session=s1", "/train/overview?session=nobody",
           "/train/model.html?session=" + urllib.parse.quote("s<x>"), "/",
           "/train/model.html?session=nobody"]


@pytest.fixture(scope="module")
def servers():
    js, ts = jui.InMemoryStatsStorage(), tui.InMemoryStatsStorage()
    for r in _dashboard_records():
        js.put_record(r)
        ts.put_record(r)
    j = jui.UIServer(port=0).attach(js).start()
    t = tui.UIServer(port=0).attach(ts).start()
    yield j, t
    j.stop()
    t.stop()


@pytest.mark.parametrize("route", _ROUTES)
def test_routes_answer_what_the_jax_server_answers(servers, route):
    j, t = servers
    jb, jtype = _get(j.port, route)
    tb, ttype = _get(t.port, route)
    assert ttype == jtype
    if jtype == "application/json":
        assert json.loads(tb) == json.loads(jb)
    else:
        assert tb == jb


def test_system_split_and_model_page_escape(servers):
    _, t = servers
    data = json.loads(_get(t.port, "/train/system?session=s1")[0])
    assert set(data["processes"]) == {"0", "1"}
    assert [v for _, v in data["host_rss_mb"]] == [100.0, 101.0, 102.0, 103.0]
    body = _get(t.port, "/train/model.html?session=" + urllib.parse.quote("s<x>"))[0]
    assert "<x>" not in body and "&lt;x&gt;" in body


@pytest.mark.parametrize("route", ["/health", "/serving", "/slo", "/traces",
                                   "/traces?cluster=1", "/traces?cluster=1&format=chrome",
                                   "/fleet", "/usage", "/query", "/metrics"])
def test_operations_routes_answer(servers, route):
    _, t = servers
    body, ctype = _get(t.port, route)
    if route == "/metrics":
        assert ctype.startswith("application/openmetrics-text")
    else:
        assert isinstance(json.loads(body), dict)


def test_post_remote_validates(servers):
    _, t = servers
    req = urllib.request.Request(f"http://127.0.0.1:{t.port}/remote", data=b"[1]",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


def _keys(d, depth=2):
    out = set()
    for k, v in d.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict) and k in ("distributed", "flight",
                                                       "compile_cache", "watchdog"):
            out |= {f"{k}.{kk}" for kk in _keys(v, depth - 1)}
    return out


def test_health_keys_include_the_jax_keys():
    j, t = jserver._health_payload(), tserver._health_payload()
    missing = {k for k in _keys(j) - _keys(t)
               if not k.startswith("compile_cache.")}  # the XLA cache's own fields
    assert not missing, missing
    assert t["distributed"] == {"hosts_alive": None} or t["distributed"]["hosts_alive"] == 0.0
    assert set(t["memory"]) == {"devices", "live_array_bytes"}


# ----------------------------------------------------------------------
# conv visualization
# ----------------------------------------------------------------------

def test_grid_equals_jax():
    act = np.random.RandomState(0).rand(2, 6, 6, 9).astype(np.float32)
    np.testing.assert_array_equal(tvis.activations_to_grid(act), jvis.activations_to_grid(act))
    assert tvis.activations_to_grid(act[0], per_row=2).shape == (5 * 7 - 1, 2 * 7 - 1)


def _lenet(Conf, L, I):
    return Conf(seed=1).list(
        L.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same"),
        L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
        L.ConvolutionLayer(n_out=6, kernel=(3, 3), padding="same"),
        L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
        input_type=I.convolutional(8, 8, 1))


def test_conv_listener_grids_equal_jax():
    jnet = JNet(_lenet(JConf, JL, JI))
    tnet = TNet(_lenet(TConf, TL, TI), device="cpu")
    jnet.init()
    tnet.init(dtype=torch.float64)
    jnet.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    rs = np.random.RandomState(2)
    x = rs.rand(8, 8, 8, 1)
    y = np.eye(3)[rs.randint(0, 3, 8)]
    jl = jvis.ConvolutionalIterationListener(frequency=2)
    tl = tvis.ConvolutionalIterationListener(frequency=2)
    jnet.listeners.append(jl)
    tnet.listeners.append(tl)
    jnet.fit(x, y, epochs=1, batch_size=2)
    tnet.fit(x, y, epochs=1, batch_size=2)
    assert [(it, li) for it, li, _ in tl.history] == [(it, li) for it, li, _ in jl.history]
    assert {li for _, li, _ in tl.history} == {0, 1, 2}
    assert len(tl.history) == 6  # 3 conv-family layers at iterations 2 and 4
    for (_, _, a), (_, _, b) in zip(tl.history, jl.history):
        np.testing.assert_array_equal(a, b)
