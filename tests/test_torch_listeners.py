"""The port's listeners and early stopping against the JAX package, on the
CPU.

``CollectScoresListener``'s (iteration, score) pairs over the same fit from
the same weights: a MultiLayerNetwork and a ComputationGraph, plain steps
and truncated BPTT (one callback a batch with the mean of its chunks for a
MultiLayerNetwork, one a chunk for a graph, as in the JAX package), in
float32 within rtol 1e-6 (a few steps of the same float32 sums in another
order). The one-step-late contract is held under the CPU profiler: the
only scalar fetches of a fit with three listeners are one a step, each
after the next step's update. ``EarlyStoppingTrainer`` in float64 against
the JAX trainer: the same stopping epoch and reason, the same best epoch,
the scores within rtol 1e-9, and the restored best model scoring its
recorded best.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import earlystopping as JES
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import listeners as JLS
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.nn import earlystopping as TES
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import listeners as TLS
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import GraphBuilder as TGB
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser

SCORE_RTOL = 1e-6
ES_RTOL = 1e-9


def _mlp(C, L, I, U, lr=0.1):
    return C(seed=3, updater=U.Sgd(learning_rate=lr)).list(
        L.DenseLayer(n_out=8, activation="tanh"), L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(5))


def _rnn_mln(C, L, I, U):
    return C(seed=3, updater=U.Sgd(learning_rate=0.1)).list(
        L.LSTM(n_out=6), L.RnnOutputLayer(n_out=4, loss="mcxent"),
        input_type=I.RecurrentType(4, 12), backprop_type="tbptt", tbptt_fwd_length=4,
        tbptt_back_length=4)


def _graph(GB, L, I, U, tbptt=False):
    kw = dict(backprop_type="tbptt", tbptt_fwd_length=4, tbptt_back_length=4) if tbptt else {}
    g = GB(updater=U.Sgd(learning_rate=0.1), seed=5, **kw)
    g.add_inputs("in")
    if tbptt:
        g.set_input_types(I.RecurrentType(4, 12))
        g.add_layer("h", L.LSTM(n_out=6), "in")
        g.add_layer("out", L.RnnOutputLayer(n_out=4, loss="mcxent"), "h")
    else:
        g.set_input_types(I.FeedForwardType(5))
        g.add_layer("h", L.DenseLayer(n_out=8, activation="tanh"), "in")
        g.add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "h")
    g.set_outputs("out")
    return g.build()


def _pair(kind, dtype=np.float32):
    """(JAX net, port net) from the same weights, and (x, y)."""
    rs = np.random.RandomState(7)
    if kind in ("mln", "mln_tbptt"):
        jconf, tconf = ((_mlp(JConf, JL, JI, JU), _mlp(TConf, TL, TI, TU)) if kind == "mln" else
                        (_rnn_mln(JConf, JL, JI, JU), _rnn_mln(TConf, TL, TI, TU)))
        jnet, tnet = JNet(jconf), TNet(tconf, device="cpu")
    else:
        tb = kind == "graph_tbptt"
        jnet = JGraph(_graph(JGB, JL, JI, JU, tbptt=tb))
        tnet = TGraph(_graph(TGB, TL, TI, TU, tbptt=tb), device="cpu")
    jnet.init()
    tnet.init(dtype=torch.float64 if dtype == np.float64 else None)
    if dtype == np.float64:
        jnet.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
                           state=jax.tree_util.tree_map(np.asarray, jnet.state))
    if kind.endswith("tbptt"):
        x = rs.randn(8, 12, 4).astype(dtype)
        y = np.eye(4, dtype=dtype)[rs.randint(0, 4, (8, 12))]
    else:
        x = rs.randn(24, 5).astype(dtype)
        y = np.eye(3, dtype=dtype)[rs.randint(0, 3, 24)]
    return jnet, tnet, x, y


@pytest.mark.parametrize("kind", ["mln", "graph", "mln_tbptt", "graph_tbptt"])
def test_collected_scores_match_the_jax_fit(kind):
    jnet, tnet, x, y = _pair(kind)
    jc, tc = JLS.CollectScoresListener(), TLS.CollectScoresListener()
    jnet.add_listener(jc)
    assert tnet.add_listener(tc) is tnet
    jnet.fit(x, y, batch_size=4, epochs=2)
    tnet.fit(x, y, batch_size=4, epochs=2)
    assert tc.iterations == jc.iterations and len(tc.iterations) > 0
    np.testing.assert_allclose(tc.scores, jc.scores, rtol=SCORE_RTOL)
    if kind == "mln_tbptt":  # one callback a batch, after its 3 chunks
        assert tc.iterations == [3, 6, 9, 12]
    if kind == "graph_tbptt":  # one callback a chunk
        assert tc.iterations == list(range(1, 13))


def test_callbacks_fire_one_step_late_and_at_the_epoch_edges():
    _, tnet, x, y = _pair("mln")
    seen = []

    class Probe(TLS.TrainingListener):
        def on_epoch_start(self, model):
            seen.append(("start", model.iteration))

        def iteration_done(self, model, iteration, score, etl_time=0.0):
            seen.append((iteration, model.iteration))

        def on_epoch_end(self, model):
            seen.append(("end", model.iteration))

    tnet.add_listener(Probe())
    tnet.fit(x, y, batch_size=8, epochs=2)
    # step i is reported while step i + 1 has already run; the last step of
    # an epoch lands before on_epoch_end
    assert seen == [("start", 0), (1, 2), (2, 3), (3, 3), ("end", 3),
                    ("start", 3), (4, 5), (5, 6), (6, 6), ("end", 6)]
    assert len(tnet.score_history) == 6 and tnet.score_value == tnet.score_history[-1]


def test_three_listeners_add_no_scalar_fetch_under_the_profiler():
    """Each step's loss is fetched once, after the next step's update: the
    listeners force no per-step sync of their own."""
    _, tnet, x, y = _pair("mln")
    perf = TLS.PerformanceListener(frequency=1, print_fn=lambda s: None)
    tnet.add_listener(TLS.ScoreIterationListener(1, print_fn=lambda s: None), perf,
                      TLS.CollectScoresListener())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tnet.fit(x, y, batch_size=4)
    steps = x.shape[0] // 4
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    items = [e.time_range.start for e in events if e.name == "aten::item"]
    updates = [e.time_range.start for e in events if e.name == "updater.step"]
    assert len(updates) == steps and len(items) == steps
    for k in range(steps - 1):
        assert items[k] > updates[k + 1], f"step {k}'s loss fetched before step {k + 1} ran"
    assert len(perf.records) == steps - 1 and "device_mb_in_use" not in perf.records[0]
    assert perf.records[0]["samples_per_sec"] > 0


def test_on_fit_end_fires_when_fit_raises_and_a_raising_hook_starves_none():
    _, tnet, x, y = _pair("graph")
    ended = []

    class Boom(TLS.TrainingListener):
        def iteration_done(self, model, iteration, score, etl_time=0.0):
            raise RuntimeError("listener failure")

        def on_fit_end(self, model):
            ended.append("boom")
            raise OSError("cleanup failure")

    class Clean(TLS.TrainingListener):
        def on_fit_end(self, model):
            ended.append("clean")

    tnet.add_listener(Boom(), Clean())
    with pytest.raises(RuntimeError, match="listener failure"):
        tnet.fit(x, y, batch_size=4)
    assert ended == ["boom", "clean"]


def test_evaluative_time_and_profiler_listeners(tmp_path):
    _, tnet, x, y = _pair("mln")
    lines = []
    ev = TLS.EvaluativeListener(x[:6], y[:6], frequency=2,
                                evaluator=lambda p, l: float((p.argmax(-1).numpy()
                                                              == l.argmax(-1)).mean()))
    eta = TLS.TimeIterationListener(6, frequency=3, print_fn=lines.append)
    prof = TLS.ProfilerListener(tmp_path / "trace", start_iteration=2, n_iterations=2,
                                print_fn=lines.append)
    tnet.add_listener(ev, eta, prof)
    tnet.fit(x, y, batch_size=4)
    assert [it for it, _ in ev.results] == [2, 4, 6]
    assert any("ETA" in s for s in lines)
    assert prof.completed and prof.traced_iterations == 2
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    # a window the fit ends inside is closed by on_fit_end
    cut = TLS.ProfilerListener(tmp_path / "cut", start_iteration=1, n_iterations=50,
                               print_fn=lines.append)
    _, t2, _, _ = _pair("mln")
    t2.add_listener(cut)
    t2.fit(x, y, batch_size=4)
    assert cut.completed and "truncated" in lines[-1]


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------

def _es_config(mod, xv, yv, saver=None, **terms):
    return mod.EarlyStoppingConfiguration(
        score_calculator=mod.DataSetLossCalculator(xv, yv),
        epoch_terminations=(mod.MaxEpochsTermination(terms.get("max_epochs", 8)),
                            mod.ScoreImprovementEpochsTermination(terms.get("patience", 2))),
        saver=saver or mod.InMemoryModelSaver())


@pytest.mark.parametrize("kind,lr", [("mln", 2.0), ("graph", 0.5)])
def test_early_stopping_matches_jax_in_float64(kind, lr):
    jnet, tnet, x, y = _pair(kind, dtype=np.float64)
    upd = {"updater": JU.Sgd(learning_rate=lr)}
    jnet.conf = dataclasses.replace(jnet.conf, **upd)
    tnet.conf = dataclasses.replace(tnet.conf, updater=TU.Sgd(learning_rate=lr))
    rs = np.random.RandomState(9)
    xv = rs.randn(12, 5)
    yv = np.eye(3)[rs.randint(0, 3, 12)]
    jr = JES.EarlyStoppingTrainer(_es_config(JES, xv, yv), jnet, x, y, batch_size=8).fit()
    tcfg = _es_config(TES, xv, yv)
    tr = TES.EarlyStoppingTrainer(tcfg, tnet, x, y, batch_size=8).fit()
    assert (tr.termination_reason, tr.termination_details, tr.total_epochs, tr.best_epoch) == \
        (jr.termination_reason, jr.termination_details, jr.total_epochs, jr.best_epoch)
    np.testing.assert_allclose(tr.best_score, jr.best_score, rtol=ES_RTOL)
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    np.testing.assert_allclose([tr.score_vs_epoch[e] for e in sorted(tr.score_vs_epoch)],
                               [jr.score_vs_epoch[e] for e in sorted(jr.score_vs_epoch)],
                               rtol=ES_RTOL)
    # the restored best model scores what was recorded, and the snapshot
    # survives a second restore
    assert tr.best_model is tnet
    assert tr.best_model.score(xv, yv) == tr.best_score
    tcfg.saver.restore_best(tnet)
    assert tnet.score(xv, yv) == tr.best_score


def test_iteration_termination_and_local_file_saver(tmp_path):
    jnet, tnet, x, y = _pair("mln", dtype=np.float64)
    rs = np.random.RandomState(9)
    xv, yv = rs.randn(6, 5), np.eye(3)[rs.randint(0, 3, 6)]
    cfg = TES.EarlyStoppingConfiguration(
        score_calculator=TES.DataSetLossCalculator(xv, yv),
        epoch_terminations=(TES.MaxEpochsTermination(2),),
        iteration_terminations=(TES.MaxScoreIterationTermination(1e9),),
        saver=TES.LocalFileModelSaver(str(tmp_path)), save_last_model=True)
    res = TES.EarlyStoppingTrainer(cfg, tnet, x, y, batch_size=8).fit()
    assert res.termination_details == "MaxEpochsTermination" and res.total_epochs == 2
    assert (tmp_path / "bestModel.zip").exists() and (tmp_path / "latestModel.zip").exists()
    # the checkpoint loads in the policy's float32
    np.testing.assert_allclose(res.best_model.score(xv, yv), res.best_score, rtol=1e-6)
    cfg2 = TES.EarlyStoppingConfiguration(
        score_calculator=TES.DataSetLossCalculator(xv, yv),
        iteration_terminations=(TES.MaxScoreIterationTermination(-1.0),))
    res2 = TES.EarlyStoppingTrainer(cfg2, tnet, x, y).fit()
    assert res2.termination_reason == "IterationTermination"
    assert TES.BestScoreTermination(5.0).terminate_epoch(1, 4.0, 4.0)
    assert not TES.MaxTimeTermination(3600).terminate_epoch(1, 1.0, 1.0)
