"""The port's transfer learning against the JAX package, on the CPU.

Both builders on small networks: a fused, ResNet-shaped graph at 32 px
(stem, two stages of two bottlenecks, every conv -> BN chain of the
bottlenecks a ``FusedConvBNVertex``; the JAX vertex takes its XLA path on
the CPU, the port's the conv kernels' plain versions) and a small
MultiLayerNetwork. Both packages start from the JAX source network's
weights and state (random BN running statistics, so a frozen BN's
inference mode shows), build the transferred network, take the JAX
package's fresh head, and fit two steps in float64.

Tolerances: the unfrozen parameters, every state tensor and the loss after
the two steps rtol 1e-9 + atol 1e-12 (+1e-12 of the tensor's largest
magnitude: a gradient that cancels keeps rounding-sized values). The
updater is SGD at 0.0625, whose step is exact in float32 (the port
computes an updater's scalar factors in float32) and linear in the
gradient. Frozen parameters and frozen BN state equal the source's bit for
bit. The frozen vertices' updater state is the one held divergence: the
port leaves it as initialized (DL4J's FrozenLayer trains with a no-op
updater), the JAX package advances it and then restores the parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import resnet as JR
from deeplearning4j_tpu.models import resnet50 as j_resnet50
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import transfer as JT
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import dtypes as jdt
from deeplearning4j_tpu_torch.models import resnet as TR
from deeplearning4j_tpu_torch.models import resnet50 as t_resnet50
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import transfer as TT
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import GraphBuilder as TGB
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import flatten_tree

RTOL, ATOL, ATOL_REL = 1e-9, 1e-12, 1e-12
LR = 0.0625  # exact in float32


def _np(tree):
    """{keystr path: float64 ndarray} of a JAX or port tree."""
    return {k: (v.detach().double().numpy() if torch.is_tensor(v) else np.asarray(v, np.float64))
            for k, v in flatten_tree(jax.tree_util.tree_map(lambda a: a, tree)).items()}


def _close(got, want, what):
    g, w = _np(got), _np(want)
    assert set(g) == set(w), what
    for k in w:
        scale = float(np.abs(w[k]).max()) if w[k].size else 0.0
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL + ATOL_REL * scale,
                                   err_msg=f"{what} {k}")


def _equal(got, want, what):
    g, w = _np(got), _np(want)
    assert set(g) == set(w), what
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


class _f64_policy:
    """Both packages' parameter and compute dtypes at float64 (a builder's
    fresh layers initialise in the policy's dtype in the JAX package)."""

    def __enter__(self):
        jdt.set_policy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                       accum_dtype=jnp.float64)

    def __exit__(self, *exc):
        jdt.f32_policy()


def _mini_resnet(R, GB, L, I, U):
    g = GB(updater=U.Adam(learning_rate=1e-3), seed=3)
    g.add_inputs("input")
    g.set_input_types(I.ConvolutionalType(32, 32, 3))
    x = R._conv_bn(g, "stem", "input", 8, (3, 3), stride=(2, 2))
    g.add_layer("stem_pool", L.SubsamplingLayer(kernel=(3, 3), stride=(2, 2), padding="same",
                                                mode="max"), x)
    x = "stem_pool"
    for si, (filters, stride) in enumerate([(8, (1, 1)), (16, (2, 2))]):
        for bi in range(2):
            x = R._bottleneck(g, f"s{si}b{bi}", x, filters, stride=stride if bi == 0 else (1, 1),
                              project=bi == 0, fused=True)
    g.add_layer("avgpool", L.GlobalPoolingLayer(mode="avg"), x)
    g.add_layer("fc", L.OutputLayer(n_out=10, loss="mcxent"), "avgpool")
    g.set_outputs("fc")
    return g.build()


def _random_state(state, rs):
    """BN running statistics away from their init (mean ~ N(0, 0.1), var in
    [0.5, 1.5]); other state as it is."""
    def one(k, v):
        if k == "mean":
            return jnp.asarray(0.1 * rs.randn(*v.shape))
        if k == "var":
            return jnp.asarray(0.5 + rs.rand(*v.shape))
        return v
    return {n: {k: one(k, v) for k, v in s.items()} for n, s in state.items()}


def _sources(graph=True):
    """(JAX source, port source) with the same float64 weights and state."""
    rs = np.random.RandomState(0)
    if graph:
        jsrc = JGraph(_mini_resnet(JR, JGB, JL, JI, JU))
        jsrc.init()
        jsrc.params, jsrc.state = _f64(jsrc.params), _random_state(_f64(jsrc.state), rs)
        tsrc = TGraph(_mini_resnet(TR, TGB, TL, TI, TU), device="cpu")
    else:
        jsrc = JNet(_mlp(JConf, JL, JI, JU))
        jsrc.init()
        jsrc.params = _f64(jsrc.params)
        jsrc.state = [{k: jnp.asarray(0.1 * rs.randn(*v.shape) if k == "mean"
                                      else 0.5 + rs.rand(*v.shape)) for k, v in s.items()}
                      for s in _f64(jsrc.state)]
        tsrc = TNet(_mlp(TConf, TL, TI, TU), device="cpu")
    tsrc.init(dtype=torch.float64)
    tser.params_from_numpy(tsrc, jax.tree_util.tree_map(np.asarray, jsrc.params),
                           state=jax.tree_util.tree_map(np.asarray, jsrc.state))
    return jsrc, tsrc


def _mlp(C, L, I, U):
    return C(seed=4, updater=U.Adam(learning_rate=1e-3)).list(
        L.DenseLayer(n_out=6, activation="tanh"), L.BatchNormalization(),
        L.DenseLayer(n_out=5, activation="relu"), L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(4))


def _data(n, shape, classes, seed=1):
    rs = np.random.RandomState(seed)
    return rs.rand(n, *shape), np.eye(classes)[rs.randint(0, classes, n)]


def _load_head(tnet, jnet):
    """The JAX transferred net's weights (its fresh head included) into the
    port's, after checking the port copied the kept vertices itself."""
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
                           state=jax.tree_util.tree_map(np.asarray, jnet.state))


# ---------------------------------------------------------------------------
# the graph builder
# ---------------------------------------------------------------------------

def _graph_pair(updater_lr=LR):
    jsrc, tsrc = _sources()
    with _f64_policy():
        jnet = (JT.TransferLearningGraph(jsrc)
                .fine_tune_configuration(JT.FineTuneConfiguration(
                    updater=JU.Sgd(learning_rate=updater_lr), seed=7))
                .set_feature_extractor("s0b1_relu")
                .replace_layer("fc", JL.OutputLayer(n_out=4, loss="mcxent")).build())
    tnet = (TT.TransferLearningGraph(tsrc)
            .fine_tune_configuration(TT.FineTuneConfiguration(
                updater=TU.Sgd(learning_rate=updater_lr), seed=7))
            .set_feature_extractor("s0b1_relu")
            .replace_layer("fc", TL.OutputLayer(n_out=4, loss="mcxent")).build())
    return jsrc, tsrc, jnet, tnet


def test_graph_fine_tune_two_steps_match_jax_in_float64():
    jsrc, tsrc, jnet, tnet = _graph_pair()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tnet.frozen_vertices == jnet.frozen_vertices
    frozen = sorted(tnet.frozen_vertices)
    assert "stem_conv" in frozen and "s0b1_relu" in frozen and "s1b0_a_bn" not in frozen
    # the kept vertices are real copies of the source
    for name in tnet.params:
        if name == "fc":
            continue
        _equal(tnet.params[name], tsrc.params[name], name)
        for t, s in zip(tnet.params[name].values(), tsrc.params[name].values()):
            assert t.data_ptr() != s.data_ptr()
    _load_head(tnet, jnet)
    x, y = _data(8, (32, 32, 3), 4)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    assert tnet.iteration == jnet.iteration == 2
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=RTOL)
    trained = [n for n in tnet.params if n not in tnet.frozen_vertices]
    _close({n: tnet.params[n] for n in trained}, {n: jnet.params[n] for n in trained},
           "unfrozen parameter")
    _close(tnet.state, jnet.state, "state")
    for n in frozen:
        _equal(tnet.params[n], tsrc.params[n], f"frozen parameter {n}")
        _equal(tnet.state[n], tsrc.state[n], f"frozen state {n}")
        _equal(jnet.params[n], jsrc.params[n], f"JAX frozen parameter {n}")


def test_graph_freezing_runs_no_backward_through_the_prefix():
    _, _, _, tnet = _graph_pair()
    x, y = _data(4, (32, 32, 3), 4)
    loss, _, grads = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                            torch.from_numpy(y))
    for n in tnet.frozen_vertices:
        assert grads[n] == {}
        assert not any(p.requires_grad for p in tnet.params[n].values())
    assert all(len(grads[n]) for n in ("s1b0_a_bn", "fc"))


def test_frozen_fused_vertices_launch_no_conv_kernel(monkeypatch):
    """A fine-tune step calls the conv-statistics op for the unfrozen fused
    vertices only (its plain version here, the kernel on the card)."""
    from deeplearning4j_tpu_torch.nn import fusion as TF

    _, _, _, tnet = _graph_pair()
    calls = []
    orig = TF.FusedConvBNVertex.apply

    def counting(self, params, state, xs, *, train=False, **kw):
        calls.append(train)
        return orig(self, params, state, xs, train=train, **kw)

    monkeypatch.setattr(TF.FusedConvBNVertex, "apply", counting)
    x, y = _data(4, (32, 32, 3), 4)
    tnet.fit(x, y)
    fused = [n for n, v in tnet._defs.items() if isinstance(v.vertex, TF.FusedConvBNVertex)]
    unfrozen = [n for n in fused if n not in tnet.frozen_vertices]
    assert calls.count(True) == len(unfrozen) == 7
    assert calls.count(False) == len(fused) - len(unfrozen)


def test_graph_frozen_updater_state_is_held_untouched():
    """The held divergence: with Adam, the port leaves the frozen vertices'
    updater state as initialized (DL4J FrozenLayer: a no-op updater); the
    JAX package advances it. Their parameters stay the source's in both."""
    jsrc, tsrc = _sources()
    with _f64_policy():
        jnet = (JT.TransferLearningGraph(jsrc)
                .fine_tune_configuration(JT.FineTuneConfiguration(updater=JU.Adam(1e-2)))
                .set_feature_extractor("s0b1_relu").build())
    tnet = (TT.TransferLearningGraph(tsrc)
            .fine_tune_configuration(TT.FineTuneConfiguration(updater=TU.Adam(1e-2)))
            .set_feature_extractor("s0b1_relu").build())
    x, y = _data(8, (32, 32, 3), 10)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    for n in tnet.frozen_vertices:
        if not len(tnet.params[n]):
            continue
        for part in ("m", "v"):
            assert all(np.all(a == 0) for a in _np(tnet.opt_state[part][n]).values()), n
        assert any(np.any(a != 0) for a in _np(jnet.opt_state["m"][n]).values()), n
        _equal(tnet.params[n], tsrc.params[n], n)
        _equal(jnet.params[n], jsrc.params[n], n)
    assert any(np.any(a != 0) for a in _np(tnet.opt_state["m"]["fc"]).values())


def test_set_feature_extractor_on_resnet50_freezes_the_jax_set():
    jcg = JGraph(j_resnet50(32, 32, n_classes=10, fused=True))
    jcg.params = {}  # the builder only checks that the source is initialized
    jset = JT.TransferLearningGraph(jcg).set_feature_extractor("s2b5_relu")._frozen
    tcg = TGraph(t_resnet50(32, 32, n_classes=10, fused=True), device="cpu")
    tcg.init()
    tset = TT.TransferLearningGraph(tcg).set_feature_extractor("s2b5_relu")._frozen
    assert tcg._order == jcg._order
    assert tset == jset and len(tset) == 45


def test_shape_mismatch_keeps_fresh_init_and_frozen_replaced_raises():
    def graph(GB, L, I, U):
        g = GB(updater=U.Sgd(learning_rate=0.1), seed=2)
        g.add_inputs("in")
        g.set_input_types(I.FeedForwardType(4))
        g.add_layer("d1", L.DenseLayer(n_out=6, activation="tanh"), "in")
        g.add_layer("d2", L.DenseLayer(n_out=5, activation="tanh"), "d1")
        g.add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "d2")
        g.set_outputs("out")
        return g.build()

    jsrc = JGraph(graph(JGB, JL, JI, JU))
    jsrc.init()
    tsrc = TGraph(graph(TGB, TL, TI, TU), device="cpu")
    tsrc.init()
    jnet = JT.TransferLearningGraph(jsrc).replace_layer("d1", JL.DenseLayer(n_out=7)).build()
    tnet = TT.TransferLearningGraph(tsrc).replace_layer("d1", TL.DenseLayer(n_out=7)).build()
    assert tuple(tnet.params["d2"]["W"].shape) == tuple(jnet.params["d2"]["W"].shape) == (7, 5)
    _equal(tnet.params["out"], tsrc.params["out"], "out")
    np.testing.assert_array_equal(np.asarray(jnet.params["out"]["W"]),
                                  np.asarray(jsrc.params["out"]["W"]))
    for mod, src, layer in ((JT, jsrc, JL.DenseLayer(n_out=7)),
                            (TT, tsrc, TL.DenseLayer(n_out=7))):
        with pytest.raises(ValueError, match="both frozen and replaced"):
            mod.TransferLearningGraph(src).set_feature_extractor("d2") \
                .replace_layer("d1", layer).build()


def test_fine_tune_configuration_overrides_match_jax():
    jsrc, tsrc = _sources()
    kw = dict(l1=0.01, l2=0.02, dropout=0.1, seed=9)
    jconf = JT.TransferLearningGraph(jsrc).fine_tune_configuration(JT.FineTuneConfiguration(
        updater=JU.Nesterovs(learning_rate=0.05), **kw)).build().conf
    tconf = TT.TransferLearningGraph(tsrc).fine_tune_configuration(TT.FineTuneConfiguration(
        updater=TU.Nesterovs(learning_rate=0.05), **kw)).build().conf
    assert tconf.to_json() == jconf.to_json()
    assert tconf.seed == 9 and isinstance(tconf.updater, TU.Nesterovs)
    pool = next(v.vertex.layer for v in tconf.vertices if v.name == "stem_pool")
    fc = next(v.vertex.layer for v in tconf.vertices if v.name == "fc")
    assert (fc.l1, fc.l2, fc.dropout) == (0.01, 0.02, 0.1) and pool.dropout == 0.1
    jm, tm = _sources(graph=False)
    jmc = JT.TransferLearning(jm).fine_tune_configuration(JT.FineTuneConfiguration(
        updater=JU.Sgd(learning_rate=0.3), **kw)).build().conf
    tmc = TT.TransferLearning(tm).fine_tune_configuration(TT.FineTuneConfiguration(
        updater=TU.Sgd(learning_rate=0.3), **kw)).build().conf
    assert tmc.to_json() == jmc.to_json()


# ---------------------------------------------------------------------------
# the MultiLayerNetwork builder and the helper
# ---------------------------------------------------------------------------

def _mln_pair():
    jsrc, tsrc = _sources(graph=False)
    ftc = dict(l2=1e-3, seed=5)
    with _f64_policy():
        jnet = (JT.TransferLearning(jsrc)
                .fine_tune_configuration(JT.FineTuneConfiguration(
                    updater=JU.Sgd(learning_rate=LR), **ftc))
                .set_feature_extractor(1)
                .replace_layer(3, JL.OutputLayer(n_out=4, loss="mcxent")).build())
    tnet = (TT.TransferLearning(tsrc)
            .fine_tune_configuration(TT.FineTuneConfiguration(updater=TU.Sgd(learning_rate=LR),
                                                              **ftc))
            .set_feature_extractor(1)
            .replace_layer(3, TL.OutputLayer(n_out=4, loss="mcxent")).build())
    return jsrc, tsrc, jnet, tnet


def test_mln_fine_tune_two_steps_match_jax_in_float64():
    jsrc, tsrc, jnet, tnet = _mln_pair()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert tuple(tnet.frozen_layers) == tuple(jnet.frozen_layers) == (0, 1)
    for i in range(3):
        _equal(tnet.params[i], tsrc.params[i], f"layer {i}")
    _load_head(tnet, jnet)
    x, y = _data(8, (4,), 4)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=RTOL)
    _close(tnet.params[2:], jnet.params[2:], "unfrozen parameter")
    _close(tnet.state, jnet.state, "state")
    for i in (0, 1):
        _equal(tnet.params[i], tsrc.params[i], f"frozen parameter {i}")
        _equal(tnet.state[i], tsrc.state[i], f"frozen state {i}")


def test_mln_frozen_updater_state_is_held_untouched():
    jsrc, tsrc = _sources(graph=False)
    jnet = JT.TransferLearning(jsrc).set_feature_extractor(0).build()
    tnet = TT.TransferLearning(tsrc).set_feature_extractor(0).build()
    x, y = _data(8, (4,), 3)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    assert all(np.all(a == 0) for a in _np(tnet.opt_state["m"][0]).values())
    assert any(np.any(a != 0) for a in _np(jnet.opt_state["m"][0]).values())
    assert any(np.any(a != 0) for a in _np(tnet.opt_state["m"][2]).values())
    _equal(tnet.params[0], tsrc.params[0], "frozen layer")


def test_helper_featurize_and_unfrozen_net_match_jax():
    jsrc, tsrc = _sources(graph=False)
    x, y = _data(6, (4,), 3, seed=3)
    jh, th = JT.TransferLearningHelper(jsrc, 1), TT.TransferLearningHelper(tsrc, 1)
    feats_j, feats_t = jh.featurize(jnp.asarray(x)), th.featurize(x)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), rtol=RTOL, atol=ATOL)
    jtail, ttail = jh.unfrozen_net(), th.unfrozen_net()
    assert ttail.conf.to_json() == jtail.conf.to_json()
    _equal(ttail.params, jtail.params, "tail parameters")
    for t, s in zip(ttail.params[0].values(), tsrc.params[2].values()):
        assert t.data_ptr() != s.data_ptr()
    np.testing.assert_allclose(ttail.output(feats_t).numpy(),
                               np.asarray(jtail.output(feats_j)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ttail.output(feats_t).numpy(), tsrc.output(x).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_checkpoint_saves_no_frozen_set(tmp_path):
    _, _, _, tnet = _mln_pair()
    path = tser.save_model(tnet, str(tmp_path / "m.zip"))
    restored = tser.load_model(path, device="cpu")
    assert tuple(restored.frozen_layers) == ()
    assert dataclasses.asdict(restored.conf) == dataclasses.asdict(tnet.conf)
