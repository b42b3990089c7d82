"""The port's graph vertices, LRN, the center-loss head, the conv kernel
shapes of the Inception models, graph modules, ``feed_forward`` and the
remat segments, against the JAX package on the same numpy inputs.

Tolerances: vertices f32 atol 1e-6 (each is a handful of elementwise
operations, a concatenation or a reshape; the sums of L2Normalize and L2
run over at most 48 values); LRN f32 atol 1e-6 (a sum of n squares, then a
power); the convolutions f32 atol 1e-5 (sums of up to 7 * 6 = 42 products
in another order, the conv layers' tolerance in ``test_torch_conv.py``);
CenterLossOutputLayer in float64 to 1e-10 (the same few operations in
another order); ``feed_forward`` of a small Inception-ResNet v1 in float64
to rtol 1e-9 (the zoo's step tolerance, ``test_torch_zoo.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import models as JM
from deeplearning4j_tpu.nn import graph as JG
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu_torch import models as TM
from deeplearning4j_tpu_torch.nn import graph as TG
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.utils import serialization as tser

FF, CNN, RNN = "ff", "cnn", "rnn"


def _types(mod, kind):
    return {FF: mod.FeedForwardType(6), CNN: mod.ConvolutionalType(3, 4, 6),
            RNN: mod.RecurrentType(6, 5)}[kind]


def _shape(kind, batch=4):
    return {FF: (batch, 6), CNN: (batch, 3, 4, 6), RNN: (batch, 5, 6)}[kind]


# (case id, vertex class name, fields, input kinds)
VERTEX_CASES = [
    ("merge_ff", "MergeVertex", {}, (FF, FF, FF)),
    ("merge_cnn", "MergeVertex", {}, (CNN, CNN)),
    ("merge_rnn", "MergeVertex", {}, (RNN, RNN)),
    ("subset_ff", "SubsetVertex", {"from_idx": 1, "to_idx": 3}, (FF,)),
    ("subset_cnn", "SubsetVertex", {"from_idx": 2, "to_idx": 5}, (CNN,)),
    ("subset_rnn", "SubsetVertex", {"from_idx": 0, "to_idx": 0}, (RNN,)),
    ("stack", "StackVertex", {}, (CNN, CNN, CNN)),
    ("unstack", "UnstackVertex", {"index": 1, "stack_size": 2}, (FF,)),
    ("scale", "ScaleVertex", {"factor": 0.17}, (CNN,)),
    ("shift", "ShiftVertex", {"amount": -0.5}, (RNN,)),
    ("l2normalize_ff", "L2NormalizeVertex", {}, (FF,)),
    ("l2normalize_cnn", "L2NormalizeVertex", {"eps": 1e-3}, (CNN,)),
    ("l2", "L2Vertex", {}, (CNN, CNN)),
    ("reshape", "ReshapeVertex", {"shape": (6, 12)}, (CNN,)),
    ("duplicate_to_time_series", "DuplicateToTimeSeriesVertex", {"timesteps": 7}, (FF,)),
    ("pool_helper", "PoolHelperVertex", {}, (CNN,)),
    ("preprocessor_cnn_to_ff", "PreprocessorVertex", {"kind": "cnn_to_ff"}, (CNN,)),
    ("preprocessor_ff_to_cnn", "PreprocessorVertex",
     {"kind": "ff_to_cnn", "height": 1, "width": 2, "channels": 3}, (FF,)),
    ("preprocessor_rnn_to_ff", "PreprocessorVertex", {"kind": "rnn_to_ff"}, (RNN,)),
    ("preprocessor_ff_to_rnn", "PreprocessorVertex", {"kind": "ff_to_rnn", "timesteps": 2},
     (FF,)),
    ("preprocessor_cnn_to_rnn", "PreprocessorVertex", {"kind": "cnn_to_rnn"}, (CNN,)),
    ("last_time_step", "LastTimeStepVertex", {}, (RNN,)),
] + [(f"elementwise_{op}", "ElementWiseVertex", {"op": op},
      (CNN, CNN) if op == "subtract" else (CNN, CNN, CNN))
     for op in ("add", "subtract", "product", "average", "max")]


@pytest.mark.parametrize("cls,fields,kinds", [c[1:] for c in VERTEX_CASES],
                         ids=[c[0] for c in VERTEX_CASES])
def test_vertex_matches_jax(cls, fields, kinds):
    jv, tv = getattr(JG, cls)(**fields), getattr(TG, cls)(**fields)
    jt = jv.output_type([_types(JI, k) for k in kinds])
    tt = tv.output_type([_types(TI, k) for k in kinds])
    assert type(tt).__name__ == type(jt).__name__ and tt.shape(4) == jt.shape(4)
    rs = np.random.RandomState(0)
    xs = [rs.randn(*_shape(k)).astype(np.float32) for k in kinds]
    yj, sj = jv.apply({}, {}, [jnp.asarray(x) for x in xs])
    yt, st = tv.apply({}, {}, [torch.from_numpy(x) for x in xs])
    assert st == {} and sj == {}
    assert tuple(yt.shape) == tuple(yj.shape)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6, rtol=0)
    # the vertex's class and fields survive the other package's JSON
    assert TG.GraphConfiguration.from_json(
        JG.GraphBuilder().add_inputs("x").set_input_types(JI.FeedForwardType(6))
        .add_vertex("v", jv, "x").set_outputs("v").build().to_json()).vertices[0].vertex == tv


def test_last_time_step_vertex_takes_the_mask():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 4).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)
    yj, _ = JG.LastTimeStepVertex().apply({}, {}, [jnp.asarray(x)], mask=jnp.asarray(mask))
    yt, _ = TG.LastTimeStepVertex().apply({}, {}, [torch.from_numpy(x)],
                                          mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


# ---------------------------------------------------------------------------
# layers of the Inception models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,alpha,beta", [(3, 2.0, 1e-4, 0.75), (4, 1.0, 0.3, 0.5),
                                            (5, 2.0, 1e-4, 0.75), (5, 0.5, 0.1, 1.2)],
                         ids=["n3", "n4", "n5", "n5_wide"])
def test_lrn_matches_jax(n, k, alpha, beta):
    rs = np.random.RandomState(n)
    x = (3 * rs.randn(2, 5, 4, 9)).astype(np.float32)
    yj, _ = JL.LocalResponseNormalization(n=n, k=k, alpha=alpha, beta=beta).apply(
        {}, {}, jnp.asarray(x))
    yt, _ = TL.LocalResponseNormalization(n=n, k=k, alpha=alpha, beta=beta).apply(
        {}, {}, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6, rtol=0)
    # not torch's local_response_norm, which divides alpha by n
    other = torch.nn.functional.local_response_norm(torch.from_numpy(x).permute(0, 3, 1, 2), n,
                                                    alpha=alpha, beta=beta, k=k)
    assert not np.allclose(other.permute(0, 2, 3, 1).numpy(), np.asarray(yj), atol=1e-6)


@pytest.mark.parametrize("kernel,stride", [((1, 7), (1, 1)), ((7, 1), (1, 1)),
                                           ((1, 3), (1, 1)), ((3, 1), (1, 1)),
                                           ((5, 5), (1, 1)), ((5, 5), (2, 2)),
                                           ((3, 3), (2, 2))],
                         ids=["1x7", "7x1", "1x3", "3x1", "5x5", "5x5s2", "3x3s2"])
def test_same_conv_kernel_shapes_match_jax(kernel, stride):
    """The Inception blocks' non-square and 5x5 SAME convolutions (the odd
    pad at the high end, as XLA pads) and their gradients."""
    rs = np.random.RandomState(0)
    it = (9, 8, 5)
    x = rs.randn(2, *it).astype(np.float32)
    jl = JL.ConvolutionLayer(n_out=6, kernel=kernel, stride=stride, padding="same")
    tl = TL.ConvolutionLayer(n_out=6, kernel=kernel, stride=stride, padding="same")
    jp = jl.init(jax.random.PRNGKey(0), JI.ConvolutionalType(*it))
    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in jp.items()}
    assert tl.output_type(TI.ConvolutionalType(*it)).shape(2) == \
        jl.output_type(JI.ConvolutionalType(*it)).shape(2)
    yj, vjp = jax.vjp(lambda p: jl.apply(p, {}, jnp.asarray(x))[0], jp)
    yt, _ = tl.apply(tp, {}, torch.from_numpy(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    cot = rs.randn(*yj.shape).astype(np.float32)
    gj, = vjp(jnp.asarray(cot))
    yt.backward(torch.from_numpy(cot))
    for key in jp:
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(gj[key]), atol=1e-4,
                                   rtol=1e-5, err_msg=key)


def test_center_loss_matches_jax_in_float64():
    """Loss, gradients (W, b and the features) and the new centers, the
    centers gathered by argmax(labels) from state with no gradient."""
    rs = np.random.RandomState(0)
    n_in, n_out, b = 6, 4, 8
    jl = JL.CenterLossOutputLayer(n_out=n_out, lambda_=0.3, alpha=0.7)
    tl = TL.CenterLossOutputLayer(n_out=n_out, lambda_=0.3, alpha=0.7)
    params = {"W": rs.randn(n_in, n_out), "b": rs.randn(n_out)}
    centers = rs.randn(n_out, n_in)
    feats = rs.randn(b, n_in)
    labels = np.eye(n_out)[[0, 1, 1, 3, 0, 1, 3, 3]]  # class 2 absent: its count clamps at 1

    def jloss(p, f):
        loss, preds, st = jl.loss_from_features(p, {"centers": jnp.asarray(centers)}, f,
                                                jnp.asarray(labels))
        return loss, (preds, st)

    (lj, (pj, sj)), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tf = torch.from_numpy(feats).requires_grad_(True)
    lt, pt, st = tl.loss_from_features(tp, {"centers": torch.from_numpy(centers)}, tf,
                                       torch.from_numpy(labels))
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-10, atol=1e-12)
    for key in params:
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(gj[0][key]), rtol=1e-10,
                                   atol=1e-12, err_msg=key)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gj[1]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st["centers"].numpy(), np.asarray(sj["centers"]), rtol=1e-10,
                               atol=1e-12)
    assert not st["centers"].requires_grad
    np.testing.assert_array_equal(st["centers"][2].numpy(), centers[2])
    # eval mode keeps the centers
    _, _, kept = tl.loss_from_features(tp, {"centers": torch.from_numpy(centers)}, tf,
                                       torch.from_numpy(labels), train=False)
    np.testing.assert_array_equal(kept["centers"].numpy(), centers)


def test_residual_bottleneck_matches_jax_in_float64():
    """The composite layer in train mode (projection shortcut, stride 2):
    output, nested BN state, gradients."""
    it = (6, 6, 8)
    jl, tl = (m.ResidualBottleneck(filters=4, stride=(2, 2)) for m in (JL, TL))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                jl.init(jax.random.PRNGKey(1), JI.ConvolutionalType(*it)))
    js = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                jl.init_state(JI.ConvolutionalType(*it)))
    x = np.random.RandomState(2).randn(3, *it)
    (yj, sj), vjp = jax.vjp(lambda p: jl.apply(p, js, jnp.asarray(x), train=True), jp)
    gj, = vjp((jnp.ones_like(yj), jax.tree_util.tree_map(jnp.zeros_like, sj)))
    tp = {k: {n: torch.from_numpy(np.asarray(a)).requires_grad_(True) for n, a in d.items()}
          for k, d in jp.items()}
    ts = {k: {n: torch.from_numpy(np.asarray(a)) for n, a in d.items()} for k, d in js.items()}
    yt, st = tl.apply(tp, ts, torch.from_numpy(x), train=True)
    yt.sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-10, atol=1e-12)
    assert set(st) == set(sj) == {"a_bn", "b_bn", "c_bn", "proj_bn"}
    for k in sj:
        for n in sj[k]:
            np.testing.assert_allclose(st[k][n].numpy(), np.asarray(sj[k][n]), rtol=1e-10,
                                       atol=1e-12)
    for k in jp:
        for n in jp[k]:
            np.testing.assert_allclose(tp[k][n].grad.numpy(), np.asarray(gj[k][n]), rtol=1e-9,
                                       atol=1e-12, err_msg=f"{k}/{n}")
    assert tl.output_type(TI.ConvolutionalType(*it)).shape(1) == (1, 3, 3, 16)


# ---------------------------------------------------------------------------
# the graph: modules, feed_forward, segments
# ---------------------------------------------------------------------------

def test_inception_module_builds_the_jax_fragment():
    def conf(G, I, module):
        g = G.GraphBuilder().add_inputs("in").set_input_types(I.ConvolutionalType(8, 8, 16))
        g.add_module(module, "3a", 16, ((8,), (4, 8), (2, 4), (4,)), "in")
        return g.set_outputs(g.last_vertex_name()).build()

    j = conf(JG, JI, JM.inception.InceptionModule())
    t = conf(TG, TI, TM.InceptionModule())
    assert t.to_json() == j.to_json()
    assert t.vertex_types()["inception-3a-depthconcat"].channels == 8 + 8 + 4 + 4


def _small_irv1(mod):
    return mod.inception_resnet_v1(height=96, width=96, n_classes=5, blocks_a=1, blocks_b=1,
                                   blocks_c=1)


def test_feed_forward_gives_every_vertex_like_jax():
    jnet = JG.ComputationGraph(_small_irv1(JM))
    jnet.init()
    jnet.params, jnet.state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), (jnet.params, jnet.state))
    tnet = TG.ComputationGraph(_small_irv1(TM), device="cpu")
    tnet.init(dtype=torch.float64)
    tser.params_from_numpy(tnet, jnet.params, state=jnet.state)
    x = np.random.RandomState(0).rand(2, 96, 96, 3)
    aj, at = jnet.feed_forward(jnp.asarray(x)), tnet.feed_forward(x)
    assert set(at) == set(aj) == {"input"} | {v.name for v in tnet.conf.vertices}
    for name in aj:
        np.testing.assert_allclose(at[name].numpy(), np.asarray(aj[name]), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(at["embeddings"].norm(dim=1).numpy(), 1.0, atol=1e-12)
    # the head in eval mode: softmax rows, the output of ``output``
    np.testing.assert_array_equal(tnet.output(x).numpy(), at["lossLayer"].numpy())


@pytest.mark.parametrize("which", ["resnet50", "resnet50_fused", "inception_resnet_v1"])
def test_remat_segments_are_the_jax_packages(which):
    if which == "inception_resnet_v1":
        jc, tc = (dataclasses.replace(m.inception_resnet_v1(), checkpoint_scope="prefix")
                  for m in (JM, TM))
    else:
        jc, tc = (m.resnet50(n_classes=10, fused=which.endswith("fused"),
                             checkpoint_scope="prefix") for m in (JM, TM))
    segs = TG.ComputationGraph(tc, device="cpu")._segments
    assert segs == JG.ComputationGraph(jc)._segments
    groups = [s for s in segs if s[0] == "group"]
    # the stem and the 16 bottlenecks; Inception-ResNet v1's names hold no '_'
    assert len(groups) == (0 if which == "inception_resnet_v1" else 17)
