"""The port's pipelines of any layer stack or graph (``PipelinedNetwork``,
``PipelinedGraph``; GPipe and 1F1B) against the JAX package.

One spawn of 4 gloo ranks (``tests/torch_dist_model.py
pipeline_general_program``) on stage=4 and data=2 x stage=2. The JAX
package's own tests pin these pipelines to the sequential per-microbatch
run of the network on the same parameters (BN's running state threaded
from microbatch 0 to 1); here the reference is that run of the JAX
network (its ``loss_fn`` and ``jax.grad`` of it, jitted; the gradient is
the mean of the microbatches'), on weights the port initialises and
carries across (the trees are the same in both packages). Each pipeline
takes one SGD step, so its update is its gradient: (before - after) /
learning rate.

- the reduced ResNet50 MLN and the reduced ResNet50 graph (141 vertices,
  skip connections across the cuts) in float64: the loss, every BN
  running statistic and the MLN's every gradient at rtol 1e-9 + atol
  1e-10 (the JAX tests: atol 2e-5, 1e-5 and 5e-5 in float32), the graph's
  gradients each leaf within 1e-7 of its largest (``GRAPH_GRAD``), and
  both schedules' MLN parameters after the step equal at rtol 1e-9;
- the JAX test's long skip connection (d1's output carried across all
  three boundaries to the last stage, an L2 penalty on d2) in float64:
  loss and gradients at the same tolerance;
- the masked LSTM stack on data=2 x stage=2 (no BN, so the pipelined loss
  is the full batch's masked loss) within 2e-5 absolute and its gradients
  within 5e-5 absolute (the JAX tests'), both schedules.

Then the stage balance against the JAX rule, the refusals with the JAX
messages, and the sharded checkpoint round trip (BN state equal, the next
step's loss within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_model as TDM
from deeplearning4j_tpu.models.resnet import resnet50 as j_resnet50
from deeplearning4j_tpu.models.resnet import resnet50_mln as j_resnet50_mln
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JElementWise
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.pipeline_general import balance_graph_stages as j_balance_graph
from deeplearning4j_tpu.parallel.pipeline_general import balance_stages as j_balance
from deeplearning4j_tpu_torch.models.resnet import resnet50, resnet50_mln
from deeplearning4j_tpu_torch.parallel import launch as TL
from deeplearning4j_tpu_torch.parallel import pipeline_general as PG

F64 = dict(rtol=1e-9, atol=1e-10)
# the graph's gradients reach 2e5 at the stem (BN over 1x1 maps of 4 rows),
# and rounding grows with them: the port's float64 gradients differ from
# the JAX package's by up to 1.3e-8 of a leaf's largest here (2e-9 without
# the pipeline, on another batch), so each leaf is held to 1e-7 of its own
GRAPH_GRAD = dict(leaf_rtol=1e-7)
LSTM_GRAD = dict(rtol=0, atol=5e-5)  # the JAX test_gradients_match_sequential's


def _seq_microbatch_run(net, params, state, x, y, n_micro):
    """The JAX tests' sequential per-microbatch reference: the same split,
    the state threaded from microbatch k to k + 1. Returns (mean loss,
    final state, the mean of the microbatches' gradients)."""
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, s, xx, yy: net.loss_fn(p, s, xx, yy, train=True), has_aux=True))
    mb = x.shape[0] // n_micro
    losses, grads = [], []
    for k in range(n_micro):
        sl = slice(k * mb, (k + 1) * mb)
        (loss, (state, _)), g = value_and_grad(params, state, jnp.asarray(x[sl]),
                                               jnp.asarray(y[sl]))
        losses.append(float(loss))
        grads.append(g)
    mean = jax.tree_util.tree_map(lambda *gs: np.mean([np.asarray(a) for a in gs], 0), *grads)
    return float(np.mean(losses)), jax.tree_util.tree_map(np.asarray, state), mean


def _assert_sgd_step(before, after, grads, leaf_rtol=None, **tol):
    """One SGD step's update, (before - after) / the learning rate, against
    the reference gradients, leaf by leaf: elementwise at ``tol``, or with
    ``leaf_rtol`` each leaf within that share of its own largest
    |gradient|. The port's updater scalars are float32 (one table row a
    step), so the rate applied is float32's 0.1."""
    leaves = jax.tree_util.tree_leaves
    lr = float(np.float32(TDM.LR))
    assert len(leaves(after)) == len(leaves(grads))
    for i, (a, b, g) in enumerate(zip(leaves(before), leaves(after), leaves(grads))):
        got = (np.asarray(a) - np.asarray(b)) / lr
        if leaf_rtol is None:
            np.testing.assert_allclose(got, g, **tol)
        else:
            gap = np.abs(got - g).max()
            assert gap <= leaf_rtol * np.abs(g).max(), (i, g.shape, gap, np.abs(g).max())


def _trees(net):
    return TDM._np(net.params), TDM._np(net.state)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rs = np.random.RandomState(0)
    L, _, I, NNC, _ = TDM._modules()
    rn = _trees(TDM._port(TDM.resnet_mln_conf(resnet50_mln), dtype=torch.float64))
    rx = rs.randn(8, 16, 16, 3)
    ry = np.eye(5)[rs.randint(0, 5, 8)]
    _, _, _, _, GB = TDM._modules()
    from deeplearning4j_tpu_torch.nn.graph import ElementWiseVertex
    lstm = TDM._np(TDM._port(TDM.lstm_conf(L, I, NNC)).params)
    lx = rs.randn(8, 6, 4).astype(np.float32)
    ly = np.eye(5, dtype=np.float32)[rs.randint(0, 5, (8, 6))]
    lmask = (rs.rand(8, 6) > 0.3).astype(np.float32)
    lmask[:, 0] = 1.0
    gr = _trees(TDM._port(TDM.resnet_graph_conf(resnet50), dtype=torch.float64))
    gx = rs.randn(8, 16, 16, 3)
    gy = np.eye(4)[rs.randint(0, 4, 8)]
    sk = _trees(TDM._port(TDM.skip_graph_conf(L, I, GB, ElementWiseVertex),
                          dtype=torch.float64))
    sx = rs.randn(8, 12)
    sy = np.eye(3)[rs.randint(0, 3, 8)]

    lstm_net = JNet(TDM.lstm_conf(JL, JI, JNNC))
    lstm_loss = jax.jit(jax.value_and_grad(
        lambda p, s, x, y, m: lstm_net.loss_fn(p, s, x, y, train=True, mask=m)[0]))
    l_loss, l_grads = lstm_loss(lstm, [{} for _ in lstm], jnp.asarray(lx), jnp.asarray(ly),
                                jnp.asarray(lmask))
    skip_net = JGraph(TDM.skip_graph_conf(JL, JI, JGB, JElementWise))
    ref = {"mln": _seq_microbatch_run(JNet(TDM.resnet_mln_conf(j_resnet50_mln)), *rn, rx, ry,
                                      2),
           "graph": _seq_microbatch_run(JGraph(TDM.resnet_graph_conf(j_resnet50)), *gr, gx, gy,
                                        2),
           "skip": _seq_microbatch_run(skip_net, *sk, sx, sy, 2),
           "lstm": (float(l_loss), _np(l_grads))}
    root = tmp_path_factory.mktemp("pipe_general")
    ranks = TL.run_ranks(TDM.pipeline_general_program, 4, root, timeout=300, rn=rn, rx=rx,
                         ry=ry, lstm=lstm, lx=lx, ly=ly, lmask=lmask, gr=gr, gx=gx, gy=gy,
                         sk=sk[0], sx=sx, sy=sy, ckpt=str(root / "ckpt"))
    return ref, ranks, {"mln": rn[0], "graph": gr[0], "skip": sk[0], "lstm": lstm}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_pipelined_resnet_mln_loss_and_bn_state_pin(run, sched):
    """The reduced ResNet50 MLN over 4 stages: loss and final BN statistics
    against the JAX sequential per-microbatch run (float64); both schedules
    take the same step."""
    loss, state, _ = run[0]["mln"]
    for r in run[1]:
        got = r["mln"][sched]
        np.testing.assert_allclose(got["loss"], loss, **F64)
        for i, st in enumerate(state):
            for a, b in zip(jax.tree_util.tree_leaves(got["state"][i]),
                            jax.tree_util.tree_leaves(st)):
                np.testing.assert_allclose(a, b, err_msg=f"layer {i}", **F64)
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(r["mln"]["gpipe"]["params"])):
            np.testing.assert_allclose(a, b, **F64)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_masked_lstm_stack_loss_pin(run, sched):
    """Masks reach the LSTMs and the loss, microbatch by microbatch, on
    data=2 x stage=2: the full-batch masked loss within 2e-5; unmasked
    differs."""
    want = run[0]["lstm"][0]
    for r in run[1]:
        got = r["lstm"][sched]
        assert abs(got["loss"] - want) < 2e-5
        assert abs(got["step"] - want) < 2e-5
        assert abs(got["unmasked"] - want) > 1e-6


@pytest.mark.parametrize("net", ["mln", "graph", "lstm"])
@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_gradients_match_sequential(run, net, sched):
    """Every parameter's gradient, taken as the SGD step's update, against
    ``jax.grad`` of the JAX sequential per-microbatch run: the reduced
    ResNet50 MLN and graph over stage=4 (float64, BN in train mode), the
    masked LSTM stack over data=2 x stage=2 (float32, the JAX test's atol
    5e-5)."""
    grads = run[0][net][1] if net == "lstm" else run[0][net][2]
    tol = {"mln": F64, "graph": GRAPH_GRAD, "lstm": LSTM_GRAD}[net]
    for r in run[1]:
        _assert_sgd_step(run[2][net], r[net][sched]["params"], grads, **tol)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_long_skip_across_stage_boundaries(run, sched):
    """A skip edge from the first stage to the last is carried through the
    boundaries between (as the JAX package's ``_boundaries``); the loss and
    every gradient, the L2 penalty's included, equal the JAX sequential
    run's (float64)."""
    loss, _, grads = run[0]["skip"]
    for r in run[1]:
        got = r["skip"][sched]
        assert all("d1" in b for b in got["boundaries"][1:4])
        np.testing.assert_allclose(got["loss"], loss, **F64)
        _assert_sgd_step(run[2]["skip"], got["params"], grads, **F64)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_pipelined_resnet50_graph_loss_and_state_pin(run, sched):
    """The reduced ResNet50 graph over 4 stages: loss and every vertex's BN
    statistics against the JAX sequential per-microbatch run (float64)."""
    loss, state, _ = run[0]["graph"]
    for r in run[1]:
        got = r["graph"][sched]
        np.testing.assert_allclose(got["loss"], loss, **F64)
        for name, st in state.items():
            for a, b in zip(jax.tree_util.tree_leaves(got["state"][name]),
                            jax.tree_util.tree_leaves(st)):
                np.testing.assert_allclose(a, b, err_msg=name, **F64)


def test_stage_balance_is_the_jax_rule(run):
    """Balanced stage groups equal the JAX package's, by layer and by
    vertex."""
    r = run[1][0]
    assert r["mln"]["gpipe"]["groups"] == j_balance(TDM.resnet_mln_conf(j_resnet50_mln), 4)
    assert r["graph"]["gpipe"]["groups"] == j_balance_graph(
        TDM.resnet_graph_conf(j_resnet50), 4)
    assert PG.balance_stages(TDM.resnet_mln_conf(resnet50_mln), 4) == r["mln"]["gpipe"]["groups"]
    assert [s["stash"] for s in (x["mln"]["1f1b"] for x in run[1])] == [2, 2, 2, 1]


def test_refusals_keep_the_jax_messages():
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import FeedForwardType
    from deeplearning4j_tpu_torch.nn.graph import GraphBuilder

    _, U, I, NNC, _ = TDM._modules()
    with pytest.raises(ValueError, match="aux loss"):
        PG.PipelinedNetwork(TDM.moe_conf(L, U, I, NNC), None)
    g = GraphBuilder(seed=1)
    g.add_inputs("in")
    g.set_input_types(FeedForwardType(4))
    g.add_layer("d", L.DenseLayer(n_out=4, dropout=0.5), "in")
    g.add_layer("out", L.OutputLayer(n_out=2, loss="mcxent"), "d")
    g.set_outputs("out")
    with pytest.raises(ValueError, match="dropout"):
        PG.PipelinedGraph(g.build(), None)
    g2 = GraphBuilder(seed=1, gradient_normalization="clip_l2")
    g2.add_inputs("in")
    g2.set_input_types(FeedForwardType(4))
    g2.add_layer("d", L.DenseLayer(n_out=4), "in")
    g2.add_layer("out", L.OutputLayer(n_out=2, loss="mcxent"), "d")
    g2.set_outputs("out")
    with pytest.raises(ValueError, match="gradient normalization"):
        PG.PipelinedGraph(g2.build(), None)


def test_sharded_checkpoint_round_trip(run):
    """Save after 2 steps, restore into a fresh pipeline: the BN state and
    the iteration come back and the next step's loss is the uninterrupted
    run's (within 1e-5)."""
    for r in run[1]:
        c = r["ckpt"]
        assert c["iteration"] == 2
        for a, b in zip(jax.tree_util.tree_leaves(c["state"]),
                        jax.tree_util.tree_leaves(c["saved_state"])):
            np.testing.assert_array_equal(a, b)
        assert abs(c["l_resume"] - c["l_next"]) < 1e-5
