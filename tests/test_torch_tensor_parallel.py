"""The port's tensor and expert parallelism (``ParallelTrainer(
tensor_parallel=True)``, the MoE block's experts split over ``model``)
against the JAX package's, and ``ParallelInference(mesh=)``.

One spawn of 4 gloo ranks (``tests/torch_dist_model.py tp_program``). The
JAX references run ``ParallelTrainer(tensor_parallel=True)`` on the same
mesh shape of the 8-device virtual CPU mesh, one global program whose
result is the replicated step's; the port keeps that result with explicit
collectives. Tolerances:

- the MLN (Dense, BatchNormalization, a Dense trunk, softmax; Adam; per-layer
  L2 renormalization) on data=2 x model=2 in float32, each of the
  replicated, zero1 and fsdp layouts: losses, parameters and BN statistics
  after 3 steps at rtol 1e-5 + atol 1e-6 (``test_torch_parallel.py``'s F32:
  the JAX updater scalars are float64 under x64);
- a graph (conv -> BN -> pool -> split softmax) in float64 at rtol 1e-9 +
  atol 1e-8;
- the MoE LM (8 experts, 2 a rank on model=4; SGD): the first step's loss
  at rtol 1e-4 (``tests/test_moe.py``'s expert-parallel check), and the
  losses and parameters after 2 steps at rtol 1e-4 + atol 1e-5 (float32;
  the router's top-1 choices are the same on these inputs);
- the f/g pair and the all-gather's transposes exactly (rtol 1e-12, float64);
- ``ParallelInference(mesh=)`` over data=4 against the JAX package's on
  the same weights over data=4 of the virtual mesh, at rtol 1e-5 + atol
  1e-6 (float32), with the same maximum batch;
- the MoE LM with overflowing experts (capacity factor 0.5) on data=2 x
  model=2 and on data=2 alone, routed over the global batch: against the
  JAX ``ParallelTrainer`` on the same layout and the single-device JAX
  step, the first loss at rtol 1e-4, then ``MOE``;
- gradients read from one SGD step (the LM under ``fsdp_stream`` against
  the JAX trainer's; the weight-noise MLN against the port's world-1 step
  and, at noise 0, the JAX trainer's): each leaf within 1e-4 of its own
  largest, with a floor of 1% of the model's largest (``_leaf_rule``);
- the TP trainer's sharded checkpoint resumed on data=4 x model=1 and at
  world 1: the 3rd step's loss, parameters and BN state at ``F32`` against
  the uninterrupted run's.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import torch_dist_model as TDM
import torch_dist_parallel as TDP
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelInference as JInference
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu.nn.initializers import Distribution as JDistribution
from deeplearning4j_tpu.nn.weightnoise import WeightNoise as JWeightNoise
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu_torch.parallel import launch as TL
from deeplearning4j_tpu_torch.utils.trees import flatten_tree

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-9, atol=1e-8)
MOE = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _assert_trees(got, want, **tol):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _jax_trainer(net, spec, tensor_parallel=True, **kw):
    n = int(np.prod([v for v in spec.values()]))
    mesh = j_make_mesh(JMeshSpec(**spec), devices=jax.devices()[:n])
    return JTrainer(net, mesh, tensor_parallel=tensor_parallel, **kw).adopt_net_state()


def _jax_tp(net, spec, x, y, steps, tensor_parallel=True):
    tr = _jax_trainer(net, spec, tensor_parallel, shard_optimizer_state=False)
    losses = [float(tr.step(x, y)) for _ in range(steps)]
    tr.sync_to_net()
    return losses, _np(net.params), _np(net.state)


def _jax_grads(net, spec, x, y, **kw):
    """(loss, {path: gradient}) of one SGD step of the JAX trainer."""
    tr = _jax_trainer(net, spec, **kw)
    before = flatten_tree(_np(net.params))
    loss = float(tr.step(x, y))
    tr.sync_to_net()
    after = flatten_tree(_np(net.params))
    return loss, {k: (before[k].astype(np.float64) - after[k]) / TDM.LR for k in before}


def _jax_net(conf, **init):
    net = JNet(conf)
    net.init(**init)
    return net


def _leaf_rule(got, want):
    """Each gradient leaf within 1e-4 of its own largest, with a floor of 1%
    of the model's largest."""
    floor = 0.01 * max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        gap = float(np.abs(np.asarray(got[k]) - w).max())
        assert gap <= 1e-4 * max(float(np.abs(w).max()), floor), (k, gap)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rs = np.random.RandomState(0)
    x = (rs.randn(16, 5) * 2 + 0.5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    gx = rs.randn(8, 4, 4, 3) * 2 + 1
    gy = np.eye(4)[rs.randint(0, 4, 8)]
    ids = rs.randint(0, 20, (4, 8))
    mx = ids[..., None].astype(np.float32)
    my = np.eye(20, dtype=np.float32)[np.roll(ids, -1, 1)]
    fx = rs.randn(10, 5).astype(np.float32)

    mln = JNet(TDP.mln_conf(JL, JU, JI, JNNC))
    mln.init()
    graph = JGraph(TDM.tp_graph_conf(JL, JU, JI, JGB))
    graph.init(dtype=jnp.float64)
    moe = JNet(TDM.moe_conf(JL, JU, JI, JNNC))
    moe.init()
    plain = JNet(TDP.plain_mln_conf(JL, JU, JI, JNNC))
    plain.init()
    tight = TDM.moe_conf(JL, JU, JI, JNNC, capacity_factor=TDM.MOE_TIGHT)
    lm = _jax_net(TDM.lm_conf(JL, JU, JI, JNNC))
    lids = rs.randint(0, TDM.LM["vocab_size"], (4, TDM.LM["seq_len"]))
    lx = lids[..., None].astype(np.float32)
    ly = np.eye(TDM.LM["vocab_size"], dtype=np.float32)[np.roll(lids, -1, 1)]
    quiet = _jax_net(TDM.noise_conf(JL, JU, JI, JNNC, JWeightNoise, JDistribution, std=0.0))
    inputs = {"mln": (_np(mln.params), _np(mln.state)),
              "graph": (_np(graph.params), _np(graph.state)),
              "moe": (_np(moe.params), _np(moe.state)),
              "plain": (_np(plain.params), _np(plain.state)),
              "moe_tight": (_np(_jax_net(tight).params), None),
              "lm": (_np(lm.params), None), "noisy": (_np(quiet.params), None)}
    pi = JInference(plain, max_batch_size=6,
                    mesh=j_make_mesh(JMeshSpec(data=4), devices=jax.devices()[:4]))
    ref = {"mln": _jax_tp(mln, dict(data=2, model=2), x, y, TDM.STEPS),
           "graph": _jax_tp(graph, dict(data=2, model=2), gx, gy, TDM.STEPS),
           "moe": _jax_tp(moe, dict(data=1, model=4), mx, my, 2),
           "inference": (np.asarray(pi.output(fx)), pi.max_batch),
           "moe_global": {
               "data2_model2": _jax_tp(_jax_net(tight), dict(data=2, model=2), mx, my, 2),
               "data2": _jax_tp(_jax_net(tight), dict(data=2), mx, my, 2, tensor_parallel=False),
               "single": _jax_tp(_jax_net(tight), dict(data=1), mx, my, 2,
                                 tensor_parallel=False)},
           "lm_stream": _jax_grads(lm, dict(data=2, model=2), lx, ly,
                                   shard_params="fsdp_stream"),
           "quiet": _jax_grads(quiet, dict(data=2, model=2), x, y)}
    root = tmp_path_factory.mktemp("tp")
    ranks = TL.run_ranks(TDM.tp_program, 4, root, timeout=300, x=x, y=y, gx=gx, gy=gy, mx=mx,
                         my=my, fx=fx, lx=lx, ly=ly, ckpt=str(root / "ckpt"), **inputs)
    return ref, ranks, (x, y, str(root / "ckpt"))


@pytest.mark.parametrize("layout", TDM.TP_LAYOUTS)
def test_tp_mln_layouts_match_jax_tensor_parallel_trainer(run, layout):
    """Losses, whole parameters (``sync_to_net``) and BN statistics after 3
    steps on every rank of data=2 x model=2, against the JAX trainer's."""
    (losses, params, state), ranks = run[0]["mln"], run[1]
    for r in ranks:
        got = r["mln"][layout]
        np.testing.assert_allclose(got["losses"], losses, **F32)
        _assert_trees(got["params"], params, **F32)
        _assert_trees(got["state"], state, **F32)


def test_tp_graph_with_split_softmax_matches_jax(run):
    """The graph's conv and BN compute their own channels, the split softmax
    layer gathers its weights: float64 parity after 3 steps."""
    (losses, params, state), ranks = run[0]["graph"], run[1]
    for r in ranks:
        np.testing.assert_allclose(r["graph"]["losses"], losses, **F64)
        _assert_trees(r["graph"]["params"], params, **F64)
        _assert_trees(r["graph"]["state"], state, **F64)


def test_each_rank_stores_its_slice_by_the_jax_rule(run):
    """A split leaf is stored as this rank's half (the JAX spec: a Dense W
    on its columns, BN's gamma on dim 0, the 3-wide softmax whole); the
    tensor-parallel layout stores fewer bytes than a replica."""
    ranks = run[1]
    whole = jax.tree_util.tree_leaves(run[0]["mln"][1])
    for r in ranks:
        got = r["mln"]["replicated"]
        specs = got["specs"]
        assert tuple(specs[0]["W"]) == (None, "model") and tuple(specs[-1]["W"]) == ()
        local = jax.tree_util.tree_leaves(got["local"])
        for a, b, s in zip(local, whole, jax.tree_util.tree_leaves(
                specs, is_leaf=lambda t: hasattr(t, "entries"))):
            want = list(b.shape)
            for d, e in enumerate(s):
                if e == "model":
                    want[d] //= 2
            assert list(a.shape) == want
        assert got["bytes"]["param_bytes"] < sum(b.nbytes for b in whole)


def test_expert_parallel_matches_jax_and_splits_the_experts(run):
    """The MoE LM on model=4: 2 of the 8 experts a rank; the first step's
    loss at the JAX expert-parallel check's rtol 1e-4, the second step and
    the parameters after it within the stated tolerance."""
    (losses, params, _), ranks = run[0]["moe"], run[1]
    for r in ranks:
        got = r["moe"]
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-4)
        np.testing.assert_allclose(got["losses"], losses, **MOE)
        _assert_trees(got["params"], params, **MOE)
        block = got["local"][1]
        for k in ("expert_W1", "expert_b1", "expert_W2", "expert_b2"):
            assert block[k].shape[0] == 2, k
        assert block["router_W"].shape == (16, 8)


def test_fg_pair_and_gather_transposes(run):
    """g sums forward and passes the cotangent; f passes forward and sums
    the cotangents; the all-gather's backward keeps the local slice."""
    a, b = (r["fg"] for r in run[1][:2])  # model ranks 0 and 1 of data row 0
    tol = dict(rtol=1e-12, atol=1e-12)
    for me, other in ((a, b), (b, a)):
        np.testing.assert_allclose(me["g_fwd"], a["x"] + b["x"], **tol)
        np.testing.assert_allclose(me["g_bwd"], me["ct"], **tol)
        np.testing.assert_allclose(me["f_fwd"], me["x"], **tol)
        np.testing.assert_allclose(me["f_bwd"], a["ct"] + b["ct"], **tol)
        np.testing.assert_allclose(me["gather"], np.concatenate([a["x"], b["x"]], 1), **tol)
    np.testing.assert_allclose(a["gather_bwd"], np.arange(24.).reshape(3, 8)[:, :4], **tol)
    np.testing.assert_allclose(b["gather_bwd"], np.arange(24.).reshape(3, 8)[:, 4:], **tol)
    assert all(r["model_group_off_after"] for r in run[1])


def test_parallel_inference_split_over_data(run):
    """Every rank of data=4 returns every answer, equal to the JAX
    ``ParallelInference(mesh=)``'s on the same weights; the maximum batch
    rounds up to a multiple of 4 as there."""
    want, max_batch = run[0]["inference"]
    assert max_batch == 8
    for r in run[1]:
        got = r["inference"]
        assert got["max_batch"] == max_batch
        np.testing.assert_allclose(got["got"], want, **F32)


@pytest.mark.parametrize("layout", ["data2_model2", "data2"])
def test_moe_routes_the_global_batch_under_a_data_axis(run, layout):
    """Experts overflow (capacity factor 0.5: tokens dropped on the global
    batch); each data rank's queues are offset by the lower ranks' counts,
    so the step is the JAX trainer's on the same layout and the
    single-device JAX step: the first loss at rtol 1e-4, then ``MOE``."""
    ref, ranks = run[0]["moe_global"], run[1]
    for want in (ref[layout], ref["single"]):
        losses, params, _ = want
        for r in ranks:
            assert sum(r["moe_drops"]) > 0
            got = r["moe_global"][layout]
            np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-4)
            np.testing.assert_allclose(got["losses"], losses, **MOE)
            _assert_trees(got["params"], params, **MOE)


def test_tp_fsdp_stream_lm_matches_jax(run):
    """The LM's trunk streamed block by block under tensor parallelism on
    data=2 x model=2: the loss and every gradient leaf of one SGD step
    against the JAX trainer's (``tensor_parallel=True,
    shard_params='fsdp_stream'``)."""
    loss, grads = run[0]["lm_stream"]
    for r in run[1]:
        got_loss, got = r["lm_stream"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        _leaf_rule(got, grads)


def test_weight_noise_under_tp_draws_what_world1_draws(run):
    """Each rank draws its slices at the whole parameters' indices: the
    split step's gradients equal the port's world-1 step's; without noise
    the split step is the JAX trainer's."""
    w1_loss, w1 = run[1][0]["noise"]["world1"]
    loss, grads = run[0]["quiet"]
    for r in run[1]:
        got_loss, got = r["noise"][TDM.NOISE_STD]
        np.testing.assert_allclose(got_loss, w1_loss, rtol=1e-5)
        _leaf_rule(got, w1)
        got_loss, got = r["noise"][0.0]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        _leaf_rule(got, grads)
    assert max(float(np.abs(w1[k] - grads[k]).max()) for k in grads) > 1e-3  # noise moved it


def test_tp_sharded_checkpoint_resumes_on_other_layouts(run):
    """Saved after 2 steps on data=2 x model=2 (each rank its own pieces,
    both splits in the index); resumed on data=4 x model=1 and at world 1,
    the 3rd step equals the uninterrupted run's."""
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC

    x, y, ckpt = run[2]
    index = SC.read_index(ckpt)
    assert (index["world"], index["model_world"]) == (2, 2)
    assert index["leaves"]["['params'][0]['W']"]["model_split"] == 1
    want = run[1][0]["ckpt"]
    for r in run[1]:
        got = r["ckpt"]["data4"]
        assert got["iteration"] == 2
        np.testing.assert_allclose(got["loss"], want["loss"], **F32)
        _assert_trees(got["params"], want["params"], **F32)
        _assert_trees(got["state"], want["state"], **F32)
    d = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=0, world_size=1)
    try:
        tr = SC.restore_trainer(ckpt, TDM._trainer(TDP.port_mln(), make_mesh(), "zero1", False))
        loss = float(tr.step(x, y))
        tr.sync_to_net()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(loss, want["loss"], **F32)
    _assert_trees(_np_port(tr.net.params), want["params"], **F32)
    _assert_trees(_np_port(tr.net.state), want["state"], **F32)


def _np_port(tree):
    return TDP._np(tree)
