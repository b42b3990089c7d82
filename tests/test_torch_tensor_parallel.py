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
  1e-6 (float32), with the same maximum batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu_torch.parallel import launch as TL

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


def _jax_tp(net, spec, x, y, steps):
    n = int(np.prod([v for v in spec.values()]))
    mesh = j_make_mesh(JMeshSpec(**spec), devices=jax.devices()[:n])
    tr = JTrainer(net, mesh, tensor_parallel=True, shard_optimizer_state=False).adopt_net_state()
    losses = [float(tr.step(x, y)) for _ in range(steps)]
    tr.sync_to_net()
    return losses, _np(net.params), _np(net.state)


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
    inputs = {"mln": (_np(mln.params), _np(mln.state)),
              "graph": (_np(graph.params), _np(graph.state)),
              "moe": (_np(moe.params), _np(moe.state)),
              "plain": (_np(plain.params), _np(plain.state))}
    pi = JInference(plain, max_batch_size=6,
                    mesh=j_make_mesh(JMeshSpec(data=4), devices=jax.devices()[:4]))
    ref = {"mln": _jax_tp(mln, dict(data=2, model=2), x, y, TDM.STEPS),
           "graph": _jax_tp(graph, dict(data=2, model=2), gx, gy, TDM.STEPS),
           "moe": _jax_tp(moe, dict(data=1, model=4), mx, my, 2),
           "inference": (np.asarray(pi.output(fx)), pi.max_batch)}
    ranks = TL.run_ranks(TDM.tp_program, 4, tmp_path_factory.mktemp("tp"), timeout=300,
                         x=x, y=y, gx=gx, gy=gy, mx=mx, my=my, fx=fx, **inputs)
    return ref, ranks


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
