"""The port's ParallelTrainer against the JAX package's.

Two spawns of gloo ranks (the rank program of ``tests/torch_dist_parallel.py``,
started by ``parallel.launch.run_ranks``): P=4, then P=2. Each rank trains
every layout (replicated, zero1, fsdp, fsdp_stream) for 3 steps from the
JAX net's initial weights, on the same global batch, and is held against
the JAX package's replicated ``ParallelTrainer`` on the 8-device virtual
mesh (``MeshSpec(data=P)``), which is one global program: its batch
statistics are the global batch's (checked in the JAX package itself: its
data=4 step's BN state equals the single-device step's, and differs from
the mean of four quarter-batch steps' by ~0.6). The JAX package's own
bit-exact ZeRO parity tests are red, so every port layout is held to the
JAX replicated path.

- a MultiLayerNetwork (Dense, BatchNormalization, a trunk of 3 identical
  Dense layers, softmax; Adam; per-layer L2 renormalization of the
  gradients) in float32: losses and parameters rtol 1e-5 + atol 1e-6,
  BN running statistics rtol 1e-5 + atol 1e-6 (the JAX updater's scalars
  are float64 under x64, the port's float32);
- a graph of fused conv-BN vertices (3x3, 1x1 with a residual) in
  float64: losses rtol 1e-9, parameters and BN statistics rtol 1e-9 +
  atol 1e-8 (Adam's scalar factors are float32 in the port).

Then, held against the port's own single-process step: the fused op's
statistics and gradients under the batch group against the whole batch
(rtol 1e-12, float64), a masked loss whose ranks hold 2 and 7 valid rows,
dropout drawing what world 1 draws, ragged batches dropped and counted,
K=4 against K=1, the world-4 checkpoints of every layout restored into
every layout at world 2 (the next step's loss within rtol 1e-5 of the
saving run's), and a single-process bundle adopted by split trainers.
The serving engine over the mesh (``ServingEngine(mesh=)``) answers as the
JAX engine over a data=P mesh does, on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_parallel as TDP
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNNC
from deeplearning4j_tpu.nn.fusion import FusedConvBNVertex as JFused
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu.serving import ServingEngine as JEngine
from deeplearning4j_tpu_torch.parallel import launch as TL
from deeplearning4j_tpu_torch.utils import serialization as tser

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-9, atol=1e-8)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _data():
    rs = np.random.RandomState(0)
    x = (rs.randn(16, 5) * 2 + 0.5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    gx = rs.randn(8, 4, 4, 3) * 2 + 1
    gy = np.eye(3)[rs.randint(0, 3, 8)]
    return x, y, gx, gy


def _jax_nets():
    """The JAX MLN (float32) and graph (float64), initialised; their
    weights and state as numpy trees for the ranks."""
    mln = JNet(TDP.mln_conf(JL, JU, JI, JNNC))
    mln.init()
    graph = JGraph(TDP.graph_conf(JL, JU, JI, JGB, JFused))
    graph.init(dtype=jnp.float64)
    return mln, graph


def _jax_run(net, p, x, y):
    """3 steps of the JAX replicated ParallelTrainer on a data=p mesh."""
    mesh = j_make_mesh(JMeshSpec(data=p), devices=jax.devices()[:p])
    tr = JTrainer(net, mesh, shard_optimizer_state=False).adopt_net_state()
    losses = [float(tr.step(x, y)) for _ in range(TDP.STEPS)]
    tr.sync_to_net()
    return losses, _np(net.params), _np(net.state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{P: (the JAX results, each rank's results)} for P = 4, then 2."""
    x, y, gx, gy = _data()
    out = {}
    root = tmp_path_factory.mktemp("parallel")
    bundle_net = TDP.port_mln()
    bundle_net.fit(x, y)
    bundle = str(root / "bundle.zip")
    tser.save_bundle(bundle_net, bundle)
    for p in (4, 2):
        jm, jg = _jax_nets()
        mln = (_np(jm.params), _np(jm.state))
        graph = (_np(jg.params), _np(jg.state))
        jeng = JEngine(jm, mesh=j_make_mesh(JMeshSpec(data=p), devices=jax.devices()[:p]),
                       input_spec=(5,), buckets=(3, 6))
        engine = {"buckets": jeng.stats()["buckets"], "want": np.asarray(jeng.output(x[:11]))}
        ref = {"engine": engine, "mln": _jax_run(jm, p, x, y), "graph": _jax_run(jg, p, gx, gy)}
        ranks = TL.run_ranks(TDP.trainer_program, p, root / f"ranks{p}", timeout=300,
                             mln=mln, graph=graph, x=x, y=y, gx=gx, gy=gy,
                             ckpt_dir=str(root / "ckpt4"), restore_from=str(root / "ckpt4"),
                             bundle=bundle)
        out[p] = (ref, ranks)
    out["bundle"] = bundle_net
    return out


def _assert_trees(got, want, **tol):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("layout", TDP.LAYOUTS)
def test_mln_layouts_match_jax_parallel_trainer(runs, p, layout):
    """Losses, parameters and BN running statistics after 3 steps, on every
    rank, against the JAX trainer's on a data=P mesh (global statistics)."""
    (ref_losses, ref_params, ref_state), ranks = runs[p][0]["mln"], runs[p][1]
    for r in ranks:
        got = r["mln"][layout]
        np.testing.assert_allclose(got["losses"], ref_losses, **F32)
        _assert_trees(got["params"], ref_params, **F32)
        _assert_trees(got["state"], ref_state, **F32)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("layout", TDP.GRAPH_LAYOUTS)
def test_fused_graph_layouts_match_jax_parallel_trainer(runs, p, layout):
    """The graph of fused conv-BN vertices in float64: the kernels'
    per-rank statistics all-reduced give the JAX trainer's global step."""
    (ref_losses, ref_params, ref_state), ranks = runs[p][0]["graph"], runs[p][1]
    for r in ranks:
        got = r["graph"][layout]
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-9)
        _assert_trees(got["params"], ref_params, **F64)
        _assert_trees(got["state"], ref_state, **F64)


@pytest.mark.parametrize("p", [2, 4])
def test_layout_storage_and_refusals(runs, p):
    """zero1 keeps 1/P of the updater state a rank, fsdp also 1/P of the
    parameters (every leaf of the MLN splits except the 3-wide biases);
    fsdp_stream streams the 3-layer trunk and refuses a graph."""
    ranks = runs[p][1]
    b = {k: ranks[0]["mln"][k]["bytes"] for k in TDP.LAYOUTS}
    assert b["zero1"]["param_bytes"] == b["replicated"]["param_bytes"]
    assert b["zero1"]["opt_state_bytes"] < b["replicated"]["opt_state_bytes"] / (p - 0.5)
    assert b["fsdp"]["param_bytes"] < b["replicated"]["param_bytes"] / (p - 0.5)
    assert b["fsdp_stream"] == b["fsdp"]
    assert ranks[0]["mln"]["fsdp_stream"]["trunk"] == (2, 5)
    assert "homogeneous trunk" in ranks[0]["graph_stream_refusal"]


@pytest.mark.parametrize("p", [2, 4])
def test_fused_op_statistics_span_the_ranks(runs, p):
    """y and dx rows, the batch mean and variance, and dW/dgamma/dbeta
    summed over the ranks equal the whole batch's (float64)."""
    for r in runs[p][1]:
        for name, err in r["fused_stats"].items():
            assert err < 1e-12, (name, err)


def test_masked_loss_takes_the_global_count(runs):
    """Ranks with 2 and 7 valid rows: the loss is the global masked mean
    (not the mean of the ranks' means), and so is the step."""
    m = runs[2][1][0]["masked"]
    np.testing.assert_allclose(m["loss"], m["ref_loss"], **F32)
    _assert_trees(m["params"], m["ref_params"], **F32)


def test_dropout_draws_what_world_one_draws(runs):
    """Input dropout at 0.4: each rank's rows hash their global indices, so
    the world-2 step is the world-1 step (and differs from no dropout)."""
    d = runs[2][1][0]["dropout"]
    np.testing.assert_allclose(d["loss"], d["ref_loss"], **F32)
    assert abs(d["loss"] - d["nodrop_loss"]) > 1e-3
    _assert_trees(d["params"], d["ref_params"], **F32)


def test_ragged_batches_dropped_and_counted(runs):
    r = runs[2][1][0]["ragged"]
    assert r == {"dropped": 3, "steps": 3, "scores": 3}


def test_k4_matches_k1(runs):
    """fit(steps_per_dispatch=4) runs the trainer's step as the K-step
    engine's base step: two dispatches, the same 8 steps as K=1, run
    eagerly on gloo (no capture)."""
    for r in runs[2][1]:
        k = r["k4"]
        assert k["dispatches"] == 2 and k["captures"] == 0  # gloo: eager
        np.testing.assert_allclose(k["k4_scores"], k["k1_scores"], **F32)
        _assert_trees(k["k4_params"], k["k1_params"], **F32)


@pytest.mark.parametrize("src", TDP.LAYOUTS)
def test_checkpoints_resume_across_layouts_and_world_sizes(runs, src):
    """Every layout's world-4 checkpoint resumes into every layout at
    world 2: the counters carried, the next step's loss the saving run's."""
    saved = runs[4][1][0]["mln"][src]
    for r in runs[2][1]:
        for dst in TDP.LAYOUTS:
            got = r["restored"][(src, dst)]
            assert (got["iteration"], got["epoch"]) == (TDP.STEPS + 1, 0)
            np.testing.assert_allclose(got["next_loss"], saved["next_loss"], **F32)


def test_bundle_adopted_by_split_trainers(runs):
    """A single-process bundle placed in zero1/fsdp/fsdp_stream at world 2
    and synced back is the bundle: parameters, Adam state, iteration."""
    net = runs["bundle"]
    want_p = [{k: v.detach().numpy() for k, v in p.items()} for p in net.params]
    want_o = jax.tree_util.tree_map(lambda t: t.numpy(), net.opt_state)
    for r in runs[2][1]:
        for layout, got in r["bundle"].items():
            assert got["iteration"] == net.iteration == 1
            _assert_trees(got["params"], want_p, rtol=0, atol=0)
            _assert_trees(got["opt"], want_o, rtol=0, atol=0)
    b = runs[2][1][0]["bundle"]
    assert b["fsdp"]["bytes"]["param_bytes"] < b["zero1"]["bytes"]["param_bytes"]


@pytest.mark.parametrize("p", [2, 4])
def test_mesh_engine_matches_jax_engine(runs, p):
    """``ServingEngine(mesh=)``: buckets rounded up to the data axis as
    the JAX engine rounds them, every rank's answer the JAX engine's over
    a data=P mesh (one forward a chunk, each rank its rows, all-gathered),
    and ``start()`` refused (the collective form has no queue)."""
    ref, ranks = runs[p][0]["engine"], runs[p][1]
    for r in ranks:
        got = r["mesh_engine"]
        assert got["buckets"] == ref["buckets"] == sorted({-(-b // p) * p for b in (3, 6)})
        np.testing.assert_allclose(got["got"], ref["want"], **F32)
        assert got["forward"]["forwards"] == got["forward"]["warmed"] + 2
        assert "collective" in got["start_refusal"]


def test_batch_group_is_left_after_the_step(runs):
    assert all(r["batch_group_off_after"] for r in runs[2][1])
