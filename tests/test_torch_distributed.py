"""The port's TrainingMasters, accumulator, data plumbing and
ParallelInference against the JAX package's.

One spawn of 4 gloo ranks (``tests/torch_dist_parallel.py
masters_program``) runs the masters; the JAX masters run in this process
on a data=4 virtual mesh, on the same numpy inputs and initial weights:

- ``SharedTrainingMaster`` exact (sharded and replicated updater state)
  on an MLN with batch normalization, 3 steps of 4 rows a worker: each
  worker normalises with its own rows' statistics and the running
  statistics are averaged after the step, as the JAX master's
  ``shard_map`` does; threshold mode (tau 1e-3): tau, the flagged
  densities and each worker's residual after 3 steps against the JAX
  step's (its ``_build`` step driven as ``execute_training`` drives it);
- ``ParameterAveragingTrainingMaster`` at frequency 2 against JAX's, and
  at frequency 1 (Sgd) equal to synchronous data parallelism on the
  global batch;

float32 rtol 1e-5 + atol 1e-6 throughout (the JAX updater's scalars are
float64 under x64, the port's float32). In this process:
``EncodedGradientsAccumulator``'s exactly-once fan-out and mass
conservation, ``data_utils`` against the JAX module, the rank-sharded
iterator, ``ParallelInference`` (batched, sequential, hot swap) and the
single-process ``initialize_distributed``; in the ranks, the per-worker
health rollup with the watchdog armed.
"""

import threading

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
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelInference as JInference
from deeplearning4j_tpu.parallel import data_utils as jdu
from deeplearning4j_tpu.parallel import distributed as JD
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator, ShardedDataSetIterator
from deeplearning4j_tpu_torch.parallel import ParallelInference, data_utils as tdu
from deeplearning4j_tpu_torch.parallel import distributed as TD
from deeplearning4j_tpu_torch.parallel import launch as TL

F32 = dict(rtol=1e-5, atol=1e-6)
W = 4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _assert_trees(got, want, **tol):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _data():
    rs = np.random.RandomState(3)
    x = (rs.randn(48, 5) * 2 + 0.5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 48)]
    px = rs.randn(32, 5).astype(np.float32)
    py = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)]
    return x, y, px, py


def _jax_threshold_run(net, mesh, x, y, tau0):
    """JAX's threshold step driven as its ``execute_training`` drives it,
    keeping the residual it holds internally."""
    m = JD.SharedTrainingMaster(mesh, batch_size_per_worker=4, threshold=tau0)
    step = m._build(net, False)
    params, state = JD._put(net.params, mesh), JD._put(net.state, mesh)
    opt = JD._put(jax.tree_util.tree_map(
        lambda a: JD._flat_pad(jnp.asarray(a), W).reshape(W, -1), net.opt_state), mesh, "data")
    resid = JD._put(JD._stack_worker_dim(jax.tree_util.tree_map(jnp.zeros_like, net.params), W),
                    mesh, "data")
    tau = jnp.asarray(tau0, jnp.float32)
    taus = []
    for i, s0 in enumerate(range(0, len(x), 4 * W)):
        params, state, opt, resid, tau, loss = step(
            params, state, opt, resid, tau, jnp.asarray(x[s0:s0 + 4 * W]),
            jnp.asarray(y[s0:s0 + 4 * W]), i, jax.random.PRNGKey(0))
        taus.append(float(tau))
    return {"params": _np(params), "state": _np(state), "resid": _np(resid), "taus": taus,
            "loss": float(loss)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, y, px, py = _data()
    mesh = j_make_mesh(JMeshSpec(data=W), devices=jax.devices()[:W])
    jm = JNet(TDP.mln_conf(JL, JU, JI, JNNC))
    jm.init()
    mln = (_np(jm.params), _np(jm.state))
    jp = JNet(TDP.plain_mln_conf(JL, JU, JI, JNNC))
    jp.init()
    plain = (_np(jp.params), None)
    ref = {}
    for name, kw in (("exact", {}), ("exact_unsharded", {"shard_updater_state": False})):
        net = JNet(TDP.mln_conf(JL, JU, JI, JNNC))
        net.init()
        m = JD.SharedTrainingMaster(mesh, batch_size_per_worker=4, **kw)
        loss = m.execute_training(net, x, y)
        ref[name] = {"loss": loss, "params": _np(net.params), "state": _np(net.state),
                     "opt": _np(net.opt_state)}
    net = JNet(TDP.mln_conf(JL, JU, JI, JNNC))
    net.init()
    ref["threshold"] = _jax_threshold_run(net, mesh, x, y, 1e-3)
    for freq in (1, 2):
        net = JNet(TDP.plain_mln_conf(JL, JU, JI, JNNC))
        net.init()
        m = JD.ParameterAveragingTrainingMaster(mesh, batch_size_per_worker=4,
                                                averaging_frequency=freq)
        loss = m.execute_training(net, px, py)
        ref[f"pa{freq}"] = {"loss": loss, "params": _np(net.params)}
    ranks = TL.run_ranks(TDP.masters_program, W, tmp_path_factory.mktemp("masters"),
                         timeout=240, mln=mln, plain=plain, x=x, y=y, px=px, py=py)
    return ref, ranks, (x, y, px, py), plain


@pytest.mark.parametrize("mode", ["exact", "exact_unsharded"])
def test_shared_master_exact_matches_jax_per_worker_statistics(runs, mode):
    """Parameters, averaged BN statistics and the reassembled updater state
    after 3 exact steps; the loss is the workers' mean."""
    ref, ranks = runs[0][mode], runs[1]
    for r in ranks:
        got = r[mode]
        np.testing.assert_allclose(got["loss"], ref["loss"], **F32)
        _assert_trees(got["params"], ref["params"], **F32)
        _assert_trees(got["state"], ref["state"], **F32)
        _assert_trees(got["opt"], ref["opt"], **F32)
        assert got["iteration"] == 3
    assert ranks[0]["exact"]["stats"]["updater_state_sharded"] is True


def test_shared_master_threshold_tau_and_residual_match_jax(runs):
    """Quantize-with-residual: the adaptive tau after each step and every
    worker's carried residual after 3 steps are the JAX step's."""
    ref, ranks = runs[0]["threshold"], runs[1]
    for rank, r in enumerate(ranks):
        got = r["threshold"]
        np.testing.assert_allclose(got["stats"]["final_threshold"], ref["taus"][-1], rtol=1e-6)
        _assert_trees(got["params"], ref["params"], **F32)
        want = jax.tree_util.tree_leaves(ref["resid"])
        for mine, theirs in zip(got["residual"], want):
            np.testing.assert_allclose(mine, np.asarray(theirs)[rank], **F32)
        assert len(got["stats"]["densities"]) == 3


@pytest.mark.parametrize("freq", [1, 2])
def test_parameter_averaging_matches_jax(runs, freq):
    ref, ranks = runs[0][f"pa{freq}"], runs[1]
    for r in ranks:
        got = r[f"pa{freq}"]
        np.testing.assert_allclose(got["loss"], ref["loss"], **F32)
        _assert_trees(got["params"], ref["params"], **F32)
    assert ranks[0]["pa_equal_on_ranks"]
    assert ranks[0]["pa1"]["stats"]["splits"] == 2


def test_parameter_averaging_at_frequency_one_is_synchronous_data_parallelism(runs):
    """Sgd, one local step a split: the average of the workers' steps is the
    step on the global batch (the port's own single-process fit)."""
    _, ranks, (_, _, px, py), plain = runs
    net = TDP.port_mln(*plain, plain=True)
    net.fit(px, py, batch_size=16)
    want = [{k: v.detach().numpy() for k, v in p.items()} for p in net.params]
    _assert_trees(ranks[0]["pa1"]["params"], want, **F32)
    _assert_trees(ranks[0]["facade"]["params"], want, **F32)


def test_worker_health_rollup(runs):
    """With the watchdog armed, every worker's non-finite flag and norm are
    gathered into the stats: the gradient norm for the shared master, the
    parameter norm for parameter averaging; all finite here."""
    for r in runs[1]:
        for name, key in (("rollup_shared", "grad_norm"), ("rollup_pa", "param_norm")):
            workers = r[name]
            assert [w["worker"] for w in workers] == list(range(W))
            assert not any(w["nonfinite"] for w in workers)
            assert all(w[key] > 0 for w in workers)
    assert runs[1][0]["rollup_pa"] == runs[1][1]["rollup_pa"]


class TestEncodedGradientsAccumulator:
    def test_exactly_once_fanout_and_mass_conservation(self):
        n = 4096
        acc = TD.EncodedGradientsAccumulator(n, n_workers=2, threshold=1e-3)
        rs = np.random.RandomState(0)
        g0 = (rs.randn(n) * 1e-2).astype(np.float32)
        g1 = torch.from_numpy((rs.randn(n) * 1e-2).astype(np.float32))
        assert acc.store_update(0, g0) and acc.store_update(1, g1)
        t0, t1 = np.zeros(n, np.float32), np.zeros(n, np.float32)
        assert acc.apply_updates(0, t0) == 2 and acc.apply_updates(1, t1) == 2
        np.testing.assert_array_equal(t0, t1)
        resid = acc._slots[0].residual + acc._slots[1].residual
        np.testing.assert_allclose(t0 + resid, g0 + g1.numpy(), atol=1e-6)
        assert not acc.has_anything(0) and not acc.has_anything(1)
        acc.close()

    def test_threaded_workers_stay_in_sync(self):
        n, steps, workers = 1024, 10, 4
        acc = TD.EncodedGradientsAccumulator(n, n_workers=workers, threshold=1e-3)
        params = [np.zeros(n, np.float32) for _ in range(workers)]
        barrier = threading.Barrier(workers)

        def run(w):
            rs = np.random.RandomState(100 + w)
            for _ in range(steps):
                acc.store_update(w, (rs.randn(n) * 1e-2).astype(np.float32))
                barrier.wait()
                acc.apply_updates(w, params[w])
                barrier.wait()

        ts = [threading.Thread(target=run, args=(w,)) for w in range(workers)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        for w in range(1, workers):
            np.testing.assert_array_equal(params[0], params[w])
        assert np.abs(params[0]).sum() > 0
        acc.close()


class TestDataUtils:
    def test_balanced_assignment_and_rebalance_match_jax(self):
        rs = np.random.RandomState(1)
        labels = rs.randint(0, 4, 103)
        np.testing.assert_array_equal(tdu.balanced_shard_assignment(labels, 5, seed=2),
                                      jdu.balanced_shard_assignment(labels, 5, seed=2))
        feats = rs.randn(103, 3)
        for a, b in zip(tdu.rebalance(feats, np.eye(4)[labels], 5, seed=2),
                        jdu.rebalance(feats, np.eye(4)[labels], 5, seed=2)):
            np.testing.assert_array_equal(a, b)

    def test_export_reload_and_split(self, tmp_path):
        rs = np.random.RandomState(2)
        x, y = rs.randn(10, 3), rs.randn(10, 2)
        paths = tdu.export_batches(x, y, str(tmp_path), 4)
        assert [p.split("/")[-1] for p in paths] == \
            [p.split("/")[-1] for p in jdu.export_batches(x, y, str(tmp_path / "j"), 4)]
        back = list(tdu.load_exported_batches(str(tmp_path)))
        np.testing.assert_array_equal(np.concatenate([b[0] for b in back]), x[:8])
        for a, b in zip(tdu.split_dataset(x, y, 3), jdu.split_dataset(x, y, 3)):
            np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("world", [1, 3])
def test_sharded_iterator_deals_rounds(world):
    """Batch k goes to rank k % world; a ragged final round ends the epoch
    on every rank; a single process is index 0 of 1."""
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.zeros((20, 1), np.float32)
    seen = []
    for r in range(world):
        it = ShardedDataSetIterator(ArrayDataSetIterator(x, y, batch_size=2, shuffle=False),
                                    rank=r, world=world)
        seen.append([int(b.features[0, 0]) for b in it])
    counts = {len(s) for s in seen}
    assert counts == {10 // world}
    for r in range(world):
        assert seen[r] == [4 * (r + world * k) for k in range(10 // world)]
    default = ShardedDataSetIterator(ArrayDataSetIterator(x, y, batch_size=2))
    assert (default.process_index, default.process_count) == (0, 1)


def test_parallel_inference_batched_sequential_and_hot_swap():
    net = TDP.port_mln(plain=True)
    rs = np.random.RandomState(4)
    x = rs.randn(10, 5).astype(np.float32)
    want = net.output(x).numpy()
    for mode in ("batched", "sequential"):
        pi = ParallelInference(net, max_batch_size=4, inference_mode=mode).start()
        try:
            got = np.stack([h.get(timeout=30) for h in [pi.submit(x[i]) for i in range(10)]])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(pi.output(x), want, rtol=1e-6, atol=1e-7)
            other = TDP.port_mln(plain=True, updater="adam")
            torch.manual_seed(0)
            for p in other.params:
                for v in p.values():
                    v.data.add_(0.5)
            pi.update_model(other)
            swapped = pi.submit(x[0]).get(timeout=30)
            np.testing.assert_allclose(swapped, other.output(x[:1]).numpy()[0], rtol=1e-6,
                                       atol=1e-7)
        finally:
            pi.stop()
        with pytest.raises(Exception):
            pi.submit(x[0])
    # a mesh of one data rank: the split-and-gather path answers as the JAX
    # package's ParallelInference(mesh=) on the same weights, and the
    # per-rank request queue is refused (the mesh form is collective)
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    jnet = JNet(TDP.plain_mln_conf(JL, JU, JI, JNNC))
    jnet.init()
    jpi = JInference(jnet, max_batch_size=4,
                     mesh=j_make_mesh(JMeshSpec(data=1), devices=jax.devices()[:1]))
    pi = ParallelInference(TDP.port_mln(_np(jnet.params), None, plain=True), max_batch_size=4,
                           mesh=Mesh((1, 1, 1, 1), 0, {}, {}))
    np.testing.assert_allclose(pi.output(x[:3]), np.asarray(jpi.output(x[:3])), **F32)
    with pytest.raises(ValueError, match="collective"):
        pi.start()


def test_initialize_distributed_noop_single_process():
    assert TD.initialize_distributed() is False
    assert TD.initialize_distributed(num_processes=1) is False
    assert TD.shutdown_distributed() is False
