"""The port's placement specs and single-process ParallelTrainer against
the JAX package.

- ``zero1_sharding`` leaf by leaf against the JAX rule's
  ``PartitionSpec``s: hand-picked shapes (the [4097, 512] table that falls
  through to dim 1, indivisible leaves, scalars, leaves already split on
  another axis) on data=8 and data=4 x model=2 meshes, and every leaf of
  the MLN and the fused-vertex graph of ``torch_dist_parallel.py``;
  ``slab_sharding``, the batch specs, ``opt_shardings_like`` on Adam's
  state, ``local_part``, and ``streamable_trunk``'s bounds;
- a world-1 gloo group in this process: each layout's trainer step equal
  to the bit to the net's own ``fit`` step (every collective is an
  identity), ``score``/``output``/``sync_to_net``, the listeners hearing
  the trainer, the epoch contract's errors, a world-1 sharded checkpoint
  round trip with its bucket registry, and the refusals
  (``tensor_parallel``, an unknown ``shard_params``).
"""

import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_dist_parallel as TDP
from deeplearning4j_tpu.models.misc import transformer_lm as j_lm
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNNC
from deeplearning4j_tpu.nn.fusion import FusedConvBNVertex as JFused
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import data_parallel as JDP
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu.parallel import mesh as JM
from deeplearning4j_tpu_torch.models.misc import transformer_lm as t_lm
from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import ParallelTrainer, data_parallel as TDPL
from deeplearning4j_tpu_torch.parallel import mesh as TM
from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC
from deeplearning4j_tpu_torch.utils.trees import flatten_tree, tree_leaves


def _meshes(data, model=1):
    """(the JAX mesh, the port's Mesh for rank 0) of one shape."""
    jm = j_make_mesh(JMeshSpec(data=data, model=model), devices=jax.devices()[:data * model])
    tm = TM.Mesh((data, model, 1, 1), 0, {}, {})
    return jm, tm


SHAPES = [(16, 8), (4097, 512), (3,), (), (6, 4), (7, 5), (5, 16), (8, 12, 3), (1, 24)]
# (mesh data, mesh model, leaf shape, the leaf's spec before the extension);
# a leaf is split on 'model' only where that dim divides by it
CASES = [(d, m, shape, spec[:len(shape)])
         for d, m in ((8, 1), (4, 2)) for shape in SHAPES
         for spec in ((), (None, "model"), ("model",))
         if not any(e == "model" and shape[i] % m for i, e in enumerate(spec[:len(shape)]))]


@pytest.mark.parametrize("data,model,shape,spec", CASES, ids=str)
def test_zero1_sharding_matches_jax(data, model, shape, spec):
    jm, tm = _meshes(data, model)
    leaf = np.zeros(shape, np.float32)
    want = JM.zero1_sharding(jm, NamedSharding(jm, JP(*spec)), leaf).spec
    got = TM.zero1_sharding(tm, TM.P(*spec), torch.from_numpy(leaf))
    assert tuple(got) == tuple(want)
    assert got == want


def _jax_nets():
    mln = JNet(TDP.mln_conf(JL, JU, JI, JNNC))
    mln.init()
    graph = JGraph(TDP.graph_conf(JL, JU, JI, JGB, JFused))
    graph.init()
    lm = JNet(j_lm(50, n_layers=3, d_model=16, n_heads=2, seq_len=8))
    lm.init()
    return mln, graph, lm


@pytest.mark.parametrize("data", [2, 4, 8])
def test_zero1_specs_of_every_leaf_match_jax(data):
    """Every parameter of the MLN, the fused graph and a small transformer
    LM: the port's split of each leaf is the JAX rule's."""
    jm, tm = _meshes(data)
    for jnet in _jax_nets():
        for path, leaf in flatten_tree(jax.tree_util.tree_map(np.asarray, jnet.params)).items():
            want = JM.zero1_sharding(jm, NamedSharding(jm, JP()), leaf).spec
            got = TM.zero1_sharding(tm, TM.P(), torch.from_numpy(np.asarray(leaf)))
            assert got == want, path


def test_batch_specs_slab_and_opt_specs_match_jax():
    jm, tm = _meshes(4)
    assert TM.replicated(tm) == JM.replicated(jm).spec
    assert TM.data_sharded(tm) == JM.data_sharded(jm).spec
    assert TM.superbatch_sharded(tm) == JM.superbatch_sharded(jm).spec
    assert TM.slab_sharding(tm, TM.P("data")) == JM.slab_sharding(
        jm, NamedSharding(jm, JP("data"))).spec
    net = TDP.port_mln()
    opt = net.conf.updater.init(net.params)
    shards = [{k: TM.zero1_sharding(tm, TM.P(), v) for k, v in p.items()} for p in net.params]
    specs = TM.opt_shardings_like(opt, net.params, shards, TM.P())
    assert set(specs) == {"m", "v"} and specs["m"] is shards


def test_local_part_takes_the_rank_rows():
    tm = TM.Mesh((4, 1, 1, 1), 2, {}, {})
    x = np.arange(32).reshape(8, 4)
    np.testing.assert_array_equal(TM.ensure_data_sharded(tm, x).numpy(), x[4:6])
    np.testing.assert_array_equal(TM.local_part(tm, x, TM.P(None, "data")).numpy(), x[:, 2:3])
    sb = TM.shard_batch(tm, {"a": x, "b": x[:, 0]})
    np.testing.assert_array_equal(sb["b"].numpy(), x[4:6, 0])
    with pytest.raises(ValueError, match="does not split"):
        TM.ensure_data_sharded(tm, x[:6])


def test_streamable_trunk_matches_jax():
    jmln, jgraph, jlm = _jax_nets()
    tmln = TDP.port_mln()
    tlm = TNet(t_lm(50, n_layers=3, d_model=16, n_heads=2, seq_len=8), device="cpu")
    tlm.init()
    for j, t in ((jmln, tmln), (jlm, tlm)):
        assert TDPL.streamable_trunk(t, t.params, t.state) == \
            JDP.streamable_trunk(j, j.params, j.state)
    assert TDPL.streamable_trunk(TDP.port_graph(), None, None) is None


# ---------------------------------------------------------------------------
# a world-1 group in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    d = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=0,
                            world_size=1)
    try:
        yield TM.make_mesh()
    finally:
        dist.destroy_process_group()


def _data(n=16):
    rs = np.random.RandomState(5)
    return (rs.randn(n, 5).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])


@pytest.mark.parametrize("layout", TDP.LAYOUTS)
def test_world1_step_is_fit_step_to_the_bit(world1, layout):
    x, y = _data()
    ref = TDP.port_mln()
    ref.fit(x, y, batch_size=8)
    net = TDP.port_mln()
    tr = TDP._trainer(net, layout, world1).adopt_net_state()
    tr.timing = True  # synchronizes around the collectives; changes no value
    losses = [float(tr.step(x[:8], y[:8])), float(tr.step(x[8:], y[8:]))]
    assert len(tr.collective_ms) == 2 and min(tr.collective_ms) > 0
    assert losses == [float(s) for s in ref.score_history]
    assert tr.layout == layout and tr.iteration == 2
    tr.sync_to_net()
    for a, b in zip(tree_leaves(net.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(net.opt_state), tree_leaves(ref.opt_state)):
        assert torch.equal(a, b)
    assert tr.score(x, y) == pytest.approx(ref.score(x, y), rel=1e-6)
    torch.testing.assert_close(tr.output(x), ref.output(x))
    assert tr.step_memory_analysis(x, y) is None  # no card


def test_world1_fit_listeners_and_epoch_contract(world1):
    x, y = _data()
    tr = TDP._trainer(TDP.port_mln(), "zero1", world1).adopt_net_state()
    li = CollectScoresListener()
    tr.add_listener(li)
    score = tr.fit(x, y, batch_size=4, epochs=2)
    assert tr.iteration == 8 and tr.epoch == 2 and len(tr.score_history) == 8
    assert score == tr.score_history[-1]
    assert len(li.scores) == 8
    with pytest.raises(ValueError, match="input exhausted"):
        tr.fit(iter([(x[:4], y[:4])]), epochs=2)
    with pytest.raises(ValueError, match="no effect with an iterator"):
        tr.fit(iter([(x, y)]), batch_size=4)


def test_world1_checkpoint_round_trip(world1, tmp_path):
    from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry

    x, y = _data()
    tr = TDP._trainer(TDP.port_mln(), "fsdp", world1).adopt_net_state()
    tr.fit(x, y, batch_size=8)
    path = SC.save_trainer(tmp_path / "ckpt", tr, buckets=BucketRegistry([8, 16]))
    back = SC.restore_trainer(path, TDP._trainer(TDP.port_mln(), "replicated", world1))
    assert (back.iteration, back.epoch) == (2, 1)
    assert back.buckets.sizes() == [8, 16]
    want = tr.sync_to_net()
    for a, b in zip(tree_leaves(back.sync_to_net().params), tree_leaves(want.params)):
        assert torch.equal(a, b)
    assert SC.read_index(path)["scalars"]["layout"] == "fsdp"


def test_refusals(world1):
    """The refusals that stand, and tensor parallelism's spec tree: the
    JAX rule on a model=2 mesh (a divisible Dense W splits its columns, the
    3-wide output layer stays whole, BN's gamma/beta split), all whole on
    a model=1 mesh. Tensor parallelism with fsdp_stream is a layout that
    runs (the JAX trainer takes it), not a refusal."""
    net = TDP.port_mln()
    assert all(s == () for s in tree_leaves(TDPL.make_param_shardings(world1, net, net.params)))
    assert all(s == () for s in tree_leaves(
        TDPL.make_param_shardings(world1, net, net.params, tensor_parallel=True)))
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    tp2 = Mesh((1, 2, 1, 1), 0, {}, {})
    specs = TDPL.make_param_shardings(tp2, net, net.params, tensor_parallel=True)
    assert specs[0]["W"] == (None, "model") and specs[0]["b"] == ("model",)
    assert specs[1]["gamma"] == ("model",) and specs[1]["beta"] == ("model",)
    assert specs[-1]["W"] == () and specs[-1]["b"] == ()
    tr = ParallelTrainer(net, world1, tensor_parallel=True, shard_params="fsdp_stream")
    assert tr.tensor_parallel and tr.layout == "fsdp_stream"
    with pytest.raises(ValueError, match="shard_params"):
        ParallelTrainer(net, world1, shard_params="zero3")
    with pytest.raises(ValueError, match="homogeneous trunk"):
        TDP._trainer(TDP.port_mln(plain=True), "fsdp_stream", world1).adopt_net_state()
