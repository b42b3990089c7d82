"""The rank programs of ``test_torch_parallel.py`` and
``test_torch_distributed.py``, run on the CPU as gloo processes by the
port's ``parallel.launch.run_ranks``, and the network configurations both
packages build (the configuration builders take the package's modules).

This module imports torch, numpy and the port only (never JAX), so a
spawned rank starts in a few seconds.
"""

import numpy as np
import torch
import torch.distributed as dist

LAYOUTS = ("replicated", "zero1", "fsdp", "fsdp_stream")
GRAPH_LAYOUTS = ("replicated", "zero1", "fsdp")
STEPS = 3


# ---------------------------------------------------------------------------
# configurations, for either package
# ---------------------------------------------------------------------------

def mln_conf(L, U, I, NeuralNetConfig, *, updater="adam", dropout=0.0,
             normalization="renormalize_l2_per_layer"):
    """Dense -> BatchNormalization -> a trunk of 3 identical Dense layers ->
    softmax output: every layout, fsdp_stream's trunk included."""
    u = U.Adam(learning_rate=0.01) if updater == "adam" else U.Sgd(learning_rate=0.1)
    return NeuralNetConfig(seed=3, updater=u, gradient_normalization=normalization).list(
        L.DenseLayer(n_out=8, activation="tanh", dropout=dropout), L.BatchNormalization(),
        L.DenseLayer(n_out=8, activation="tanh"), L.DenseLayer(n_out=8, activation="tanh"),
        L.DenseLayer(n_out=8, activation="tanh"), L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(5))


def plain_mln_conf(L, U, I, NeuralNetConfig, *, updater="sgd"):
    """Dense -> softmax output, no batch statistics (the TrainingMasters'
    parameter-averaging identity)."""
    u = U.Adam(learning_rate=0.01) if updater == "adam" else U.Sgd(learning_rate=0.1)
    return NeuralNetConfig(seed=5, updater=u).list(
        L.DenseLayer(n_out=8, activation="tanh"), L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(5))


def graph_conf(L, U, I, GraphBuilder, FusedConvBNVertex):
    """A ResNet-like block of fused conv-BN vertices (3x3, then a 1x1 with
    a residual add), global pooling and a softmax output."""
    b = GraphBuilder(updater=U.Adam(learning_rate=0.01), seed=3)
    b.add_inputs("in")
    b.set_input_types(I.ConvolutionalType(4, 4, 3))
    b.add_vertex("c1", FusedConvBNVertex(n_out=8, kernel=(3, 3)), "in")
    b.add_vertex("c2", FusedConvBNVertex(n_out=8, kernel=(1, 1), activation="identity",
                                         residual=True), "c1", "c1")
    b.add_layer("pool", L.GlobalPoolingLayer("avg"), "c2")
    b.add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "pool")
    b.set_outputs("out")
    return b.build()


def port_mln(params=None, state=None, **kw):
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import serialization as ser

    conf = (plain_mln_conf if kw.pop("plain", False) else mln_conf)(L, U, I, NeuralNetConfig,
                                                                    **kw)
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    if params is not None:
        ser.params_from_numpy(net, params, state=state)
    return net


def port_graph(params=None, state=None):
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.fusion import FusedConvBNVertex
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
    from deeplearning4j_tpu_torch.utils import serialization as ser

    net = ComputationGraph(graph_conf(L, U, I, GraphBuilder, FusedConvBNVertex), device="cpu")
    net.init(dtype=torch.float64)
    if params is not None:
        ser.params_from_numpy(net, params, state=state)
    return net


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(tree):
    """A parameter or state tree as plain lists/dicts of numpy arrays."""
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _trainer(net, layout, mesh):
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    return ParallelTrainer(net, mesh, shard_optimizer_state=layout != "replicated",
                           shard_params={"fsdp": "fsdp", "fsdp_stream": "fsdp_stream"}.get(layout))


def _run(net, layout, mesh, x, y, mask=None, steps=STEPS):
    """``steps`` trainer steps; (losses, whole params, state, trainer)."""
    tr = _trainer(net, layout, mesh).adopt_net_state()
    losses = [float(tr.step(x, y, mask)) for _ in range(steps)]
    tr.sync_to_net()
    return losses, _np(net.params), _np(net.state), tr


def _fused_stats_check(rank, world, group):
    """The fused conv-BN op on this rank's rows under the batch group
    against the whole batch without one: y rows, the batch mean and
    variance, dx rows, and dW, dgamma, dbeta summed over the ranks."""
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.utils import collectives as K

    rs = np.random.RandomState(21)
    x = torch.from_numpy(rs.randn(4 * world, 4, 4, 3) * 2 + 1)
    w = torch.from_numpy(rs.randn(3, 3, 3, 6) * 0.3)
    gamma = torch.from_numpy(rs.rand(6) + 0.5)
    beta = torch.from_numpy(rs.randn(6))
    g = torch.from_numpy(rs.randn(4 * world, 4, 4, 6))
    out = {}

    def run(xx, gg, bg):
        xs, ws, gs, bs = (t.clone().requires_grad_(True) for t in (xx, w, gamma, beta))
        with K.sync_batch(bg):
            y, mean, var = C.fused_conv_bn_act(xs, ws, gs, bs, stride=(1, 1))
            (y * gg).sum().backward()
        return y.detach(), mean, var, xs.grad, ws.grad, gs.grad, bs.grad

    whole = run(x, g, None)
    rows = slice(rank * 4, (rank + 1) * 4)
    mine = run(x[rows], g[rows], K.BatchGroup(group, rank, world))
    summed = [K.all_reduce_(t.clone(), group) for t in mine[4:]]
    for name, a, b in (("y", mine[0], whole[0][rows]), ("mean", mine[1], whole[1]),
                       ("var", mine[2], whole[2]), ("dx", mine[3], whole[3][rows]),
                       ("dW", summed[0], whole[4]), ("dgamma", summed[1], whole[5]),
                       ("dbeta", summed[2], whole[6])):
        out[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    return out


def _mesh_engine(mesh, mln, x):
    """The serving engine over the mesh (collective ``output``): its
    buckets rounded to the data axis, 11 rows through buckets 3 and 6 (two
    chunks), the queued path refused."""
    from deeplearning4j_tpu_torch.serving import ServingEngine

    eng = ServingEngine(port_mln(*mln), name="mesh", mesh=mesh, input_spec=(5,), buckets=(3, 6),
                        device="cpu")
    out = {"buckets": eng.stats()["buckets"], "got": eng.output(x[:11]),
           "forward": eng.stats()["forward"]}
    try:
        eng.start()
        out["start_refusal"] = ""
    except ValueError as e:
        out["start_refusal"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the trainer's rank program
# ---------------------------------------------------------------------------

def trainer_program(rank, world, mln, graph, x, y, gx, gy, ckpt_dir, restore_from=None,
                    bundle=None):
    """Every ParallelTrainer check on one rank (see test_torch_parallel.py):
    each layout's 3 steps on the MLN (float32) and the graph of fused
    conv-BN vertices (float64) from the given weights; fsdp_stream's
    refusal of a graph; the fused op's statistics under the batch group;
    and by world size: at 4, checkpoints of every layout (plus the step
    after each); at 2, a masked loss with uneven valid counts, dropout,
    ragged batches, K=4 against K=1, the world-4 checkpoints restored into
    every layout and a single-process bundle adopted by split trainers."""
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.utils import collectives as K
    from deeplearning4j_tpu_torch.utils import serialization as ser
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC

    mesh = make_mesh()
    out = {"mln": {}, "graph": {}}
    for layout in LAYOUTS:
        net = port_mln(*mln)
        losses, params, state, tr = _run(net, layout, mesh, x, y)
        out["mln"][layout] = {"losses": losses, "params": params, "state": state,
                              "bytes": tr.tree_bytes(), "trunk": tr._trunk}
        if world == 4:
            SC.save_trainer(f"{ckpt_dir}/{layout}", tr)
            out["mln"][layout]["next_loss"] = float(tr.step(x, y))
    for layout in GRAPH_LAYOUTS:
        losses, params, state, _ = _run(port_graph(*graph), layout, mesh, gx, gy)
        out["graph"][layout] = {"losses": losses, "params": params, "state": state}
    try:
        _trainer(port_graph(*graph), "fsdp_stream", mesh).adopt_net_state()
        out["graph_stream_refusal"] = ""
    except ValueError as e:
        out["graph_stream_refusal"] = str(e)
    out["fused_stats"] = _fused_stats_check(rank, world, mesh.group("data"))
    out["mesh_engine"] = _mesh_engine(mesh, mln, x)
    if world == 4:
        return out

    # a masked loss whose ranks hold 2 and 7 valid rows: the trainer against
    # the whole batch's step on one process
    mask = np.zeros(len(x), np.float32)
    half = len(x) // 2
    mask[:2] = 1.0
    mask[half:half + 7] = 1.0
    ref = port_mln(*mln)
    ref.fit(x, y, mask=mask)
    got, params, _, _ = _run(port_mln(*mln), "zero1", mesh, x, y, mask=mask, steps=1)
    out["masked"] = {"loss": got[0], "ref_loss": float(ref.score_history[0]),
                     "params": params, "ref_params": _np(ref.params)}

    # dropout (input dropout on the first layer) draws what world 1 draws
    ref = port_mln(*mln, dropout=0.4)
    ref.fit(x, y)
    got, params, _, _ = _run(port_mln(*mln, dropout=0.4), "replicated", mesh, x, y, steps=1)
    nodrop = port_mln(*mln)
    nodrop.fit(x, y)
    out["dropout"] = {"loss": got[0], "ref_loss": float(ref.score_history[0]),
                      "nodrop_loss": float(nodrop.score_history[0]), "params": params,
                      "ref_params": _np(ref.params)}

    # ragged batches: 15 rows in batches of 4 leave a batch of 3, dropped
    tr = _trainer(port_mln(*mln), "zero1", mesh).adopt_net_state()
    tr.fit(x[:15], y[:15], batch_size=4)
    out["ragged"] = {"dropped": tr.examples_dropped, "steps": tr.iteration,
                     "scores": len(tr.score_history)}

    # K=4 against K=1 over 8 batches of 4 (two dispatches)
    xs, ys = np.concatenate([x, x]), np.concatenate([y, y[::-1]])
    k1 = _trainer(port_mln(*mln), "zero1", mesh).adopt_net_state()
    k1.fit(xs, ys, batch_size=4)
    k4 = _trainer(port_mln(*mln), "zero1", mesh).adopt_net_state()
    k4.fit(xs, ys, batch_size=4, steps_per_dispatch=4)
    out["k4"] = {"k1_scores": [float(s) for s in k1.score_history],
                 "k4_scores": [float(s) for s in k4.score_history],
                 "k1_params": _np(k1.sync_to_net().params),
                 "k4_params": _np(k4.sync_to_net().params),
                 "dispatches": k4._steps_fns_fused[4].calls,
                 "captures": k4._steps_fns_fused[4].captures}

    # the world-4 checkpoints restored into every layout at world 2
    out["restored"] = {}
    for src in LAYOUTS:
        for dst in LAYOUTS:
            tr = SC.restore_trainer(f"{restore_from}/{src}", _trainer(port_mln(*mln), dst, mesh))
            loss = float(tr.step(x, y))
            tr.sync_to_net()
            out["restored"][(src, dst)] = {"iteration": tr.iteration, "epoch": tr.epoch,
                                           "next_loss": loss}

    # a single-process bundle adopted by split trainers
    out["bundle"] = {}
    for layout in ("zero1", "fsdp", "fsdp_stream"):
        net = ser.load_bundle(bundle, device="cpu").net
        tr = _trainer(net, layout, mesh).adopt_net_state()
        b = tr.tree_bytes()
        tr.sync_to_net()
        out["bundle"][layout] = {"params": _np(net.params), "opt": _np(net.opt_state),
                                 "iteration": net.iteration, "bytes": b}
    out["batch_group_off_after"] = K.active() is None
    return out


# ---------------------------------------------------------------------------
# the TrainingMasters' rank program
# ---------------------------------------------------------------------------

def masters_program(rank, world, mln, plain, x, y, px, py):
    """The TrainingMasters on one rank (see test_torch_distributed.py): the
    exact and the threshold SharedTrainingMaster on the MLN with batch
    normalization (per-worker statistics), 3 steps each, with the
    threshold mode's residual and tau; parameter averaging at frequency 1
    and 2 on the plain MLN; and the facade."""
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayer,
                                                   ParameterAveragingTrainingMaster,
                                                   SharedTrainingMaster, make_mesh)

    mesh = make_mesh()
    out = {}
    for name, kw in (("exact", {}), ("threshold", {"threshold": 1e-3}),
                     ("exact_unsharded", {"shard_updater_state": False})):
        net = port_mln(*mln)
        m = SharedTrainingMaster(mesh, batch_size_per_worker=4, **kw)
        loss = m.execute_training(net, x, y)
        out[name] = {"loss": loss, "params": _np(net.params), "state": _np(net.state),
                     "opt": _np(net.opt_state), "stats": m.training_stats(),
                     "iteration": net.iteration}
        if kw.get("threshold"):
            out[name]["residual"] = [r.numpy().copy() for r in m.residual]
    for freq in (1, 2):
        net = port_mln(*plain, plain=True)
        m = ParameterAveragingTrainingMaster(mesh, batch_size_per_worker=4,
                                             averaging_frequency=freq)
        loss = m.execute_training(net, px, py)
        out[f"pa{freq}"] = {"loss": loss, "params": _np(net.params),
                            "stats": m.training_stats(), "iteration": net.iteration}
    # the numerics watchdog armed: each worker's flag and norm reach the stats
    from deeplearning4j_tpu_torch.telemetry import health
    health.enable()
    try:
        for name, m in (("shared", SharedTrainingMaster(mesh, batch_size_per_worker=4)),
                        ("pa", ParameterAveragingTrainingMaster(mesh, batch_size_per_worker=4,
                                                                averaging_frequency=1))):
            m.execute_training(port_mln(*plain, plain=True), px[:16], py[:16])
            out[f"rollup_{name}"] = m.training_stats()["workers"]
    finally:
        health.disable()
    facade = DistributedMultiLayer(port_mln(*plain, plain=True),
                                   ParameterAveragingTrainingMaster(
                                       mesh, batch_size_per_worker=4, averaging_frequency=1))
    out["facade"] = {"loss": facade.fit([(px[:16], py[:16]), (px[16:], py[16:])]),
                     "params": _np(facade.net.params)}
    flat = torch.cat([torch.from_numpy(a).reshape(-1) for p in out["pa2"]["params"]
                      for a in p.values()])
    mine = flat.clone()
    dist.broadcast(flat, 0)
    out["pa_equal_on_ranks"] = bool(torch.equal(mine, flat))
    return out
