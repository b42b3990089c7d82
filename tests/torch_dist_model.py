"""The rank programs of ``test_torch_tensor_parallel.py``,
``test_torch_pipeline.py`` and ``test_torch_pipeline_general.py``, run on
the CPU as gloo processes by the port's
``parallel.launch.run_ranks``, and the configurations both packages build
(the configuration functions take the package's modules).

This module imports torch, numpy and the port only (never JAX), so a
spawned rank starts in a few seconds.
"""

import numpy as np
import torch

import torch_dist_parallel as TDP

STEPS = 3
#: intra-op threads a rank: four ranks share the host with the other test
#: workers, and the tiny shapes gain nothing from more
RANK_THREADS = 1
TP_LAYOUTS = ("replicated", "zero1", "fsdp", "fsdp_stream")
LM = dict(vocab_size=16, n_layers=4, d_model=8, n_heads=2, seq_len=6)
LM_BATCH = 8
LR = 0.1
#: a capacity factor at which the MoE LM's experts overflow on its batch
MOE_TIGHT = 0.5
#: the weight noise of the noisy MLN (additive normal)
NOISE_STD = 0.05


# ---------------------------------------------------------------------------
# configurations, for either package
# ---------------------------------------------------------------------------

def tp_graph_conf(L, U, I, GraphBuilder):
    """conv (8 channels, split 4 + 4) -> BatchNormalization -> global pool
    -> a 4-class softmax (split, so it gathers its weights)."""
    b = GraphBuilder(updater=U.Adam(learning_rate=0.01), seed=5)
    b.add_inputs("in")
    b.set_input_types(I.ConvolutionalType(4, 4, 3))
    b.add_layer("conv", L.ConvolutionLayer(n_out=8, kernel=(3, 3), padding="same",
                                           activation="relu"), "in")
    b.add_layer("bn", L.BatchNormalization(), "conv")
    b.add_layer("pool", L.GlobalPoolingLayer("avg"), "bn")
    b.add_layer("out", L.OutputLayer(n_out=4, loss="mcxent"), "pool")
    b.set_outputs("out")
    return b.build()


def moe_conf(L, U, I, NeuralNetConfig, capacity_factor=1.25):
    """The JAX MoE test's LM with 8 experts (2 a rank on a model=4 mesh),
    under plain SGD: the attention's key bias has a zero gradient, whose
    rounding noise Adam would blow up to a full step."""
    return NeuralNetConfig(seed=3, updater=U.Sgd(learning_rate=0.1)).list(
        L.EmbeddingSequenceLayer(n_in=20, n_out=16, add_positional=True),
        L.MoETransformerBlock(n_out=16, n_heads=2, n_experts=8, causal=True,
                              capacity_factor=capacity_factor, aux_loss_weight=0.01),
        L.RnnOutputLayer(n_out=20, loss="mcxent"),
        input_type=I.RecurrentType(1, 8))


def lm_conf(L, U, I, NeuralNetConfig):
    """A transformer LM at ``LM``'s widths with 2 blocks, the homogeneous
    trunk ``fsdp_stream`` streams; the embedding and the output layer split
    over 'model'. SGD, for gradients read from one step."""
    return NeuralNetConfig(seed=7, updater=U.Sgd(learning_rate=LR)).list(
        L.EmbeddingSequenceLayer(n_in=LM["vocab_size"], n_out=LM["d_model"],
                                 add_positional=True),
        *[L.TransformerBlock(n_out=LM["d_model"], n_heads=LM["n_heads"], causal=True)
          for _ in range(2)],
        L.RnnOutputLayer(n_out=LM["vocab_size"], loss="mcxent"),
        input_type=I.RecurrentType(1, LM["seq_len"]))


def noise_conf(L, U, I, NeuralNetConfig, WeightNoise, Distribution, std=NOISE_STD):
    """Three Dense layers (each W and b split over 'model') under additive
    normal weight noise of ``std``, and a softmax output; SGD."""
    wn = WeightNoise(distribution=Distribution(kind="normal", mean=0.0, std=std),
                     apply_to_bias=True)
    return NeuralNetConfig(seed=11, updater=U.Sgd(learning_rate=LR)).list(
        *[L.DenseLayer(n_out=8, activation="tanh", weight_noise=wn) for _ in range(3)],
        L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(5))


def resnet_mln_conf(resnet50_mln):
    """The JAX pipeline test's reduced ResNet50 MLN (BN in every block)."""
    return resnet50_mln(height=16, width=16, channels=3, n_classes=5,
                        stages=[(4, 2, (1, 1)), (8, 2, (2, 2))], stem_filters=4, seed=9)


def lstm_conf(L, I, NeuralNetConfig):
    """The JAX pipeline test's masked LSTM stack."""
    return NeuralNetConfig(seed=6).list(L.LSTM(n_out=16), L.LSTM(n_out=16),
                                        L.RnnOutputLayer(n_out=5, loss="mcxent"),
                                        input_type=I.RecurrentType(4, 6))


def resnet_graph_conf(resnet50):
    """The JAX pipeline test's reduced ResNet50 graph (141 vertices)."""
    return resnet50(height=16, width=16, channels=3, n_classes=4, seed=13)


#: one vertex a stage, then the rest: d1's output is live across every boundary
SKIP_STAGES = [["d1"], ["d2"], ["d3"], ["d4", "add", "out"]]


def skip_graph_conf(L, I, GraphBuilder, ElementWiseVertex):
    """The JAX pipeline test's long skip connection: d1's output joins d4's
    on the last of 4 stages; d2 carries an L2 penalty."""
    g = GraphBuilder(seed=4)
    g.add_inputs("in")
    g.set_input_types(I.FeedForwardType(12))
    g.add_layer("d1", L.DenseLayer(n_out=12, activation="relu"), "in")
    g.add_layer("d2", L.DenseLayer(n_out=12, activation="relu", l2=0.01), "d1")
    g.add_layer("d3", L.DenseLayer(n_out=12, activation="relu"), "d2")
    g.add_layer("d4", L.DenseLayer(n_out=12, activation="relu"), "d3")
    g.add_vertex("add", ElementWiseVertex(op="add"), "d4", "d1")
    g.add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "add")
    g.set_outputs("out")
    return g.build()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(tree):
    return TDP._np(tree)


def _port(conf, params=None, state=None, dtype=None):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import serialization as ser
    cls = ComputationGraph if isinstance(conf, GraphConfiguration) else MultiLayerNetwork
    net = cls(conf, device="cpu")
    net.init(dtype=dtype)
    if params is not None:
        ser.params_from_numpy(net, params, state=state)
    return net


def _modules():
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
    return L, U, I, NeuralNetConfig, GraphBuilder


def _trainer(net, mesh, layout, tensor_parallel=True):
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    return ParallelTrainer(net, mesh, tensor_parallel=tensor_parallel,
                           shard_optimizer_state=layout != "replicated",
                           shard_params=layout if layout.startswith("fsdp") else None
                           ).adopt_net_state()


def _tp_run(net, mesh, layout, x, y, steps=STEPS, tensor_parallel=True):
    tr = _trainer(net, mesh, layout, tensor_parallel)
    losses = [float(tr.step(x, y)) for _ in range(steps)]
    local = _np(net.params) if not layout.startswith("fsdp") else None
    stored = tr.tree_bytes()
    tr.sync_to_net()
    return {"losses": losses, "params": _np(net.params), "state": _np(net.state),
            "local": local, "specs": getattr(tr, "_tp_specs", None), "bytes": stored}


def _fg_check(rank, group, world):
    """The conjugate pair's transposes on rank-distinct inputs: g sums
    forward and passes the cotangent; f is the identity forward and sums
    the cotangents; the all-gather's backward keeps the local slice."""
    from deeplearning4j_tpu_torch.parallel.composed import id_psum_bwd, psum_id_bwd
    from deeplearning4j_tpu_torch.utils import collectives as C

    rs = np.random.RandomState(rank)
    x = torch.from_numpy(rs.randn(3, 4)).requires_grad_(True)
    ct = torch.from_numpy(rs.randn(3, 4))
    y = psum_id_bwd(x, group)
    (y * ct).sum().backward()
    out = {"g_fwd": y.detach().numpy(), "g_bwd": x.grad.numpy().copy(), "ct": ct.numpy()}
    x.grad = None
    y = id_psum_bwd(x, group)
    (y * ct).sum().backward()
    out.update(f_fwd=y.detach().numpy(), f_bwd=x.grad.numpy().copy(), x=x.detach().numpy())
    x.grad = None
    y = C.GatherSliceBwd.apply(x, 1, group)
    (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)).sum().backward()
    out.update(gather=y.detach().numpy(), gather_bwd=x.grad.numpy().copy())
    return out


# ---------------------------------------------------------------------------
# tensor and expert parallelism
# ---------------------------------------------------------------------------

def moe_drops(net, x):
    """Tokens each MoE block of ``net`` drops on the global batch ``x`` at
    its current parameters (the world-1 routing, which the global routing
    of a data-parallel step reproduces)."""
    from deeplearning4j_tpu_torch.nn.layers.moe import MoETransformerBlock
    h = torch.as_tensor(np.asarray(x))
    drops = []
    with torch.no_grad():
        for layer, p in zip(net.conf.layers, net.params):
            if isinstance(layer, MoETransformerBlock):
                res, h2 = layer.mlp_input(p, h)
                drops.append(int((~layer.route(p, h2.reshape(-1, h2.shape[-1])).keep).sum()))
                h, _ = layer.apply(p, {}, h)
            else:
                h, _ = layer.apply(p, {}, h)
    return drops


def _sgd_grads(before, after):
    """{path: (before - after) / LR}: the gradient of one SGD step."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree
    a, b = flatten_tree(before), flatten_tree(after)
    return {k: (np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)) / LR for k in a}


def _one_step_grads(tr, net, x, y):
    """(loss, gradients) of one SGD step of trainer ``tr`` on ``net``."""
    tr.sync_to_net()
    before = _np(net.params)
    loss = float(tr.step(x, y))
    tr.sync_to_net()
    return loss, _sgd_grads(before, _np(net.params))


def _tp_checkpoint(mln, x, y, mesh22, mesh4, ckpt):
    """The TP trainer's sharded checkpoint: 2 steps on data=2 x model=2,
    saved; the uninterrupted 3rd step; the checkpoint restored on data=4 x
    model=1 and its 3rd step."""
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC
    tr = _trainer(TDP.port_mln(*mln), mesh22, "zero1")
    for _ in range(2):
        tr.step(x, y)
    SC.save_trainer(ckpt, tr)
    third = float(tr.step(x, y))
    tr.sync_to_net()
    out = {"loss": third, "params": _np(tr.net.params), "state": _np(tr.net.state)}
    tr4 = SC.restore_trainer(ckpt, _trainer(TDP.port_mln(), mesh4, "zero1", False))
    out["data4"] = {"iteration": tr4.iteration, "loss": float(tr4.step(x, y))}
    tr4.sync_to_net()
    out["data4"].update(params=_np(tr4.net.params), state=_np(tr4.net.state))
    return out


def tp_program(rank, world, mln, graph, moe, plain, x, y, gx, gy, mx, my, fx, moe_tight, lm,
               lx, ly, noisy, ckpt):
    """Every tensor/expert-parallel check on one rank of 4: the MLN on a
    data=2 x model=2 mesh in each layout, the float64 graph, the MoE LM on
    model=4 (2 experts a rank) and its world-1 replicated step, the
    overflowing MoE LM on data=2 x model=2 and on data=2 alone (the model
    axis replicating), the LM under fsdp_stream, the noisy MLN against its
    world-1 step, the TP sharded checkpoint, the f/g pair, and
    ParallelInference over data=4."""
    torch.set_num_threads(RANK_THREADS)
    from deeplearning4j_tpu_torch.nn.initializers import Distribution
    from deeplearning4j_tpu_torch.nn.weightnoise import WeightNoise
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelInference, make_mesh
    from deeplearning4j_tpu_torch.utils import collectives as C

    L, U, I, NNC, GB = _modules()
    mesh22 = make_mesh(MeshSpec(data=2, model=2))
    out = {"mln": {}}
    for layout in TP_LAYOUTS:
        out["mln"][layout] = _tp_run(TDP.port_mln(*mln), mesh22, layout, x, y)
    out["graph"] = _tp_run(_port(tp_graph_conf(L, U, I, GB), *graph, dtype=torch.float64),
                           mesh22, "zero1", gx, gy)
    mesh4 = make_mesh(MeshSpec(data=1, model=4))
    out["moe"] = _tp_run(_port(moe_conf(L, U, I, NNC), *moe), mesh4, "zero1", mx, my, steps=2)
    tight = moe_conf(L, U, I, NNC, capacity_factor=MOE_TIGHT)
    out["moe_drops"] = moe_drops(_port(tight, *moe_tight), mx)
    out["moe_global"] = {
        "data2_model2": _tp_run(_port(tight, *moe_tight), mesh22, "zero1", mx, my, steps=2),
        "data2": _tp_run(_port(tight, *moe_tight), mesh22, "zero1", mx, my, steps=2,
                         tensor_parallel=False)}
    net = _port(lm_conf(L, U, I, NNC), *lm)
    out["lm_stream"] = _one_step_grads(_trainer(net, mesh22, "fsdp_stream"), net, lx, ly)
    noise = {}
    for std in (NOISE_STD, 0.0):
        conf = noise_conf(L, U, I, NNC, WeightNoise, Distribution, std=std)
        net = _port(conf, *noisy)
        noise[std] = _one_step_grads(_trainer(net, mesh22, "zero1"), net, x, y)
    whole = _port(noise_conf(L, U, I, NNC, WeightNoise, Distribution), *noisy)
    before = _np(whole.params)
    whole.fit(x, y)
    noise["world1"] = (float(whole.score_history[0]), _sgd_grads(before, _np(whole.params)))
    out["noise"] = noise
    out["ckpt"] = _tp_checkpoint(mln, x, y, mesh22, make_mesh(MeshSpec(data=4)), ckpt)
    out["fg"] = _fg_check(mesh22.coords["model"], mesh22.group("model"), 2)
    out["model_group_off_after"] = C.active_model() is None
    net = TDP.port_mln(*plain, plain=True)
    pi = ParallelInference(net, max_batch_size=6, mesh=make_mesh(MeshSpec(data=4)))
    out["inference"] = {"got": pi.output(fx), "max_batch": pi.max_batch}
    return out


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

def _lm_result(lm, ids, labels):
    ref = float(lm.loss_reference(ids, labels))
    loss = float(lm.step(ids, labels))
    blocks = _np(lm.all_blocks())
    return {"ref": ref, "loss": loss, "blocks": blocks, "embed": _np(lm.params["embed"]),
            "head": _np(lm.params["head"]), "stash": lm.last_peak_stash}


def _meshes(*names):
    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
    specs = {"stage4": MeshSpec(data=1, stage=4), "data2_stage2": MeshSpec(data=2, stage=2),
             "model2_stage2": MeshSpec(data=1, model=2, stage=2),
             "data2_model2": MeshSpec(data=2, model=2)}
    return {k: make_mesh(specs[k]) for k in names}


def pipeline_program(rank, world, lm, composed, ids, labels, ckpt):
    """The LM pipelines on one rank of 4 (see test_torch_pipeline.py):
    ``PipelineParallelLM`` on stage=4 (both schedules) and data=2 x stage=2,
    ``ComposedParallelLM`` on model=2 x stage=2 (both) and data=2 x model=2,
    ZeRO-1 of the composed LM's updater state, and the LM's sharded
    checkpoint round trip."""
    torch.set_num_threads(RANK_THREADS)
    from deeplearning4j_tpu_torch.parallel import ComposedParallelLM, PipelineParallelLM
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC

    _, U, _, _, _ = _modules()
    meshes = _meshes("stage4", "data2_stage2", "model2_stage2", "data2_model2")
    out = {"lm": {}, "composed": {}}
    for name, sched, n_micro in (("stage4", "gpipe", 4), ("stage4", "1f1b", 4),
                                 ("data2_stage2", "1f1b", 2)):
        m = PipelineParallelLM(**LM, mesh=meshes[name], n_microbatches=n_micro, schedule=sched,
                               updater=U.Sgd(learning_rate=LR), device="cpu")
        out["lm"][(name, sched)] = _lm_result(m.init(from_params=lm), ids, labels)

    for name, sched in (("model2_stage2", "gpipe"), ("model2_stage2", "1f1b"),
                        ("data2_model2", "gpipe")):
        m = ComposedParallelLM(**LM, mesh=meshes[name], n_microbatches=2, schedule=sched,
                               updater=U.Sgd(learning_rate=LR), device="cpu")
        out["composed"][(name, sched)] = _lm_result(m.init(from_params=composed), ids, labels)
    zero = {}
    for shard in (False, True):
        m = ComposedParallelLM(**LM, mesh=meshes["data2_model2"], n_microbatches=2,
                               updater=U.Adam(learning_rate=0.01), shard_optimizer_state=shard,
                               device="cpu").init(from_params=composed)
        zero[shard] = {"losses": [float(m.step(ids, labels)) for _ in range(2)],
                       "m_shape": tuple(m.opt_state["m"]["head"]["W"].shape),
                       "blocks": _np(m.all_blocks())}
    out["composed_zero"] = zero

    m = PipelineParallelLM(**LM, mesh=meshes["data2_stage2"], n_microbatches=2,
                           device="cpu").init(from_params=lm)
    m.step(ids, labels)
    SC.save_trainer(ckpt, m)
    a = float(m.step(ids, labels))
    m2 = PipelineParallelLM(**LM, mesh=meshes["data2_stage2"], n_microbatches=2,
                            device="cpu").init()
    SC.restore_trainer(ckpt, m2)
    restored_at = m2.iteration
    out["ckpt"] = {"a": a, "b": float(m2.step(ids, labels)), "iteration": restored_at}
    return out


def pipeline_general_program(rank, world, rn, rx, ry, lstm, lx, ly, lmask, gr, gx, gy, sk, sx,
                             sy, ckpt):
    """``PipelinedNetwork`` and ``PipelinedGraph`` on one rank of 4 (see
    test_torch_pipeline_general.py): one SGD step (learning rate LR) of the
    reduced ResNet50 MLN and graph and of the long-skip graph on stage=4 in
    float64, and of the masked LSTM stack on data=2 x stage=2, each in both
    schedules, with the whole parameters after it; and the sharded
    checkpoint round trip."""
    torch.set_num_threads(RANK_THREADS)
    from deeplearning4j_tpu_torch.models.resnet import resnet50, resnet50_mln
    from deeplearning4j_tpu_torch.nn.graph import ElementWiseVertex
    from deeplearning4j_tpu_torch.parallel import PipelinedGraph, PipelinedNetwork
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC

    L, U, I, NNC, GB = _modules()
    sgd = U.Sgd(learning_rate=LR)
    meshes = _meshes("stage4", "data2_stage2")
    out = {"mln": {}, "lstm": {}, "graph": {}, "skip": {}}
    conf = resnet_mln_conf(resnet50_mln)
    for sched in ("gpipe", "1f1b"):
        pn = PipelinedNetwork(conf, meshes["stage4"], n_microbatches=2, schedule=sched,
                              updater=sgd, device="cpu")
        pn.init(from_params=rn[0], from_state=rn[1], dtype=torch.float64)
        loss = float(pn.step(rx, ry))
        out["mln"][sched] = {"loss": loss, "params": _np(pn.unpack()),
                             "state": _np(pn.unpack_state()), "groups": pn.groups,
                             "stash": pn.last_peak_stash}

    conf = lstm_conf(L, I, NNC)
    for sched in ("gpipe", "1f1b"):
        pn = PipelinedNetwork(conf, meshes["data2_stage2"], n_microbatches=2,
                              stage_layers=[[0], [1, 2]], schedule=sched, updater=sgd,
                              device="cpu")
        pn.init(from_params=lstm)
        out["lstm"][sched] = {"loss": float(pn.loss(lx, ly, lmask)),
                              "unmasked": float(pn.loss(lx, ly)),
                              "step": float(pn.step(lx, ly, mask=lmask)),
                              "params": _np(pn.unpack())}

    conf = resnet_graph_conf(resnet50)
    for sched in ("gpipe", "1f1b"):
        pg = PipelinedGraph(conf, meshes["stage4"], n_microbatches=2, schedule=sched,
                            updater=sgd, device="cpu")
        pg.init(from_params=gr[0], from_state=gr[1], dtype=torch.float64)
        loss = float(pg.step(gx, gy))
        out["graph"][sched] = {"loss": loss, "state": _np(pg.unpack_state()),
                               "params": _np(pg.unpack()), "groups": pg.groups}

    conf = skip_graph_conf(L, I, GB, ElementWiseVertex)
    for sched in ("gpipe", "1f1b"):
        pg = PipelinedGraph(conf, meshes["stage4"], n_microbatches=2, schedule=sched,
                            stage_vertices=SKIP_STAGES, updater=sgd, device="cpu")
        pg.init(from_params=sk, dtype=torch.float64)
        out["skip"][sched] = {"loss": float(pg.step(sx, sy)), "params": _np(pg.unpack()),
                              "boundaries": [list(b) for b in pg._boundaries]}

    # the sharded checkpoint round trip (BN state, updater state, iteration)
    conf = resnet_mln_conf(resnet50_mln)
    pn = PipelinedNetwork(conf, meshes["stage4"], n_microbatches=2, device="cpu").init(
        from_params=rn[0], from_state=rn[1])
    rx32, ry32 = rx.astype(np.float32), ry.astype(np.float32)
    for _ in range(2):
        pn.step(rx32, ry32)
    SC.save_trainer(ckpt, pn)
    saved_state = _np(pn.unpack_state())
    l_next = float(pn.step(rx32, ry32))
    pn2 = PipelinedNetwork(conf, meshes["stage4"], n_microbatches=2, device="cpu").init()
    SC.restore_trainer(ckpt, pn2)
    out["ckpt"] = {"iteration": pn2.iteration, "state": _np(pn2.unpack_state()),
                   "saved_state": saved_state, "l_next": l_next,
                   "l_resume": float(pn2.step(rx32, ry32))}
    return out
