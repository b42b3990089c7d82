"""The port's ComputationGraph and ResNet50 against the JAX package.

Graph configuration JSON in both directions, and the whole slice: ResNet50
at 64x64 with 10 classes, fused and unfused, batch 2, from one JAX zip (the
fused net's zip carries the same weights under its own vertex names).

At batch 2 a freshly initialised ResNet50 is badly conditioned: the last
stages normalise 8 to 32 values per channel, and f32 summation-order noise
grows through ~50 batch-normalised layers until single gradient elements
differ by tens of percent between any two correct f32 implementations (at
32x32 the last stage normalises two values per channel and even the f32
loss differs). So the slice is pinned two ways:

- in float64, where both packages compute the same function to ~1e-12:
  the port's fused and unfused nets against the JAX package's unfused net
  (the reference math the fused vertex must reproduce): loss rtol 1e-10,
  gradients and BN state after the step rtol 1e-7 + atol 1e-10, Adam's
  update math from the same gradients rtol 1e-6 (the port computes Adam's
  scalar factors in f32, the JAX package under x64 in f64), three ``fit``
  steps: parameters atol 1e-6 (an element whose gradient is ~0 moves by
  Adam's ~lr-sized step in a direction set by its rounding), BN state rtol
  1e-6;
- in float32, where the JAX fused net runs its Pallas kernels in interpret
  mode (its ``DL4J_TPU_FUSED_CONV_INTERPRET`` seam) and the port runs the
  kernels' plain versions: measured against the float64 result, the port's
  f32 loss error must be within 2x the JAX package's own f32 error, the
  error norm over all gradients within 1.5x, and each gradient tensor's
  error norm within 4x (plus 1e-6 of the tensor's norm): one tensor's
  error is a sample of rounding noise, and over the 161 tensors the ratio
  spreads from 0.5 to 3, the widest on the 10-element fc bias.
"""

import contextlib
import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import resnet50 as j_resnet50
from deeplearning4j_tpu.nn import graph as JG
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.models import resnet50 as t_resnet50
from deeplearning4j_tpu_torch.nn import fusion as TF
from deeplearning4j_tpu_torch.nn import graph as TG
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.ops import conv_stats as C
from deeplearning4j_tpu_torch.utils import serialization as tser

HW, CLASSES, BATCH = 64, 10, 2


def _flat(tree, prefix=""):
    """{keystr path: float64 ndarray} for JAX pytrees and port trees alike."""
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}['{k}']"))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.detach().double().numpy()}
    return {prefix: np.asarray(tree, np.float64)}


def _assert_trees(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


@contextlib.contextmanager
def _pallas_interpret(on):
    """The JAX fused vertex's test seam: its Pallas kernels in interpret
    mode on the CPU."""
    old = os.environ.get("DL4J_TPU_FUSED_CONV_INTERPRET")
    os.environ["DL4J_TPU_FUSED_CONV_INTERPRET"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DL4J_TPU_FUSED_CONV_INTERPRET"]
        else:
            os.environ["DL4J_TPU_FUSED_CONV_INTERPRET"] = old


def _data(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, HW, HW, 3).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rs.randint(0, CLASSES, n)]
    return x, y


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_config_json_round_trips_both_ways(fused):
    j_json = j_resnet50(HW, HW, n_classes=CLASSES, fused=fused).to_json()
    t_conf = t_resnet50(HW, HW, n_classes=CLASSES, fused=fused)
    assert t_conf.to_json() == j_json
    assert TG.GraphConfiguration.from_json(j_json).to_json() == j_json
    assert JG.GraphConfiguration.from_json(t_conf.to_json()).to_json() == j_json
    j_conf = JG.GraphConfiguration.from_json(j_json)
    assert t_conf.topological_order() == j_conf.topological_order()
    assert {k: v.shape(1) for k, v in t_conf.vertex_types().items()} == \
        {k: v.shape(1) for k, v in j_conf.vertex_types().items()}


def test_unported_vertices_parse_round_trip_and_refuse_to_build():
    """The graph that once refused to build (Scale, Subset and Preprocessor
    were not ported) round-trips its JSON and computes the JAX package's
    output and loss from the same weights."""
    conf = (JG.GraphBuilder().add_inputs("a", "b")
            .set_input_types(JI.FeedForwardType(3), JI.FeedForwardType(3))
            .add_vertex("sum", JG.ElementWiseVertex(op="average"), "a", "b")
            .add_vertex("scale", JG.ScaleVertex(factor=2.0), "sum")
            .add_vertex("sub", JG.SubsetVertex(from_idx=0, to_idx=1), "scale")
            .add_vertex("pre", JG.PreprocessorVertex(kind="ff_to_rnn", timesteps=1), "sub")
            .add_layer("out", JL.OutputLayer(n_out=2), "pre").set_outputs("out").build())
    t_conf = TG.GraphConfiguration.from_json(conf.to_json())
    assert t_conf.to_json() == conf.to_json()
    jnet = JG.ComputationGraph(conf)
    jnet.init()
    tnet = TG.ComputationGraph(t_conf, device="cpu")
    tser.params_from_numpy(tnet, jnet.params, state=jnet.state)
    rs = np.random.RandomState(0)
    x = {"a": rs.randn(4, 3).astype(np.float32), "b": rs.randn(4, 3).astype(np.float32)}
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 4)]
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)), atol=1e-6)
    np.testing.assert_allclose(tnet.score(x, y), jnet.score(x, y), rtol=1e-6)


def test_elementwise_vertex_matches_jax():
    rs = np.random.RandomState(0)
    xs = [rs.randn(2, 3).astype(np.float32) for _ in range(3)]
    for op in ("add", "product", "average", "max", "subtract"):
        args = xs[:2] if op == "subtract" else xs
        y_j, _ = JG.ElementWiseVertex(op=op).apply({}, {}, [jnp.asarray(a) for a in args])
        y_t, _ = TG.ElementWiseVertex(op=op).apply({}, {}, [torch.from_numpy(a) for a in args])
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, err_msg=op)


def test_full_width_resnet50_has_the_reference_parameter_count():
    conf = t_resnet50(fused=True)
    net = TG.ComputationGraph(conf, device="cpu")
    net.init()
    jnet = JG.ComputationGraph(j_resnet50(fused=True))
    shapes = jax.eval_shape(jnet.init)[0]
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert net.num_params() == want == 25_557_032
    kernels = [v.vertex.kernel for v in conf.vertices if hasattr(v.vertex, "kernel")
               and not hasattr(v.vertex, "layer")]
    assert (kernels.count((1, 1)), kernels.count((3, 3))) == (36, 16)


def test_training_what_is_not_ported_raises():
    """``checkpoint_scope="prefix"`` trains now: from the same weights the
    remat step equals the plain one in float64 (loss, gradients, BN state),
    and every fused vertex, all inside a block group, runs its conv twice
    (forward and recompute). ``steps_per_dispatch=4`` trains the same
    graph: one dispatch of one real step (and three padded ones) equals the
    K=1 step on the batch padded the same way, in float64."""
    x, y = (torch.from_numpy(a).double() for a in _data(2, 0))
    nets, calls = [], []
    for scope in (None, "prefix"):
        net = TG.ComputationGraph(t_resnet50(HW, HW, n_classes=CLASSES, fused=True,
                                             checkpoint_scope=scope), device="cpu")
        net.init(torch.Generator().manual_seed(0), dtype=torch.float64)
        counted = []
        conv_z = C.conv_z
        C.conv_z = lambda *a, **k: counted.append(1) or conv_z(*a, **k)
        try:
            nets.append(net.compute_gradients(net.params, net.state, {"input": x}, {"fc": y}))
        finally:
            C.conv_z = conv_z
        calls.append(len(counted))
    (l0, s0, g0), (l1, s1, g1) = nets
    assert float(l1) == float(l0)
    _assert_trees(g1, g0, rtol=1e-12, atol=1e-15)
    _assert_trees(s1, s0, rtol=0, atol=0)
    assert calls == [52, 104]
    fits = []
    for k in (1, 4):
        net = TG.ComputationGraph(t_resnet50(HW, HW, n_classes=CLASSES), device="cpu")
        net.init(torch.Generator().manual_seed(0), dtype=torch.float64)
        xf, yf = (a.astype(np.float64) for a in _data(2, 0))
        net.fit(xf, yf, steps_per_dispatch=k, pad_ragged=True)
        fits.append(net)
    assert fits[1].iteration == 1 and fits[1]._train_steps_fused[(4, False)].calls == 1
    np.testing.assert_allclose(fits[1].score_value, fits[0].score_value, rtol=1e-12)
    _assert_trees(fits[1].params, fits[0].params, rtol=1e-12, atol=1e-15)


def test_graph_fits_dict_inputs_with_two_heads():
    """A two-input, two-output graph: losses sum over the heads, gradients
    reach both branches, the loss falls."""
    conf = (TG.GraphBuilder().add_inputs("a", "b")
            .set_input_types(TI.FeedForwardType(4), TI.FeedForwardType(4))
            .add_layer("da", TL.DenseLayer(n_out=5, activation="tanh"), "a")
            .add_layer("db", TL.DenseLayer(n_out=5, activation="tanh"), "b")
            .add_vertex("add", TG.ElementWiseVertex(op="add"), "da", "db")
            .add_layer("o1", TL.OutputLayer(n_out=3), "add")
            .add_layer("o2", TL.OutputLayer(n_out=2, loss="mse", activation="identity"), "add")
            .set_outputs("o1", "o2").build())
    net = TG.ComputationGraph(conf, device="cpu")
    net.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    x = {"a": rs.randn(8, 4).astype(np.float32), "b": rs.randn(8, 4).astype(np.float32)}
    y = {"o1": np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)],
         "o2": rs.randn(8, 2).astype(np.float32)}
    before = net.score(x, y)
    net.fit(x, y, batch_size=4, epochs=5)
    assert net.iteration == 10 and len(net.score_history) == 10
    assert net.score(x, y) < before
    outs = net.output(x)
    assert set(outs) == {"o1", "o2"} and outs["o1"].shape == (8, 3)


# ---------------------------------------------------------------------------
# the whole slice from one JAX zip
# ---------------------------------------------------------------------------

def _base(name):
    """The unfused chain's name prefix of a fused vertex: s0b0_a_bn -> s0b0_a,
    s0b0_relu (the fused c conv) -> s0b0_c."""
    return name[:-len("_relu")] + "_c" if name.endswith("_relu") else name[:-len("_bn")]


def _to_unfused(tree, fused_names):
    """A fused graph's {vertex: {key: array}} under the unfused graph's
    vertex names (W to the conv vertex, the rest to the BN vertex)."""
    out = {}
    for name, d in tree.items():
        if name not in fused_names:
            out[name] = dict(d)
            continue
        out[f"{_base(name)}_conv"] = {k: v for k, v in d.items() if k == "W"}
        out[f"{_base(name)}_bn"] = {k: v for k, v in d.items() if k != "W"}
    return out


def _to_fused(tree, names, fused_names):
    """An unfused graph's tree under the fused graph's vertex ``names``."""
    def get(name):
        return dict(tree.get(name, {}))
    return {name: ({**get(f"{_base(name)}_conv"), **get(f"{_base(name)}_bn")}
                   if name in fused_names else get(name)) for name in names}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One JAX-initialised unfused ResNet50, its zip, and its float64
    results: one compute_gradients and Adam step, then (from the same
    start) three fit steps."""
    jnet = JG.ComputationGraph(j_resnet50(HW, HW, n_classes=CLASSES))
    jnet.init()
    path = tmp_path_factory.mktemp("resnet") / "unfused.zip"
    jser.save_model(jnet, str(path))
    fused_conf = j_resnet50(HW, HW, n_classes=CLASSES, fused=True)
    names = {v.name for v in fused_conf.vertices if not hasattr(v.vertex, "layer")}
    p32, s32 = jnet.params, jnet.state
    p64, s64 = _f64(p32), _f64(s32)
    x, y = _data(BATCH, 1)
    loss, state, grads = jax.jit(lambda p, s, x_, y_: jnet.compute_gradients(p, s, x_, y_))(
        p64, s64, {"input": jnp.asarray(x, jnp.float64)}, {"fc": jnp.asarray(y, jnp.float64)})
    params1, _ = jax.jit(lambda p, g: jnet.apply_update(p, jnet.conf.updater.init(p), g, 0))(
        p64, grads)
    xf, yf = _data(3 * BATCH, 2)
    jnet.params, jnet.state, jnet.opt_state = p64, s64, jnet.conf.updater.init(p64)
    with _pallas_interpret(False):
        jnet.fit({"input": xf.astype(np.float64)}, {"fc": yf.astype(np.float64)},
                 batch_size=BATCH)
    return {"zip": path, "fused_conf": fused_conf, "names": names, "params": p32,
            "state": s32, "x": x, "y": y, "loss": float(loss), "step_state": state,
            "grads": grads, "params1": params1, "fit_params": jnet.params,
            "fit_state": jnet.state, "fit_score": float(jnet.score_value), "xf": xf, "yf": yf}


def _port(ref, fused, dtype=torch.float32):
    """The port's net from the reference zip: as it is, or (fused) with its
    arrays under the fused graph's vertex names, in ``dtype``."""
    if not fused and dtype == torch.float32:
        return tser.load_model(ref["zip"], device="cpu")
    arrays = dict(np.load(io.BytesIO(zipfile.ZipFile(ref["zip"]).read("arrays.npz"))))
    net = TG.ComputationGraph(t_resnet50(HW, HW, n_classes=CLASSES, fused=fused), device="cpu")
    net.init(dtype=dtype)
    names = ref["names"] if fused else set()
    trees = {}
    for prefix in ("params", "state"):
        tree = {}
        for key, a in arrays.items():
            if key.startswith(prefix + "["):
                vertex, leaf = key[len(prefix) + 2:-2].split("']['")
                tree.setdefault(vertex, {})[leaf] = a
        trees[prefix] = (_to_fused(tree, net.params, names) if fused else
                         {k: tree.get(k, {}) for k in net.params})
    return tser.params_from_numpy(net, trees["params"], state=trees["state"])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_step_matches_jax_in_float64(reference, fused):
    truth = reference
    tnet = _port(reference, fused, torch.float64)
    names = reference["names"] if fused else set()
    x, y = torch.from_numpy(truth["x"]).double(), torch.from_numpy(truth["y"]).double()
    loss, state, grads = tnet.compute_gradients(tnet.params, tnet.state, {"input": x}, {"fc": y})
    np.testing.assert_allclose(float(loss), truth["loss"], rtol=1e-10)
    _assert_trees(_to_unfused(grads, names), truth["grads"], rtol=1e-7, atol=1e-10)
    _assert_trees(_to_unfused(state, names), truth["step_state"], rtol=1e-7, atol=1e-10)
    # one Adam step from the reference's gradients: the update math alone
    g = _to_fused({k: {n: torch.from_numpy(np.array(a)) for n, a in d.items()}
                   for k, d in truth["grads"].items()}, tnet.params, names)
    tnet.apply_update(tnet.params, tnet.conf.updater.init(tnet.params), g, 0)
    _assert_trees(_to_unfused(tnet.params, names), truth["params1"], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_three_fit_steps_match_jax_in_float64(reference, fused):
    truth = reference
    tnet = _port(reference, fused, torch.float64)
    names = reference["names"] if fused else set()
    tnet.fit({"input": truth["xf"].astype(np.float64)}, {"fc": truth["yf"].astype(np.float64)},
             batch_size=BATCH)
    assert tnet.iteration == 3 and tnet.epoch == 1 and len(tnet.score_history) == 3
    np.testing.assert_allclose(tnet.score_value, truth["fit_score"], rtol=1e-6)
    _assert_trees(_to_unfused(tnet.params, names), truth["fit_params"], rtol=1e-6, atol=1e-6)
    _assert_trees(_to_unfused(tnet.state, names), truth["fit_state"], rtol=1e-6, atol=1e-9)
    if fused:
        assert C.launches == {"conv_mm_stats": 0, "conv3x3_stats": 0}  # the CPU runs no kernel


def _norm_err(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_float32_step_is_as_accurate_as_the_reference(reference, fused):
    truth = reference
    names = reference["names"] if fused else set()
    jnet = JG.ComputationGraph(reference["fused_conf"] if fused else
                               j_resnet50(HW, HW, n_classes=CLASSES))
    order = [v.name for v in jnet.conf.vertices]
    jnet.params = _to_fused(reference["params"], order, names)
    jnet.state = _to_fused(reference["state"], order, names)
    tnet = _port(reference, fused)
    x, y = truth["x"], truth["y"]
    with _pallas_interpret(fused):
        loss_j, _, grads_j = jax.jit(lambda p, s, x_, y_: jnet.compute_gradients(p, s, x_, y_))(
            jnet.params, jnet.state, {"input": jnp.asarray(x)}, {"fc": jnp.asarray(y)})
    loss_t, _, grads_t = tnet.compute_gradients(tnet.params, tnet.state,
                                                {"input": torch.from_numpy(x)},
                                                {"fc": torch.from_numpy(y)})
    assert abs(float(loss_t) - truth["loss"]) <= 2 * abs(float(loss_j) - truth["loss"]) + 1e-6
    want = _flat(truth["grads"])
    got_t, got_j = _flat(_to_unfused(grads_t, names)), _flat(_to_unfused(grads_j, names))
    assert set(got_t) == set(got_j) == set(want)
    def total(got):
        return sum(_norm_err(got[k], w) ** 2 for k, w in want.items()) ** 0.5
    assert total(got_t) <= 1.5 * total(got_j)
    for k, w in want.items():
        floor = 1e-6 * float(np.linalg.norm(w))
        assert _norm_err(got_t[k], w) <= 4 * _norm_err(got_j[k], w) + floor, k


def test_graph_checkpoint_round_trips_with_bn_and_adam_state(tmp_path):
    """A small graph with a BatchNormalization layer and fused vertices,
    trained one step by the port, written, and read back by both packages."""
    g = (TG.GraphBuilder(updater=TU.Adam(learning_rate=1e-2)).add_inputs("input")
         .set_input_types(TI.ConvolutionalType(8, 8, 3))
         .add_layer("stem_conv", TL.ConvolutionLayer(n_out=8, kernel=(3, 3), padding="same",
                                                     has_bias=False), "input")
         .add_layer("stem_bn", TL.BatchNormalization(activation="relu"), "stem_conv")
         .add_vertex("a_bn", TF.FusedConvBNVertex(n_out=4, kernel=(1, 1)), "stem_bn")
         .add_vertex("b_bn", TF.FusedConvBNVertex(n_out=4, kernel=(3, 3), stride=(2, 2)), "a_bn")
         .add_layer("avgpool", TL.GlobalPoolingLayer(mode="avg"), "b_bn")
         .add_layer("fc", TL.OutputLayer(n_out=3), "avgpool").set_outputs("fc").build())
    tnet = TG.ComputationGraph(g, device="cpu")
    tnet.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(3)
    x = rs.rand(4, 8, 8, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
    tnet.fit(x, y)
    back = tmp_path / "back.zip"
    tser.save_model(tnet, back)
    arrays = dict(np.load(io.BytesIO(zipfile.ZipFile(back).read("arrays.npz"))))
    assert "state['stem_bn']['var']" in arrays and "state['b_bn']['mean']" in arrays
    assert "opt['m']['fc']['W']" in arrays
    jnet = jser.load_model(str(back))
    assert jnet.iteration == 1
    _assert_trees(jnet.params, tnet.params, rtol=0, atol=0)
    _assert_trees(jnet.state, tnet.state, rtol=0, atol=0)
    _assert_trees(jnet.opt_state, tnet.opt_state, rtol=0, atol=0)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)), atol=1e-6)
    again = tser.load_model(back, device="cpu")
    _assert_trees(again.opt_state, tnet.opt_state, rtol=0, atol=0)
    np.testing.assert_array_equal(again.output(x).numpy(), tnet.output(x).numpy())
