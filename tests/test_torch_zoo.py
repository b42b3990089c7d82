"""The port's zoo against the JAX package: the registry, every builder's
configuration JSON, full-width parameter counts, one float64 training step
of each model family at a tiny size, pretrained loading and checkpoints
with layer state.

The float64 steps start both packages from the JAX package's weights
(``params_from_numpy``) and hold loss, gradients, the new state (BN
running statistics, center-loss centers) and the parameters after one
updater step to rtol 1e-9, with three allowances:
- the conv biases in front of a BatchNormalization have a gradient that is
  zero in exact arithmetic, and each package leaves ~1e-17 of rounding
  there; an element whose gradient cancels (Darknet19's first conv, values
  ~40) keeps ~1e-11: so gradients and state take atol 1e-12 plus 1e-12 of
  the tensor's largest magnitude;
- the parameters after the step come from the updater applied to the JAX
  package's gradients (atol 1e-12), since RmsProp's step
  -lr·g/(sqrt(0.05)·|g| + 1e-8) has a slope up to lr/1e-8 = 6e6 in g,
  which would turn the first allowance into ~1e-9 in a parameter; ``fit``
  is then held to the port's own step to the bit;
- the port computes an updater's scalar factors in float32, as the JAX
  package does on its accelerator, so the step uses a learning rate exact
  in float32 where the model's own (RmsProp 0.1) is not.
Dropout is set to 0 (GoogLeNet's fc1, SimpleCNN's DropoutLayers), so
``fit`` draws nothing; ``resnet50_mln`` is cut to two stages with its
builder's ``stages`` (the full stack at 32 px normalizes four values a
channel in its last stage, where float64 rounding grows to ~1e-7).
"""

import dataclasses
import hashlib
import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import models as JM
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import models as TM
from deeplearning4j_tpu_torch.datasets import cacheable
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import tree_like

STEP_RTOL, GRAD_ATOL, GRAD_ATOL_REL, PARAM_ATOL = 1e-9, 1e-12, 1e-12, 1e-12


def _flat(tree, prefix=""):
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


def _assert_trees(got, want, rtol=0.0, atol=0.0, atol_rel=0.0):
    """Every leaf within rtol·|want| + atol + atol_rel·max|leaf of want|."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        scale = float(np.abs(w[k]).max()) if w[k].size else 0.0
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol + atol_rel * scale,
                                   err_msg=k)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_model_names_are_the_jax_registry_less_tinyyolo():
    """The port's names are the JAX registry's, tinyyolo included now that
    ``nn/layers/objdetect.py`` is ported (the name is kept from when it
    was left out)."""
    assert TM.model_names() == JM.model_names()
    assert TM.get_model("tinyyolo").builder is TM.tiny_yolo and not TM.get_model("tinyyolo").graph
    with pytest.raises(KeyError, match="nomodel"):
        TM.get_model("nomodel")


_KWARGS = {"textgenlstm": {"vocab_size": 11, "hidden": 8, "seq_len": 4}}


@pytest.mark.parametrize("name", jzoo.model_names())
def test_registry_builders_make_the_jax_configs(name):
    jm, tm = JM.get_model(name), TM.get_model(name)
    assert isinstance(tm, TM.ZooModel) and tm.graph == jm.graph and tm.name == name
    assert tm.builder(**_KWARGS.get(name, {})).to_json() == \
        jm.builder(**_KWARGS.get(name, {})).to_json()
    assert not tm.pretrained_available()


def test_build_gives_an_initialised_network_on_the_device():
    net = TM.get_model("lenet").build(device="cpu", height=12, width=12, padding="same")
    assert isinstance(net, TNet) and net.params is not None
    assert net.device == torch.device("cpu")
    graph = TM.get_model("resnet50").build(device="cpu", height=32, width=32, n_classes=3)
    assert isinstance(graph, TGraph) and graph.output(np.zeros((1, 32, 32, 3),
                                                               np.float32)).shape == (1, 3)


@pytest.mark.parametrize("name,builder,want", [
    ("inceptionresnetv1", "inception_resnet_v1", 16_863_161),
    ("googlenet", "googlenet", 8_048_152),
    ("facenetnn4small2", "facenet_nn4_small2", 4_475_589),
    ("vgg16", "vgg16", 138_357_544),
    ("alexnet", "alexnet", 50_844_008),
    ("darknet19", "darknet19", 20_842_376),
    ("resnet50_mln", "resnet50_mln", 25_557_032),
])
def test_full_width_parameter_counts_match_jax(name, builder, want):
    jconf = getattr(JM, builder)()
    jnet = (JGraph if hasattr(jconf, "vertices") else JNet)(jconf)
    shapes = jax.eval_shape(jnet.init)[0]
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes)) == want
    conf = getattr(TM, builder)()
    net = (TGraph if hasattr(conf, "vertices") else TNet)(conf, device="cpu")
    net.init()
    assert net.num_params() == want


def test_inception_resnet_v1_vertex_census():
    conf = TM.inception_resnet_v1()
    kinds = [type(v.vertex).__name__ for v in conf.vertices]
    assert len(kinds) == len(JM.inception_resnet_v1().vertices) == 323
    assert (kinds.count("MergeVertex"), kinds.count("ScaleVertex"),
            kinds.count("ElementWiseVertex"), kinds.count("L2NormalizeVertex")) == (22, 20, 20, 1)


# ---------------------------------------------------------------------------
# one float64 step of each family against the JAX package
# ---------------------------------------------------------------------------

STEP_CASES = {
    # name: (builder kwargs, batch)
    "inception_resnet_v1": (dict(height=96, width=96, n_classes=5, blocks_a=1, blocks_b=1,
                                 blocks_c=1), 4),
    "googlenet": (dict(height=64, width=64, n_classes=7), 4),
    "facenet_nn4_small2": (dict(height=32, width=32, n_classes=4), 4),
    "simple_cnn": (dict(height=16, width=16, n_classes=3), 4),
    "darknet19": (dict(height=32, width=32, n_classes=5), 4),
    "resnet50_mln": (dict(height=32, width=32, n_classes=5,
                          stages=[(16, 2, (1, 1)), (32, 2, (2, 2))], stem_filters=16), 4),
}
# learning rates exact in float32 (module docstring)
UPDATERS = {"inception_resnet_v1": 0.0625}


def _confs(name):
    kwargs, _ = STEP_CASES[name]
    confs = []
    for mod, upd in ((JM, JU), (TM, TU)):
        extra = {"updater": upd.RmsProp(learning_rate=UPDATERS[name])} if name in UPDATERS \
            else {}
        confs.append(_without_dropout(getattr(mod, name)(**kwargs, **extra)))
    return confs


def _without_dropout(conf):
    """``conf`` with every layer's input dropout and DropoutLayer rate at 0."""
    def off(layer):
        layer = dataclasses.replace(layer, dropout=0.0)
        return dataclasses.replace(layer, rate=0.0) if hasattr(layer, "rate") else layer

    if hasattr(conf, "vertices"):
        return dataclasses.replace(conf, vertices=tuple(
            dataclasses.replace(v, vertex=dataclasses.replace(v.vertex, layer=off(v.vertex.layer)))
            if hasattr(v.vertex, "layer") else v for v in conf.vertices))
    return dataclasses.replace(conf, layers=tuple(off(layer) for layer in conf.layers))


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_one_float64_step_matches_jax(name):
    jconf, tconf = _confs(name)
    assert tconf.to_json() == jconf.to_json()
    graph = hasattr(jconf, "vertices")
    jnet = (JGraph if graph else JNet)(jconf)
    jnet.init()
    p64, s64 = _f64(jnet.params), _f64(jnet.state)
    _, batch = STEP_CASES[name]
    it = jconf.input_types[0] if graph else jconf.input_type
    n_classes = (jnet._types[jconf.outputs[0]] if graph else jconf.layer_input_types()[1]).size
    rs = np.random.RandomState(0)
    x = rs.rand(batch, it.height, it.width, it.channels)
    y = np.eye(n_classes)[rs.randint(0, n_classes, batch)]
    if graph:
        jx, jy = {"input": jnp.asarray(x)}, {jconf.outputs[0]: jnp.asarray(y)}
    else:
        jx, jy = jnp.asarray(x), jnp.asarray(y)
    loss, state, grads = jax.jit(jnet.compute_gradients)(p64, s64, jx, jy)
    params1, _ = jax.jit(lambda p, g: jnet.apply_update(p, jnet.conf.updater.init(p), g, 0))(
        p64, grads)

    tnet = (TGraph if graph else TNet)(tconf, device="cpu")
    tnet.init(dtype=torch.float64)
    as_np = jax.tree_util.tree_map(np.asarray, (p64, s64))
    tser.params_from_numpy(tnet, as_np[0], state=as_np[1])
    tl, ts, tg = tnet.compute_gradients(tnet.params, tnet.state, torch.from_numpy(x),
                                        torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(loss), rtol=STEP_RTOL)
    _assert_trees(tg, grads, rtol=STEP_RTOL, atol=GRAD_ATOL, atol_rel=GRAD_ATOL_REL)
    _assert_trees(ts, state, rtol=STEP_RTOL, atol=GRAD_ATOL, atol_rel=GRAD_ATOL_REL)
    if name in ("inception_resnet_v1", "facenet_nn4_small2"):
        assert np.abs(ts["lossLayer"]["centers"].numpy()).max() > 0
    # the updater from the JAX package's gradients: the update math alone
    step = tnet.conf.updater.init(tnet.params)
    before = [p.detach().clone() for p in tnet.parameters()]
    tnet.apply_update(tnet.params, step, _like(tnet.params, grads), 0)
    _assert_trees(tnet.params, params1, rtol=STEP_RTOL, atol=PARAM_ATOL)
    # and ``fit`` takes exactly the port's own step from the same weights
    with torch.no_grad():
        for p, b in zip(tnet.parameters(), before):
            p.copy_(b)
    tnet.apply_update(tnet.params, tnet.conf.updater.init(tnet.params), tg, 0)
    fitted = (TGraph if graph else TNet)(tconf, device="cpu")
    fitted.init(dtype=torch.float64)
    tser.params_from_numpy(fitted, as_np[0], state=as_np[1])
    fitted.fit(x, y)
    assert fitted.iteration == 1 and fitted.score_value == float(tl)
    _assert_trees(fitted.params, tnet.params, rtol=0, atol=0)
    _assert_trees(fitted.state, ts, rtol=0, atol=0)


def _like(params, tree):
    """The JAX tree ``tree`` as float64 tensors shaped as the port's ``params``."""
    flat = _flat(tree)
    mine = _flat(params)
    assert set(flat) == set(mine)
    return tree_like(params, iter(torch.from_numpy(flat[k].copy()) for k in mine))


def test_googlenet_fc1_dropout_is_live_in_fit_and_off_in_output():
    conf = TM.googlenet(height=32, width=32, n_classes=3)
    assert conf.vertices[[v.name for v in conf.vertices].index("fc1")].vertex.layer.dropout == 0.4
    x = np.random.RandomState(0).rand(4, 32, 32, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    nets = []
    for c in (conf, _without_dropout(conf)):
        net = TGraph(c, device="cpu")
        net.init(torch.Generator().manual_seed(0))
        net.fit(x, y)
        nets.append(net)
    assert not torch.equal(nets[0].params["output"]["W"], nets[1].params["output"]["W"])
    a, b = nets[0].output(x), nets[0].output(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(a.sum(1).numpy(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# pretrained weights and checkpoints
# ---------------------------------------------------------------------------

def _md5(path):
    return hashlib.md5(open(path, "rb").read()).hexdigest()


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    (tmp_path / "zoo").mkdir()
    return tmp_path


def test_init_pretrained_restores_a_jax_zip_after_its_md5(data_dir):
    jnet = JNet(JM.simple_cnn(height=16, width=16, n_classes=3))
    jnet.init()
    x = np.random.RandomState(0).rand(4, 16, 16, 3).astype(np.float32)
    jnet.fit(x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])  # BN state away from its init
    path = data_dir / "zoo" / "simplecnn_cifar10.zip"
    jser.save_model(jnet, str(path))
    url = "https://example.invalid/simplecnn.zip"
    model = tzoo.ZooModel("simplecnn", TM.simple_cnn,
                          pretrained={TM.PretrainedType.CIFAR10: (url, _md5(path))}, graph=False)
    assert model.pretrained_available(TM.PretrainedType.CIFAR10)
    assert not model.pretrained_available()
    net = model.init_pretrained(TM.PretrainedType.CIFAR10, device="cpu")
    assert os.path.exists(str(path) + ".md5ok")
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)), atol=1e-5)
    # the marker spares the second read its hash; the JAX package reads it too
    again = model.init_pretrained(TM.PretrainedType.CIFAR10, device="cpu")
    np.testing.assert_array_equal(again.output(x).numpy(), net.output(x).numpy())
    with pytest.raises(ValueError, match="no pretrained weights"):
        model.init_pretrained(TM.PretrainedType.IMAGENET, device="cpu")


def test_md5_mismatch_deletes_the_file_and_raises(data_dir):
    path = data_dir / "zoo" / "lenet_mnist.zip"
    path.write_bytes(b"not the model")
    model = tzoo.ZooModel("lenet", TM.lenet, graph=False,
                          pretrained={TM.PretrainedType.MNIST: (None, "0" * 32)})
    with pytest.raises(cacheable.ChecksumError, match="deleted"):
        model.init_pretrained(TM.PretrainedType.MNIST, device="cpu")
    assert not path.exists()


def test_a_missing_file_raises_and_nothing_downloads(data_dir, monkeypatch):
    import urllib.request

    def refuse(*a, **k):
        raise AssertionError("the port must not download")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("DL4J_TPU_ALLOW_DOWNLOAD", "1")
    model = tzoo.ZooModel("vgg16", TM.vgg16, graph=False,
                          pretrained={TM.PretrainedType.IMAGENET: ("https://example.invalid/v.zip",
                                                                   "0" * 32)})
    want = str(data_dir / "zoo" / "vgg16_imagenet.zip")
    with pytest.raises(FileNotFoundError, match="place the file at " + want):
        model.init_pretrained(device="cpu")


def test_dl4j_and_keras_files_raise_naming_the_roadmap(tmp_path):
    """Since ``modelimport/`` is ported (ROADMAP queue 1, item 4), the two
    formats reach their importers: a DL4J zip whose configuration is
    neither a network nor a graph raises the DL4J reader's error, a file
    with the HDF5 signature that libhdf5 cannot open raises the bridge's,
    in both packages alike; neither raises NotImplementedError."""
    from deeplearning4j_tpu.modelimport.dl4j import Dl4jImportError as JDl4jImportError
    from deeplearning4j_tpu_torch.modelimport.dl4j import Dl4jImportError

    dl4j = tmp_path / "dl4j.zip"
    with zipfile.ZipFile(dl4j, "w") as z:
        z.writestr("configuration.json", "{}")
        z.writestr("coefficients.bin", b"\0" * 8)
    keras = tmp_path / "model.h5"
    keras.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    for path, mine, theirs in ((dl4j, Dl4jImportError, JDl4jImportError),
                               (keras, IOError, IOError)):
        with pytest.raises(mine) as got:
            TM.restore_checkpoint(str(path), device="cpu")
        assert not isinstance(got.value, NotImplementedError)
        with pytest.raises(theirs):
            jzoo.restore_checkpoint(str(path))


def _facenet_pair():
    kw = dict(height=32, width=32, n_classes=4)
    return JM.facenet_nn4_small2(**kw), TM.facenet_nn4_small2(**kw)


def test_center_loss_and_mln_bn_checkpoints_round_trip_both_ways(tmp_path):
    rs = np.random.RandomState(0)
    xg = rs.rand(4, 32, 32, 3).astype(np.float32)
    yg = np.eye(4, dtype=np.float32)
    xm = rs.rand(4, 16, 16, 3).astype(np.float32)
    ym = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    jconf, tconf = _facenet_pair()
    for jmake, tmake, x, y in ((lambda: JGraph(jconf), lambda: TGraph(tconf, device="cpu"),
                                xg, yg),
                               (lambda: JNet(JM.simple_cnn(height=16, width=16, n_classes=3)),
                                lambda: TNet(TM.simple_cnn(height=16, width=16, n_classes=3),
                                             device="cpu"), xm, ym)):
        # the port trains a step, saves; the JAX package loads it
        tnet = tmake()
        tnet.init(torch.Generator().manual_seed(1))
        tnet.fit(x, y)
        path = tmp_path / "port.zip"
        tser.save_model(tnet, path)
        arrays = dict(np.load(io.BytesIO(zipfile.ZipFile(path).read("arrays.npz"))))
        assert ("state['lossLayer']['centers']" if isinstance(tnet, TGraph)
                else "state[1]['mean']") in arrays
        jnet = jser.load_model(str(path))
        _assert_trees(jnet.params, tnet.params, rtol=0, atol=0)
        _assert_trees(jnet.state, tnet.state, rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(jnet.output(x)), tnet.output(x).numpy(),
                                   atol=1e-5)
        # the JAX package trains on, saves; the port loads it
        jnet.fit(x, y)
        jpath = tmp_path / "jax.zip"
        jser.save_model(jnet, str(jpath))
        back = tser.load_model(jpath, device="cpu")
        assert back.iteration == 2
        _assert_trees(back.params, jnet.params, rtol=0, atol=0)
        _assert_trees(back.state, jnet.state, rtol=0, atol=0)
        np.testing.assert_allclose(back.output(x).numpy(), np.asarray(jnet.output(x)),
                                   atol=1e-5)
