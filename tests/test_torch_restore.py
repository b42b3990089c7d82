"""``models.zoo.restore_checkpoint`` and the ``serve`` verb on every model
format, against the JAX package's: the format detection routes a DL4J
MultiLayerNetwork zip, a DL4J ComputationGraph zip, a Keras Sequential
file, a Keras functional file and the framework's own zips to the same
network kind as the JAX package's, passing ``input_type`` on to the DL4J
readers; ``serve`` loads through it and takes its warmup shape from
``--input-shape``, else from the model's input type, else exits naming
the flag (a DL4J GravesLSTM zip stores no sequence length)."""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

import torch_native_guard  # noqa: E402

# before any test runs: the JAX package's native library, built without the race
torch_native_guard.heal_reference_native()

from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.misc import text_generation_lstm as jcharnn
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JBuilder
from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.modelimport.dl4j import Dl4jImportError
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.graph import GraphConfiguration

ROOT = Path(__file__).resolve().parent.parent


def _charnn_zip(tmp_path):
    """A small char-RNN (2 GravesLSTM + RnnOutputLayer, vocab 11) as a DL4J
    zip written by the JAX package, Adam state included."""
    net = JNet(jcharnn(11, hidden=8, seq_len=8, updater=JU.Adam(1e-3)))
    net.init()
    rs = np.random.RandomState(0)
    eye = np.eye(11, dtype=np.float32)
    ids = rs.randint(0, 11, (4, 9))
    net.fit(eye[ids[:, :8]], eye[ids[:, 1:]])
    p = tmp_path / "charnn_dl4j.zip"
    jdl4j.write_multilayer_network(net, str(p), save_updater=True)
    return p, net


def _mlp_zip(tmp_path):
    net = JNet(JConf(layers=(JL.DenseLayer(n_out=6, activation="relu"),
                             JL.OutputLayer(n_out=3, activation="softmax")),
                     input_type=JI.feed_forward(5), updater=JU.Sgd(0.1)))
    net.init()
    p = tmp_path / "mlp_dl4j.zip"
    jdl4j.write_multilayer_network(net, str(p))
    return p


def _cnn_graph(n_inputs=1):
    g = JBuilder(updater=JU.Sgd(0.1), seed=4).add_inputs(*[f"in{i}" for i in range(n_inputs)])
    g.set_input_types(*[JI.convolutional(6, 6, 2)] * n_inputs)
    for i in range(n_inputs):
        g.add_layer(f"c{i}", JL.ConvolutionLayer(n_out=3, kernel=(3, 3), padding="same",
                                                 activation="relu"), f"in{i}")
    prev = "c0"
    if n_inputs > 1:
        g.add_vertex("m", JMerge(), *[f"c{i}" for i in range(n_inputs)])
        prev = "m"
    g.add_layer("pool", JL.GlobalPoolingLayer(mode="avg"), prev)
    g.add_layer("out", JL.OutputLayer(n_out=2, activation="softmax"), "pool")
    g.set_outputs("out")
    net = JGraph(g.build())
    net.init()
    return net


def _keras_files(tmp_path):
    from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

    rs = np.random.RandomState(3)
    seq = {"class_name": "Sequential", "config": {"name": "s", "layers": [
        {"class_name": "Dense", "config": {"name": "d", "units": 2, "activation": "softmax",
                                           "batch_input_shape": [None, 4]}}]}}
    fn = {"class_name": "Model", "config": {"name": "f", "layers": [
        {"class_name": "InputLayer", "name": "in",
         "config": {"name": "in", "batch_input_shape": [None, 4]}, "inbound_nodes": []},
        {"class_name": "Dense", "name": "d", "config": {"name": "d", "units": 2,
                                                        "activation": "softmax"},
         "inbound_nodes": [[["in", 0, 0, {}]]]}],
        "input_layers": [["in", 0, 0]], "output_layers": [["d", 0, 0]]}}
    paths = []
    for name, cfg in (("seq.h5", seq), ("fn.h5", fn)):
        p = tmp_path / name
        with Hdf5Archive(str(p), "w") as f:
            f.write_attr_string("model_config", json.dumps(cfg))
            f.write_attr_string("keras_version", "2.3.1")
            f.make_group("model_weights")
            f.make_group("model_weights/d")
            f.write_attr_strings("weight_names", ["d/kernel:0", "d/bias:0"], "model_weights/d")
            f.write_dataset("model_weights/d/d/kernel:0", rs.randn(4, 2).astype(np.float32))
            f.write_dataset("model_weights/d/d/bias:0", rs.randn(2).astype(np.float32))
        paths.append(p)
    return paths


def _format_files(tmp_path):
    """{format: (path, input_type for the port, for the JAX package)}"""
    graph = _cnn_graph()
    jdl4j.write_computation_graph(graph, str(tmp_path / "cg_dl4j.zip"))
    jser.save_model(graph, str(tmp_path / "cg_own.zip"))
    mlp_own = tmp_path / "mlp_own.zip"
    mlp = JNet(JConf(layers=(JL.OutputLayer(n_out=2, activation="softmax"),),
                     input_type=JI.feed_forward(3)))
    mlp.init()
    jser.save_model(mlp, str(mlp_own))
    files = {"dl4j_mln": (_mlp_zip(tmp_path), None, None),
             "dl4j_graph": (tmp_path / "cg_dl4j.zip", I.convolutional(6, 6, 2),
                            JI.convolutional(6, 6, 2)),
             "own_graph": (tmp_path / "cg_own.zip", None, None),
             "own_mln": (mlp_own, None, None)}
    if native.h5_available():
        seq, fn = _keras_files(tmp_path)
        files.update(keras_sequential=(seq, None, None), keras_functional=(fn, None, None))
    return files


def test_restore_checkpoint_routes_every_format_as_the_jax_package(tmp_path):
    """Each format reaches the same network kind in both packages, on the
    device asked for, with the same parameter count."""
    for what, (path, it, jit) in _format_files(tmp_path).items():
        mine = tzoo.restore_checkpoint(str(path), input_type=it, device="cpu")
        theirs = jzoo.restore_checkpoint(str(path), input_type=jit)
        assert type(mine).__name__ == type(theirs).__name__, what
        assert mine.num_params() == theirs.num_params(), what
        assert all(p.device.type == "cpu" for p in mine.parameters()), what


def test_restore_checkpoint_passes_input_type_to_the_graph_reader(tmp_path):
    """A DL4J graph zip of a CNN stores no input shape: without
    ``input_type`` the reader asks for one, with it the net restores."""
    graph = _cnn_graph()
    p = tmp_path / "cg.zip"
    jdl4j.write_computation_graph(graph, str(p))
    with pytest.raises(Dl4jImportError, match="input_type"):
        tzoo.restore_checkpoint(str(p), device="cpu")
    net = tzoo.restore_checkpoint(str(p), input_type=I.convolutional(6, 6, 2), device="cpu")
    assert net.conf.input_types == (I.convolutional(6, 6, 2),)
    x = np.random.RandomState(1).rand(2, 6, 6, 2).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(graph.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_zoo_default_input_type_plumbs_to_cnn_graph_restore():
    """``init_pretrained``'s input type for a graph zip comes from the
    registry's builder, as in the JAX package."""
    it = tzoo.get_model("resnet50")._default_input_type()
    assert isinstance(it, I.ConvolutionalType)
    assert (it.height, it.width, it.channels) == (224, 224, 3)
    jit = jzoo.get_model("resnet50")._default_input_type()
    assert (jit.height, jit.width, jit.channels) == (it.height, it.width, it.channels)
    assert tzoo.get_model("lenet")._default_input_type() == I.convolutional(28, 28, 1)


def test_init_pretrained_restores_a_dl4j_graph_zip(tmp_path, monkeypatch):
    """A zoo graph's pretrained file in the DL4J format (what the
    reference's pretrainedUrl serves) restores with the builder's input
    type."""
    import hashlib

    from deeplearning4j_tpu_torch import models as TM

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    (tmp_path / "zoo").mkdir()
    graph = _cnn_graph()
    p = tmp_path / "zoo" / "tiny_imagenet.zip"
    jdl4j.write_computation_graph(graph, str(p))
    md5 = hashlib.md5(p.read_bytes()).hexdigest()

    def builder():
        return GraphConfiguration.from_json(graph.conf.to_json())

    model = tzoo.ZooModel("tiny", builder, pretrained={
        TM.PretrainedType.IMAGENET: ("https://example.invalid/tiny.zip", md5)})
    net = model.init_pretrained(device="cpu")
    x = np.random.RandomState(2).rand(2, 6, 6, 2).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(graph.output(x)),
                               rtol=1e-5, atol=1e-6)


def _serve(capsys, *args):
    rc = cli.main(["serve", *args, "--smoke", "4", "--device", "cpu", "--max-batch", "4"])
    out = capsys.readouterr().out
    return rc, json.loads(out[out.index("\n{") + 1:])  # the stats follow the warmup line


def test_serve_takes_the_warmup_shape_from_the_flag(tmp_path, capsys):
    """A DL4J GravesLSTM zip restores as ``recurrent(n_in, None)``: the
    flag gives the sequence length; without it, serve exits naming it."""
    p, _ = _charnn_zip(tmp_path)
    with pytest.raises(SystemExit, match="--input-shape"):
        cli.main(["serve", "--model-path", str(p), "--smoke", "4", "--device", "cpu"])
    rc, stats = _serve(capsys, "--model-path", str(p), "--input-shape", "8,11")
    assert rc == 0 and stats["requests"]["served"] == 4


def test_serve_takes_the_warmup_shape_from_the_input_type(tmp_path, capsys):
    """A model whose conf states its input shape serves without the flag
    (a DL4J MLP zip: the feed-forward nIn; a graph: one shape per input),
    and a one-input graph takes the flag for its input."""
    rc, stats = _serve(capsys, "--model-path", str(_mlp_zip(tmp_path)))
    assert rc == 0 and stats["requests"]["served"] == 4
    jser.save_model(_cnn_graph(), str(tmp_path / "cg.zip"))
    for flag in ([], ["--input-shape", "6,6,2"]):
        rc, stats = _serve(capsys, "--model-path", str(tmp_path / "cg.zip"), *flag)
        assert rc == 0 and stats["requests"]["served"] == 4


def test_serve_refuses_one_shape_for_a_two_input_graph(tmp_path):
    jser.save_model(_cnn_graph(n_inputs=2), str(tmp_path / "two.zip"))
    with pytest.raises(SystemExit, match="inputs"):
        cli.main(["serve", "--model-path", str(tmp_path / "two.zip"), "--input-shape", "6,6,2",
                  "--smoke", "4", "--device", "cpu"])


def test_serve_a_keras_file(tmp_path, capsys):
    if not native.h5_available():
        pytest.skip("system libhdf5 absent")
    seq, _ = _keras_files(tmp_path)
    rc, stats = _serve(capsys, "--model-path", str(seq))
    assert rc == 0 and stats["requests"]["served"] == 4


def test_serve_cli_module_exits_zero_on_a_dl4j_zip(tmp_path):
    """The verb as a user runs it, in its own process."""
    p, _ = _charnn_zip(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path", str(p),
         "--input-shape", "8,11", "--smoke", "4", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert stats["requests"]["served"] == 4 and stats["device"] == "cpu"


def test_eval_verb_reads_a_dl4j_zip(tmp_path, capsys):
    p = _mlp_zip(tmp_path)
    rs = np.random.RandomState(0)
    np.save(tmp_path / "x.npy", rs.randn(16, 5).astype(np.float32))
    np.save(tmp_path / "y.npy", rs.randint(0, 3, 16))
    assert cli.main(["eval", "--model-path", str(p), "--data", str(tmp_path / "x.npy"),
                     "--labels", str(tmp_path / "y.npy"), "--device", "cpu"]) == 0
    assert "Accuracy" in capsys.readouterr().out


def test_a_zip_without_either_layout_is_not_a_dl4j_zip(tmp_path):
    """Only ``configuration.json`` with ``coefficients.bin`` is the DL4J
    layout; any other zip goes to ``load_model`` (and fails there)."""
    p = tmp_path / "half.zip"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("configuration.json", "{}")
    with pytest.raises(KeyError):
        tzoo.restore_checkpoint(str(p), device="cpu")
    with pytest.raises(KeyError):
        jzoo.restore_checkpoint(str(p))
