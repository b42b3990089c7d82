"""The port's DL4J ModelSerializer zip import/export against the JAX
package's (reference: util/ModelSerializer.java:51 writeModel, :136
restoreMultiLayerNetwork; the zoo's pretrainedUrl format).

Three kinds of check:
- the port's writer against the JAX package's: for the same weights and
  Adam state, the ``configuration.json``, ``coefficients.bin`` and
  ``updaterState.bin`` entries are byte-identical (the zips themselves
  differ in their timestamps), and a zip written by either package
  restores in the other to the same parameters (numpy, exactly) and to
  outputs within f32 rounding (rtol 1e-5, atol 1e-6: the two packages'
  f32 forwards differ in summation order);
- the semantics pins of ``tests/test_dl4j_import.py``, against numpy
  simulations of the reference's forward (the LSTM gate permutation with
  and without peepholes, conv OIHW -> HWIO, the 'f'-order unflatten, the
  CnnToFeedForward row order), not against either package's writer;
- the committed fixture zips (``tests/fixtures/dl4j_*_v1.zip``) against
  their ``*_expected.npy`` at the JAX test's tolerance.
The JAX networks are moved into the port by ``utils/serialization``
(a checkpoint written by the JAX package's ``save_model``), so both hold
the same tensors, updater state included.
"""

import io
import json
import os
import struct
import zipfile

import numpy as np
import pytest
import torch

import torch_native_guard  # noqa: E402

# before any test runs: the JAX package's native library, built without the race
torch_native_guard.heal_reference_native()

from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JElementWise
from deeplearning4j_tpu.nn.graph import GraphBuilder as JBuilder
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.modelimport import dl4j
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder, PreprocessorVertex
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import serialization as tser

RTOL, ATOL = 1e-5, 1e-6
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
IDENTITY = {"@class": "org.nd4j.linalg.activations.impl.ActivationIdentity"}


def _np(out):
    """A network's output (a tensor, a JAX array, or a dict of either for
    a graph: its first output) as numpy."""
    if isinstance(out, dict):
        out = next(iter(out.values()))
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _tree_np(tree):
    """{keystr path: numpy} of a (nested) list/dict of tensors or arrays."""
    out = {}

    def walk(node, path):
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{path}['{k}']")
        else:
            out[path] = _np(node)
    walk(tree, "")
    return out


def _assert_same_weights(port_net, jax_net):
    """Parameters and layer state equal to the bit (both hold float32)."""
    for what in ("params", "state"):
        mine = _tree_np(getattr(port_net, what))
        theirs = {k: v for k, v in _tree_np(getattr(jax_net, what)).items()}
        assert set(mine) == set(theirs), what
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k].astype(np.float32), err_msg=k)


def _to_port(jnet, tmp_path):
    """The JAX network as a port network on the CPU, through a checkpoint
    written by the JAX package (params, state and updater state)."""
    p = tmp_path / "jax_ckpt.zip"
    jser.save_model(jnet, str(p))
    return tser.load_model(str(p), device="cpu")


def _write_raw(p, cfg, flat):
    buf = io.BytesIO()
    dl4j.write_nd4j(np.asarray(flat, np.float32).reshape(1, -1), buf)
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("configuration.json", json.dumps(cfg))
        zf.writestr("coefficients.bin", buf.getvalue())


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


# ---------------------------------------------------------------------------
# the legacy Nd4j binary record
# ---------------------------------------------------------------------------


class TestNd4jBinaryFormat:
    CASES = [(np.arange(12, dtype=np.float32).reshape(3, 4), "c"),
             (np.random.RandomState(0).randn(2, 3, 4).astype(np.float32), "f"),
             (np.asarray([[1.5, -2.5]], np.float64), "c")]

    @pytest.mark.parametrize("case", range(3))
    def test_round_trip_and_bytes_equal_the_jax_writer(self, case):
        arr, order = self.CASES[case]
        buf, jbuf = io.BytesIO(), io.BytesIO()
        dl4j.write_nd4j(arr, buf, order=order)
        jdl4j.write_nd4j(arr, jbuf, order=order)
        assert buf.getvalue() == jbuf.getvalue()
        back = dl4j.read_nd4j(buf.getvalue())
        np.testing.assert_array_equal(back, arr)
        assert back.dtype == arr.dtype

    def test_byte_layout_pinned(self):
        """One record per BaseDataBuffer.write: writeUTF allocation mode,
        i32-BE length, writeUTF type, BE elements; shape-info then data."""
        buf = io.BytesIO()
        dl4j.write_nd4j(np.asarray([[1.0, 2.0]], np.float32), buf)
        f = io.BytesIO(buf.getvalue())

        def utf(f):
            n = struct.unpack(">H", f.read(2))[0]
            return f.read(n).decode()

        assert utf(f) == "HEAP"
        shape_len = struct.unpack(">i", f.read(4))[0]
        assert shape_len == 2 * 2 + 4
        assert utf(f) == "INT"
        info = struct.unpack(f">{shape_len}i", f.read(4 * shape_len))
        assert info[0] == 2 and info[1:3] == (1, 2)
        assert info[5] == 0 and info[7] == ord("c")
        assert utf(f) == "HEAP"
        assert struct.unpack(">i", f.read(4))[0] == 2
        assert utf(f) == "FLOAT"
        assert struct.unpack(">2f", f.read(8)) == (1.0, 2.0)
        assert not f.read()

    def test_fortran_order_reshape(self):
        arr = np.asarray([[1, 3], [2, 4]], np.float32)  # F-ravel: 1, 2, 3, 4
        buf = io.BytesIO()
        dl4j.write_nd4j(arr, buf, order="f")
        np.testing.assert_array_equal(dl4j.read_nd4j(buf.getvalue()), arr)

    def test_truncated_buffer_raises(self):
        buf = io.BytesIO()
        dl4j.write_nd4j(np.ones((1, 4), np.float32), buf)
        with pytest.raises(dl4j.Dl4jImportError, match="truncated"):
            dl4j.read_nd4j(buf.getvalue()[:-3])


# ---------------------------------------------------------------------------
# the port's writer and reader against the JAX package's
# ---------------------------------------------------------------------------


def _jax_mlp():
    return JConf(layers=(JL.DenseLayer(n_out=7, activation="relu"),
                         JL.OutputLayer(n_out=3, activation="softmax", loss="mcxent")),
                 input_type=JI.feed_forward(5), updater=JU.Adam(1e-3))


def _jax_cnn():
    return JConf(layers=(JL.ConvolutionLayer(n_out=4, kernel=(3, 3), stride=(1, 1),
                                             padding="same", activation="relu"),
                         JL.BatchNormalization(),
                         JL.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
                         JL.DenseLayer(n_out=6, activation="relu"),
                         JL.OutputLayer(n_out=2, activation="softmax")),
                 input_type=JI.convolutional(8, 8, 3), updater=JU.Adam(1e-3))


def _jax_graves():
    return JConf(layers=(JL.GravesLSTM(n_out=5, activation="tanh"),
                         JL.GravesLSTM(n_out=4, activation="tanh"),
                         JL.RnnOutputLayer(n_out=3, activation="softmax")),
                 input_type=JI.recurrent(3, 6), updater=JU.Adam(1e-3),
                 backprop_type="tbptt", tbptt_fwd_length=6, tbptt_back_length=6)


def _jax_residual_graph():
    g = (JBuilder(updater=JU.Adam(1e-3), seed=9)
         .add_inputs("in")
         .set_input_types(JI.convolutional(8, 8, 3))
         .add_layer("c1", JL.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same",
                                              activation="relu"), "in")
         .add_layer("bn1", JL.BatchNormalization(), "c1")
         .add_layer("c2", JL.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same"), "bn1")
         .add_vertex("add", JElementWise(op="add"), "c2", "bn1")
         .add_layer("relu", JL.ActivationLayer(activation="relu"), "add")
         .add_layer("pool", JL.GlobalPoolingLayer(mode="avg"), "relu")
         .add_layer("out", JL.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "pool"))
    g.set_outputs("out")
    return g.build()


def _data(kind, rs):
    if kind == "mlp":
        x = rs.randn(8, 5).astype(np.float32)
        return x, np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    if kind in ("cnn", "graph"):
        x = rs.rand(4, 8, 8, 3).astype(np.float32)
        n = 2 if kind == "cnn" else 3
        return x, np.eye(n, dtype=np.float32)[rs.randint(0, n, 4)]
    x = rs.randn(4, 6, 3).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rs.randint(0, 3, (4, 6))]


MODELS = {"mlp": (_jax_mlp, None), "cnn": (_jax_cnn, JI.convolutional(8, 8, 3)),
          "graves": (_jax_graves, JI.recurrent(3, 6)),
          "graph": (_jax_residual_graph, JI.convolutional(8, 8, 3))}
PORT_INPUT = {"mlp": None, "cnn": I.convolutional(8, 8, 3), "graves": I.recurrent(3, 6),
              "graph": I.convolutional(8, 8, 3)}


def _trained_pair(kind, tmp_path):
    """A JAX network after one Adam step (updater state and BN statistics
    non-trivial) and the same network in the port."""
    make, _ = MODELS[kind]
    conf = make()
    jnet = JGraph(conf) if kind == "graph" else JNet(conf)
    jnet.init()
    x, y = _data(kind, np.random.RandomState(1))
    jnet.fit(x, y)
    return jnet, _to_port(jnet, tmp_path), x


@pytest.mark.parametrize("kind", list(MODELS))
class TestAgainstTheJaxPackage:
    def _write(self, pkg, net, path):
        graph = "graph" in type(net).__name__.lower()
        w = (pkg.write_computation_graph if graph else pkg.write_multilayer_network)
        w(net, str(path), save_updater=True)

    def _restore(self, pkg, kind, path, **kw):
        it = MODELS[kind][1] if pkg is jdl4j else PORT_INPUT[kind]
        r = pkg.restore_computation_graph if kind == "graph" else pkg.restore_multilayer_network
        return r(str(path), input_type=it, load_updater=True, **kw)

    def test_zip_entries_byte_identical(self, kind, tmp_path):
        jnet, tnet, _ = _trained_pair(kind, tmp_path)
        self._write(jdl4j, jnet, tmp_path / "j.zip")
        self._write(dl4j, tnet, tmp_path / "t.zip")
        mine, theirs = _entries(tmp_path / "t.zip"), _entries(tmp_path / "j.zip")
        assert sorted(mine) == sorted(theirs) == ["coefficients.bin", "configuration.json",
                                                  "updaterState.bin"]
        for name in theirs:
            assert mine[name] == theirs[name], name

    def test_jax_written_zip_restores_in_the_port(self, kind, tmp_path):
        jnet, _, x = _trained_pair(kind, tmp_path)
        self._write(jdl4j, jnet, tmp_path / "j.zip")
        mine = self._restore(dl4j, kind, tmp_path / "j.zip", device="cpu")
        theirs = self._restore(jdl4j, kind, tmp_path / "j.zip")
        _assert_same_weights(mine, theirs)
        np.testing.assert_array_equal(mine.dl4j_updater_state, theirs.dl4j_updater_state)
        np.testing.assert_allclose(_np(mine.output(x)), _np(theirs.output(x)),
                                   rtol=RTOL, atol=ATOL)

    def test_port_written_zip_restores_in_the_jax_package(self, kind, tmp_path):
        jnet, tnet, x = _trained_pair(kind, tmp_path)
        self._write(dl4j, tnet, tmp_path / "t.zip")
        theirs = self._restore(jdl4j, kind, tmp_path / "t.zip")
        _assert_same_weights(tnet, theirs)
        np.testing.assert_allclose(_np(theirs.output(x)), _np(tnet.output(x)),
                                   rtol=RTOL, atol=ATOL)


def test_updater_state_is_in_the_jax_leaf_order(tmp_path):
    """``updaterState.bin`` walks dict keys sorted (Adam's m before v, a
    GravesLSTM's Wh, Wp, Wx, b), not the port's insertion order."""
    _, tnet, _ = _trained_pair("graves", tmp_path)
    p = tmp_path / "t.zip"
    dl4j.write_multilayer_network(tnet, str(p), save_updater=True)
    got = dl4j.read_nd4j(_entries(p)["updaterState.bin"]).reshape(-1)
    m0 = tnet.opt_state["m"][0]
    head = np.concatenate([m0[k].numpy().ravel() for k in ("Wh", "Wp", "Wx", "b")])
    np.testing.assert_array_equal(got[:head.size], head)


def test_restore_on_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jnet = JNet(_jax_mlp())
    jnet.init()
    p = tmp_path / "m.zip"
    jdl4j.write_multilayer_network(jnet, str(p))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dl4j.restore_multilayer_network(str(p))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.restore_checkpoint(str(p))


# ---------------------------------------------------------------------------
# the port's own round trips
# ---------------------------------------------------------------------------


def _round_trip(net, tmp_path, input_type=None, x=None):
    p = tmp_path / "model.zip"
    dl4j.write_multilayer_network(net, p)
    net2 = dl4j.restore_multilayer_network(p, input_type=input_type, device="cpu")
    if x is not None:
        np.testing.assert_allclose(_np(net2.output(x)), _np(net.output(x)), rtol=1e-6, atol=1e-7)
    return net2


class TestZipRoundTrip:
    def test_mlp(self, tmp_path):
        conf = MultiLayerConfiguration(
            layers=(L.DenseLayer(n_out=7, activation="relu"),
                    L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")),
            input_type=I.feed_forward(5), updater=U.Adam(1e-3))
        net = MultiLayerNetwork(conf, device="cpu")
        net.init()
        x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
        assert isinstance(_round_trip(net, tmp_path, x=x).conf.updater, U.Adam)

    def test_cnn_with_bn_state(self, tmp_path):
        conf = MultiLayerConfiguration(
            layers=(L.ConvolutionLayer(n_out=4, kernel=(3, 3), stride=(1, 1), padding="same",
                                       activation="relu"),
                    L.BatchNormalization(),
                    L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
                    L.DenseLayer(n_out=6, activation="relu"),
                    L.OutputLayer(n_out=2, activation="softmax")),
            input_type=I.convolutional(8, 8, 3), updater=U.Sgd(0.1))
        net = MultiLayerNetwork(conf, device="cpu")
        net.init()
        x = np.random.RandomState(1).randn(4, 8, 8, 3).astype(np.float32)
        y = np.zeros((4, 2), np.float32)
        y[:, 0] = 1
        net.fit(x, y)
        # the CNN input dims ride in inputPreProcessors: no input_type needed
        net2 = _round_trip(net, tmp_path, x=x)
        np.testing.assert_array_equal(net2.state[1]["mean"].numpy(), net.state[1]["mean"].numpy())

    def test_graves_lstm_peepholes_and_tbptt(self, tmp_path):
        conf = MultiLayerConfiguration(
            layers=(L.GravesLSTM(n_out=5, activation="tanh"),
                    L.RnnOutputLayer(n_out=2, activation="softmax")),
            input_type=I.recurrent(3, 8), updater=U.Sgd(0.1),
            backprop_type="tbptt", tbptt_fwd_length=4, tbptt_back_length=4)
        net = MultiLayerNetwork(conf, device="cpu")
        net.init()
        x = np.random.RandomState(3).randn(2, 8, 3).astype(np.float32)
        net2 = _round_trip(net, tmp_path, input_type=I.recurrent(3, 8), x=x)
        assert "Wp" in net2.params[0]
        assert net2.conf.backprop_type == "tbptt" and net2.conf.tbptt_fwd_length == 4

    def test_params_land_in_the_nets_dtype_and_device(self, tmp_path):
        conf = MultiLayerConfiguration(
            layers=(L.LSTM(n_out=6, activation="tanh"),
                    L.RnnOutputLayer(n_out=3, activation="softmax")),
            input_type=I.recurrent(4, 10), updater=U.Sgd(0.1))
        net = MultiLayerNetwork(conf, device="cpu")
        net.init()
        net2 = _round_trip(net, tmp_path, input_type=I.recurrent(4, 10))
        for p, q in zip(net.params, net2.params):
            for k in p:
                assert q[k].dtype == torch.float32 and q[k].device.type == "cpu"
                assert not q[k].requires_grad
                np.testing.assert_array_equal(q[k].numpy(), p[k].numpy())


# ---------------------------------------------------------------------------
# semantics pins against numpy simulations of the reference's forward
# ---------------------------------------------------------------------------


def _dl4j_lstm_forward(x, wx, rw, b, h, peephole):
    """LSTMHelpers.java forward in numpy, DL4J's own layout: gate column
    blocks [a(candidate, tanh), f, o, i(sigmoid)] (:216-262); Graves
    peephole columns 4H..4H+2 = [wFF->f, wOO->o, wGG->i] (:103-115)."""
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    bsz, t, _ = x.shape
    hs = np.zeros((bsz, h))
    cs = np.zeros((bsz, h))
    outs = []
    for step in range(t):
        z = x[:, step] @ wx[:, :4 * h] + hs @ rw[:, :4 * h] + b[:4 * h]
        za, zf, zo, zi = z[:, :h], z[:, h:2 * h], z[:, 2 * h:3 * h], z[:, 3 * h:]
        if peephole:
            zf = zf + cs * rw[:, 4 * h]
            zi = zi + cs * rw[:, 4 * h + 2]
        c = sig(zf) * cs + sig(zi) * np.tanh(za)
        if peephole:
            zo = zo + c * rw[:, 4 * h + 1]
        hs = sig(zo) * np.tanh(c)
        cs = c
        outs.append(hs)
    return np.stack(outs, axis=1)


class TestDl4jSemanticsPin:
    def test_dense_fortran_unflatten(self, tmp_path):
        n_in, n_out = 3, 2
        rs = np.random.RandomState(4)
        W = rs.randn(n_in, n_out).astype(np.float32)
        b = rs.randn(n_out).astype(np.float32)
        cfg = {"backprop": True, "backpropType": "Standard", "confs": [
            {"layer": {"dense": {"activationFn": IDENTITY, "nin": n_in, "nout": n_out,
                                 "updater": "SGD", "learningRate": 0.1}}}]}
        _write_raw(tmp_path / "hand.zip", cfg, np.concatenate([np.ravel(W, order="F"), b]))
        net = dl4j.restore_multilayer_network(tmp_path / "hand.zip", device="cpu")
        x = rs.randn(5, n_in).astype(np.float32)
        np.testing.assert_allclose(_np(net.output(x)), x @ W + b, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("peephole", [False, True])
    def test_lstm_gate_permutation(self, tmp_path, peephole):
        """A hand-built DL4J LSTM flat vector through the port's forward
        against the numpy DL4J simulation; the GravesLSTM's output (sigmoid
        gates, tanh) also runs the port's sequence op, the kernel's path."""
        n_in, h, t, bsz = 3, 4, 6, 2
        rs = np.random.RandomState(5)
        rw_cols = 4 * h + (3 if peephole else 0)
        wx = (rs.randn(n_in, 4 * h) * 0.4).astype(np.float32)
        rw = (rs.randn(h, rw_cols) * 0.4).astype(np.float32)
        b = (rs.randn(4 * h) * 0.4).astype(np.float32)
        flat = np.concatenate([np.ravel(wx, order="F"), np.ravel(rw, order="F"), b,
                               np.ravel(np.eye(h, dtype=np.float32), order="F"),
                               np.zeros(h, np.float32)])
        cfg = {"backprop": True, "backpropType": "Standard", "confs": [
            {"layer": {"gravesLSTM" if peephole else "LSTM": {
                "activationFn": {"@class": "org.nd4j.linalg.activations.impl.ActivationTanH"},
                "nin": n_in, "nout": h, "updater": "SGD", "learningRate": 0.1,
                "forgetGateBiasInit": 1.0}}},
            {"layer": {"rnnoutput": {
                "activationFn": IDENTITY,
                "lossFn": {"@class": "org.nd4j.linalg.lossfunctions.impl.LossMSE"},
                "nin": h, "nout": h, "updater": "SGD", "learningRate": 0.1}}}]}
        _write_raw(tmp_path / "lstm.zip", cfg, flat)
        net = dl4j.restore_multilayer_network(tmp_path / "lstm.zip",
                                              input_type=I.recurrent(n_in, t), device="cpu")
        assert net.conf.layers[0]._sequence_op()
        x = rs.randn(bsz, t, n_in).astype(np.float32)
        want = _dl4j_lstm_forward(x.astype(np.float64), wx, rw, b, h, peephole)
        np.testing.assert_allclose(_np(net.output(x)), want, rtol=1e-4, atol=1e-5)

    def test_conv_oihw_to_hwio(self, tmp_path):
        cin, cout = 2, 3
        rs = np.random.RandomState(6)
        W = rs.randn(cout, cin, 1, 1).astype(np.float32)
        b = rs.randn(cout).astype(np.float32)
        cfg = {"backprop": True, "backpropType": "Standard", "confs": [
            {"layer": {"convolution": {
                "activationFn": IDENTITY, "nin": cin, "nout": cout, "kernelSize": [1, 1],
                "stride": [1, 1], "convolutionMode": "Truncate", "padding": [0, 0],
                "updater": "SGD", "learningRate": 0.1}}}]}
        _write_raw(tmp_path / "conv.zip", cfg, np.concatenate([b, np.ravel(W, order="C")]))
        net = dl4j.restore_multilayer_network(tmp_path / "conv.zip",
                                              input_type=I.convolutional(4, 4, cin), device="cpu")
        x = rs.randn(2, 4, 4, cin).astype(np.float32)
        want = np.einsum("bhwc,oc->bhwo", x, W[:, :, 0, 0]) + b
        np.testing.assert_allclose(_np(net.output(x)), want, rtol=1e-5, atol=1e-6)

    def test_mln_reader_rejects_graph_zip(self, tmp_path):
        p = tmp_path / "graph.zip"
        with zipfile.ZipFile(p, "w") as zf:
            zf.writestr("configuration.json", json.dumps(
                {"networkInputs": ["in"], "networkOutputs": ["out"], "vertices": {},
                 "vertexInputs": {}}))
        with pytest.raises(dl4j.Dl4jImportError, match="ComputationGraph"):
            dl4j.restore_multilayer_network(p, device="cpu")

    def test_length_mismatch_raises(self, tmp_path):
        cfg = {"backprop": True, "confs": [
            {"layer": {"dense": {"nin": 3, "nout": 2, "updater": "SGD", "learningRate": 0.1}}}]}
        _write_raw(tmp_path / "bad.zip", cfg, np.zeros(5))  # needs 8
        with pytest.raises(dl4j.Dl4jImportError):
            dl4j.restore_multilayer_network(tmp_path / "bad.zip", device="cpu")

    def test_nonzero_bias_into_biasless_layer_raises(self, tmp_path):
        cfg = {"backprop": True, "confs": [
            {"layer": {"embedding": {"nin": 4, "nout": 2, "updater": "SGD",
                                     "learningRate": 0.1}}}]}
        _write_raw(tmp_path / "embbad.zip", cfg,
                   np.concatenate([np.zeros(8, np.float32), [1.0, 2.0]]))
        with pytest.raises(dl4j.Dl4jImportError, match="non-zero"):
            dl4j.restore_multilayer_network(tmp_path / "embbad.zip", device="cpu")

    def test_biasless_embedding_round_trips(self, tmp_path):
        conf = MultiLayerConfiguration(
            layers=(L.EmbeddingLayer(n_in=10, n_out=6),
                    L.OutputLayer(n_out=3, activation="softmax")),
            input_type=I.feed_forward(10), updater=U.Sgd(0.1))
        net = MultiLayerNetwork(conf, device="cpu")
        net.init()
        assert "b" not in net.params[0]
        _round_trip(net, tmp_path, x=np.asarray([[1.0], [7.0]], np.float32))

    def test_layervertex_unknown_preprocessor_refuses(self):
        body = {"layerConf": {"layer": {"dense": {"nin": 4, "nout": 2}}},
                "preProcessor": {"@class": "org.deeplearning4j.nn.conf.preprocessor."
                                           "RnnToCnnPreProcessor"}}
        with pytest.raises(dl4j.Dl4jImportError, match="preprocessor"):
            dl4j._vertex_from_json("LayerVertex", body)

    def test_layervertex_cnn_to_ff_preprocessor_permutes_dense_rows(self, tmp_path):
        """DL4J flattens CHW-major, the framework HWC-major: the import
        permutes W's rows so the output matches the DL4J forward."""
        h, w, c, n_out = 2, 2, 3, 2
        rs = np.random.RandomState(8)
        Wd = rs.randn(h * w * c, n_out).astype(np.float32)  # DL4J rows: CHW
        b = rs.randn(n_out).astype(np.float32)
        cfg = {"networkInputs": ["in"], "networkOutputs": ["out"],
               "vertexInputs": {"out": ["in"]},
               "vertices": {"out": {"LayerVertex": {
                   "layerConf": {"layer": {"output": {
                       "activationFn": IDENTITY,
                       "lossFn": {"@class": "org.nd4j.linalg.lossfunctions.impl.LossMSE"},
                       "nin": h * w * c, "nout": n_out, "updater": "SGD",
                       "learningRate": 0.1}}},
                   "preProcessor": {"@class": "org.deeplearning4j.nn.conf.preprocessor."
                                              "CnnToFeedForwardPreProcessor",
                                    "inputHeight": h, "inputWidth": w, "numChannels": c}}}}}
        _write_raw(tmp_path / "cnnff.zip", cfg, np.concatenate([np.ravel(Wd, order="F"), b]))
        net = dl4j.restore_computation_graph(tmp_path / "cnnff.zip",
                                             input_type=I.convolutional(h, w, c), device="cpu")
        x = rs.rand(2, h, w, c).astype(np.float32)
        want = x.transpose(0, 3, 1, 2).reshape(2, -1) @ Wd + b
        np.testing.assert_allclose(_np(net.output(x)), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ComputationGraph zips
# ---------------------------------------------------------------------------


class TestComputationGraphZips:
    def test_reference_topo_order_param_layout(self):
        """Inputs first, JSON-map order seeds, FIFO, ascending release: the
        a/b branches in map order, not name order; the port's own vertex
        order is not used."""
        args = (["in"], ["zz_first", "aa_second", "merge"],
                {"zz_first": ["in"], "aa_second": ["in"], "merge": ["zz_first", "aa_second"]})
        assert dl4j._reference_topo_order(*args) == ["zz_first", "aa_second", "merge"]
        assert dl4j._reference_topo_order(*args) == jdl4j._reference_topo_order(*args)

    def test_mini_resnet_zips_match_across_packages(self, tmp_path):
        """The zoo's pretrained shape: ResNet50 (bottleneck stages, BN,
        projection shortcuts) at 16x16. The port's zip restores in the JAX
        package, whose writer then gives the same entries back; the port's
        restore holds the JAX restore's tensors (the format stores a bias
        for every conv: zeros where the source has none) and answers as
        the source does."""
        from deeplearning4j_tpu_torch.models.resnet import resnet50

        net = ComputationGraph(resnet50(height=16, width=16, n_classes=4,
                                        updater=U.Adam(1e-3), seed=3), device="cpu")
        net.init()
        dl4j.write_computation_graph(net, str(tmp_path / "t.zip"))
        jnet = jdl4j.restore_computation_graph(str(tmp_path / "t.zip"),
                                               input_type=JI.convolutional(16, 16, 3))
        jdl4j.write_computation_graph(jnet, str(tmp_path / "j.zip"))
        assert _entries(tmp_path / "t.zip") == _entries(tmp_path / "j.zip")
        restored = tzoo.restore_checkpoint(str(tmp_path / "t.zip"),
                                           input_type=I.convolutional(16, 16, 3), device="cpu")
        assert isinstance(restored, ComputationGraph)
        _assert_same_weights(restored, jnet)
        x = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
        np.testing.assert_allclose(_np(restored.output(x)), _np(net.output(x)),
                                   rtol=RTOL, atol=ATOL)

    def test_graph_infer_input_type_without_explicit(self, tmp_path):
        g = (GraphBuilder(updater=U.Sgd(0.1), seed=2)
             .add_inputs("in").set_input_types(I.feed_forward(5))
             .add_layer("d", L.DenseLayer(n_out=4, activation="tanh"), "in")
             .add_layer("out", L.OutputLayer(n_out=2, activation="softmax"), "d")
             .set_outputs("out"))
        net = ComputationGraph(g.build(), device="cpu")
        net.init()
        dl4j.write_computation_graph(net, tmp_path / "ffg.zip")
        net2 = dl4j.restore_computation_graph(tmp_path / "ffg.zip", device="cpu")
        x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
        np.testing.assert_array_equal(_np(net2.output(x)), _np(net.output(x)))

    def test_dup_tts_resolves_timesteps_from_input(self):
        cfg = {"networkInputs": ["seq", "ctx"], "networkOutputs": ["out"],
               "vertexInputs": {"dup": ["ctx"], "merge": ["seq", "dup"], "out": ["merge"]},
               "vertices": {
                   "dup": {"DuplicateToTimeSeriesVertex": {"inputName": "seq"}},
                   "merge": {"MergeVertex": {}},
                   "out": {"LayerVertex": {"layerConf": {"layer": {"rnnoutput": {
                       "nin": 7, "nout": 2, "updater": "SGD", "learningRate": 0.1}}}}}}}
        conf, _, _ = dl4j.read_graph_config(cfg, input_type=[I.recurrent(4, 9),
                                                              I.feed_forward(3)])
        assert [v for v in conf.vertices if v.name == "dup"][0].vertex.timesteps == 9

    def test_dup_tts_unknown_timesteps_refuses(self):
        cfg = {"networkInputs": ["ctx"], "networkOutputs": ["out"],
               "vertexInputs": {"dup": ["ctx"], "out": ["dup"]},
               "vertices": {
                   "dup": {"DuplicateToTimeSeriesVertex": {"inputName": "missing"}},
                   "out": {"LayerVertex": {"layerConf": {"layer": {"rnnoutput": {
                       "nin": 3, "nout": 2, "updater": "SGD", "learningRate": 0.1}}}}}}}
        with pytest.raises(dl4j.Dl4jImportError, match="timestep"):
            dl4j.read_graph_config(cfg, input_type=[I.feed_forward(3)])

    def test_preprocessor_vertex_export_import(self, tmp_path):
        g = (GraphBuilder(updater=U.Sgd(0.1), seed=7)
             .add_inputs("in").set_input_types(I.convolutional(4, 4, 2))
             .add_vertex("flat", PreprocessorVertex(kind="cnn_to_ff"), "in")
             .add_layer("out", L.OutputLayer(n_out=2, activation="softmax"), "flat")
             .set_outputs("out"))
        net = ComputationGraph(g.build(), device="cpu")
        net.init()
        dl4j.write_computation_graph(net, tmp_path / "prep.zip")
        net2 = dl4j.restore_computation_graph(tmp_path / "prep.zip",
                                              input_type=I.convolutional(4, 4, 2), device="cpu")
        assert any(isinstance(v.vertex, PreprocessorVertex) for v in net2.conf.vertices)
        x = np.random.RandomState(1).rand(2, 4, 4, 2).astype(np.float32)
        np.testing.assert_array_equal(_np(net2.output(x)), _np(net.output(x)))


# ---------------------------------------------------------------------------
# the committed fixture zips
# ---------------------------------------------------------------------------


def _manifest():
    with open(os.path.join(FIXTURES, "dl4j_manifest.json")) as f:
        return json.load(f)["fixtures"]


def _fixture_input_type(spec, I):
    if spec[0] == "conv":
        return I.convolutional(*spec[1:])
    if spec[0] == "rnn":
        return I.recurrent(*spec[1:])
    return I.feed_forward(spec[1])


@pytest.mark.parametrize("fx", _manifest(), ids=lambda fx: fx["name"])
def test_fixture_zip_matches_its_expected_output(fx):
    """Each committed DL4J zip restores in the port (by the zoo's format
    detection) to the pinned outputs, at the JAX test's tolerance, and to
    the JAX package's restore's parameters."""
    path = os.path.join(FIXTURES, f"{fx['name']}.zip")
    net = tzoo.restore_checkpoint(path, input_type=_fixture_input_type(fx["input_type"], I),
                                  device="cpu")
    assert isinstance(net, ComputationGraph if fx["kind"] == "graph" else MultiLayerNetwork)
    x = np.load(os.path.join(FIXTURES, f"{fx['name']}_input.npy"))
    want = np.load(os.path.join(FIXTURES, f"{fx['name']}_expected.npy"))
    np.testing.assert_allclose(_np(net.output(x)), want, rtol=1e-5, atol=1e-6)
    jit = _fixture_input_type(fx["input_type"], JI)
    jnet = (jdl4j.restore_computation_graph(path, input_type=jit) if fx["kind"] == "graph"
            else jdl4j.restore_multilayer_network(path, input_type=jit))
    _assert_same_weights(net, jnet)


@pytest.mark.parametrize("name", ["mlp_adam_v1", "cnn_adam_v1", "lstm_adam_v1"])
def test_framework_fixture_zip_routes_to_load_model(name):
    """The framework's own checkpoint zips (format v1) still go through
    ``load_model``, updater state included, and match their pinned
    outputs."""
    net = tzoo.restore_checkpoint(os.path.join(FIXTURES, f"{name}.zip"), device="cpu")
    assert net.opt_state is not None
    x = np.load(os.path.join(FIXTURES, f"{name}_input.npy"))
    want = np.load(os.path.join(FIXTURES, f"{name}_expected.npy"))
    np.testing.assert_allclose(_np(net.output(x)), want, rtol=1e-5, atol=1e-6)
