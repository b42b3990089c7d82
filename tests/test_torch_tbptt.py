"""Truncated BPTT, streaming inference and remat in the port's networks
against the JAX package, and the TF32 policy of their entry points.

Both packages start from the same JAX-initialised parameters and see the
same numpy batches. Each JAX TBPTT chunk scans the LSTM; the port's runs
``lstm_seq`` (its plain version here) with ``lstm_seq_bwd``. Tolerances:
outputs and streamed outputs atol 1e-5 (the reference's f32 kernel
tolerance); the loss and parameters after several updater steps atol 1e-5
+ rtol 1e-4 (the JAX tests run in x64, so its updater scalars are f64 where
the port's are f32, and RmsProp's and Adam's first steps divide a gradient
by its own magnitude).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.misc import text_generation_lstm as j_charnn
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JBuilder
from deeplearning4j_tpu.nn.graph import LastTimeStepVertex as JLast
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.models.misc import text_generation_lstm as t_charnn
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TNetConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import GraphBuilder as TBuilder
from deeplearning4j_tpu_torch.nn.graph import LastTimeStepVertex as TLast
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ops import lstm_seq as L
from deeplearning4j_tpu_torch.utils import dtypes as TD
from deeplearning4j_tpu_torch.utils import serialization as tser

VOCAB, HID, WIN = 11, 16, 8
ATOL, RTOL = 1e-5, 1e-4


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree.detach() if torch.is_tensor(tree) else tree, np.float64)


def _assert_trees(got, want, atol=ATOL, rtol=RTOL):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees(g, w, atol, rtol)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k], atol, rtol)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _chars(n, t, seed):
    """One-hot next-char data: x [n,t,V], y its shift by one."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, size=(n, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _charnn_pair(seq_len=WIN):
    jnet = JNet(j_charnn(VOCAB, hidden=HID, seq_len=seq_len))
    jnet.init()
    tnet = TNet(t_charnn(VOCAB, hidden=HID, seq_len=seq_len), device="cpu")
    tser.params_from_numpy(tnet, [{k: np.asarray(v) for k, v in p.items()}
                                  for p in jnet.params])
    return jnet, tnet


# ---------------------------------------------------------------------------
# MultiLayerNetwork
# ---------------------------------------------------------------------------

def test_tbptt_fit_matches_jax_fit_tbptt():
    """A tiny char-RNN (T=24 in chunks of 8, RmsProp) over two batches:
    parameters, updater state, iteration and score as the JAX package's
    ``_fit_tbptt`` leaves them."""
    jnet, tnet = _charnn_pair()
    x, y = _chars(8, 24, seed=1)
    jnet.fit(x, y, batch_size=4)
    tnet.fit((x, y), batch_size=4)
    assert tnet.iteration == jnet.iteration == 6
    assert len(tnet.score_history) == 2
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=RTOL)
    _assert_trees(tnet.params, jnet.params)
    _assert_trees(tnet.opt_state, jnet.opt_state, atol=1e-7, rtol=1e-3)


def test_tbptt_step_matches_jax_from_a_carried_state():
    """One chunk from nonzero carries: loss, the carries out (f32) and the
    updated parameters; the carries come out detached."""
    jnet, tnet = _charnn_pair()
    x, y = _chars(3, WIN, seed=2)
    rs = np.random.RandomState(2)
    carries = [tuple((0.3 * rs.randn(3, HID)).astype(np.float32) for _ in range(2))
               for _ in range(2)] + [None]
    j_out = jnet.make_tbptt_step(jit=False)(
        jnet.params, jnet.state, jnet.opt_state,
        [None if c is None else tuple(jnp.asarray(a) for a in c) for c in carries],
        jnp.asarray(x), jnp.asarray(y), 0, jax.random.PRNGKey(0))
    tnet.opt_state = tnet.conf.updater.init(tnet.params)
    t_out = tnet.make_tbptt_step()(
        tnet.params, tnet.state, tnet.opt_state,
        [None if c is None else tuple(torch.from_numpy(a) for a in c) for c in carries],
        torch.from_numpy(x), torch.from_numpy(y), 0)
    np.testing.assert_allclose(float(t_out[4]), float(j_out[4]), atol=ATOL)
    for tc, jc in zip(t_out[3][:2], j_out[3][:2]):
        for a, b in zip(tc, jc):
            assert a.dtype == torch.float32 and not a.requires_grad
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    _assert_trees(t_out[0], j_out[0])


def test_tbptt_gate_follows_jax():
    """Only 3-d features and labels longer than the window go to TBPTT."""
    _, tnet = _charnn_pair()
    x, y = _chars(2, WIN, seed=3)
    assert not tnet._tbptt_applies(torch.from_numpy(x), torch.from_numpy(y))
    x, y = _chars(2, WIN + 1, seed=3)
    assert tnet._tbptt_applies(torch.from_numpy(x), torch.from_numpy(y))
    assert not tnet._tbptt_applies(torch.from_numpy(x), torch.from_numpy(y[:, 0]))
    std = TNet(dataclasses.replace(tnet.conf, backprop_type="standard"), device="cpu")
    assert not std._tbptt_applies(torch.from_numpy(x), torch.from_numpy(y))


def test_tbptt_carries_in_f32_under_bf16_policy():
    """Under bf16_policy the kernel branch's final (h, c) crosses the chunk
    boundary in f32, as the kernel keeps it inside a sequence: TBPTT's
    forward over two chunks equals the one-chunk forward to bf16 output
    rounding, and the carries stay f32."""
    _, tnet = _charnn_pair(seq_len=2 * WIN)
    x, _ = _chars(2, 2 * WIN, seed=4)
    xt = torch.from_numpy(x)
    TD.bf16_policy()
    try:
        with torch.inference_mode():
            carries = tnet._zero_carries(2, xt.dtype, xt.device)
            y1, _, carries = tnet._apply_rnn(tnet.params, tnet.state, xt[:, :WIN], carries)
            y2, _, carries = tnet._apply_rnn(tnet.params, tnet.state, xt[:, WIN:], carries)
            full = tnet.output(x)
    finally:
        TD.f32_policy()
    assert all(t.dtype == torch.float32 for c in carries[:2] for t in c)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).float().numpy(), full.float().numpy(),
                               atol=1e-2)


def test_rnn_time_step_matches_jax_streaming():
    jnet, tnet = _charnn_pair()
    x, _ = _chars(3, 10, seed=5)
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    for t in range(10):
        np.testing.assert_allclose(tnet.rnn_time_step(x[:, t]).numpy(),
                                   np.asarray(jnet.rnn_time_step(x[:, t])), atol=ATOL)
    # a short chunk continues the same stream
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, :3]).numpy(),
                               np.asarray(jnet.rnn_time_step(x[:, :3])), atol=ATOL)


def test_port_streaming_equals_full_forward_and_clear_resets():
    _, tnet = _charnn_pair()
    x, _ = _chars(4, 10, seed=6)
    full = tnet.output(x).numpy()
    tnet.rnn_clear_previous_state()
    stream = np.stack([tnet.rnn_time_step(x[:, t]).numpy() for t in range(10)], axis=1)
    np.testing.assert_allclose(stream, full, rtol=1e-5, atol=1e-6)
    tnet.rnn_clear_previous_state()
    first = tnet.rnn_time_step(x[:, 0]).numpy()
    tnet.rnn_time_step(x[:, 1])
    tnet.rnn_clear_previous_state()
    np.testing.assert_array_equal(tnet.rnn_time_step(x[:, 0]).numpy(), first)


def test_port_trained_charnn_zip_restores_in_jax(tmp_path):
    """A char-RNN trained in the port by TBPTT, saved to zip v1, restores in
    the JAX package with equal outputs and its iteration and updater state."""
    _, tnet = _charnn_pair()
    x, y = _chars(4, 20, seed=7)
    tnet.fit((x, y), batch_size=2)
    tser.save_model(tnet, tmp_path / "charnn.zip")
    jnet = jser.load_model(str(tmp_path / "charnn.zip"))
    assert jnet.iteration == tnet.iteration == 6
    np.testing.assert_allclose(np.asarray(jnet.output(x)), tnet.output(x).numpy(), atol=ATOL)
    _assert_trees(tnet.opt_state, jnet.opt_state, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# ComputationGraph
# ---------------------------------------------------------------------------

def _graph_pair(backprop_type="tbptt", fwd=8):
    def build(builder, L, U, I):
        return (builder(updater=U.Adam(5e-3), seed=3, backprop_type=backprop_type,
                        tbptt_fwd_length=fwd, tbptt_back_length=fwd)
                .add_inputs("in").set_input_types(I.RecurrentType(6, 32))
                .add_layer("lstm", L.LSTM(n_out=12, activation="tanh"), "in")
                .add_layer("out", L.RnnOutputLayer(n_out=6, activation="softmax"), "lstm")
                .set_outputs("out").build())
    jnet = JGraph(build(JBuilder, JL, JU, JI))
    jnet.init()
    tnet = TGraph(build(TBuilder, TL, TU, TI), device="cpu")
    tser.params_from_numpy(tnet, _np(jnet.params))
    return jnet, tnet


def _seq_data(b=8, t=32, f=6, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, f, (b, t))
    eye = np.eye(f, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def test_graph_tbptt_fit_matches_jax():
    jnet, tnet = _graph_pair()
    x, y = _seq_data(seed=1)
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert tnet.iteration == jnet.iteration == 8
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=RTOL)
    _assert_trees(tnet.params, jnet.params)


def test_graph_carried_forward_equals_full_forward():
    jnet, tnet = _graph_pair()
    x, _ = _seq_data(seed=2)
    xt = torch.from_numpy(x)
    carries = tnet._zero_carries(8, xt.dtype, xt.device)
    with torch.inference_mode():
        acts, _, _, carries2 = tnet._forward_pass(tnet.params, tnet.state, {"in": xt},
                                                  train=False, carries=carries)
    np.testing.assert_allclose(acts["out"].numpy(), tnet.output(x).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)), atol=ATOL)
    assert float(carries2["lstm"][0].abs().max()) > 0


def test_graph_rnn_time_step_matches_full_and_jax():
    jnet, tnet = _graph_pair(backprop_type="standard")
    x, _ = _seq_data(seed=3)
    full = tnet.output(x).numpy()
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    outs = []
    for t in range(8):
        outs.append(tnet.rnn_time_step(x[:, t]).numpy())
        np.testing.assert_allclose(outs[-1], np.asarray(jnet.rnn_time_step(x[:, t])),
                                   atol=ATOL)
    np.testing.assert_allclose(np.stack(outs, axis=1), full[:, :8], rtol=1e-5, atol=1e-6)
    tnet.rnn_clear_previous_state()
    np.testing.assert_array_equal(tnet.rnn_time_step(x[:, 0]).numpy(), outs[0])


def test_graph_tbptt_static_labels_through_last_time_step_vertex():
    """A LastTimeStepVertex classifier with 2-d labels: batch_size is kept
    (3 batches x 3 chunks = 9 iterations), the labels pass whole into each
    chunk, and the parameters match the JAX package's."""
    def build(builder, L, U, I, last):
        return (builder(updater=U.Adam(5e-3), seed=5, backprop_type="tbptt",
                        tbptt_fwd_length=8, tbptt_back_length=8)
                .add_inputs("in").set_input_types(I.RecurrentType(4, 24))
                .add_layer("lstm", L.LSTM(n_out=8, activation="tanh"), "in")
                .add_vertex("last", last(), "lstm")
                .add_layer("out", L.OutputLayer(n_out=3, activation="softmax"), "last")
                .set_outputs("out").build())
    jnet = JGraph(build(JBuilder, JL, JU, JI, JLast))
    jnet.init()
    tnet = TGraph(build(TBuilder, TL, TU, TI, TLast), device="cpu")
    tser.params_from_numpy(tnet, _np(jnet.params))
    rs = np.random.RandomState(3)
    x = rs.randn(12, 24, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 12)]
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    assert tnet.iteration == jnet.iteration == 9
    assert len(tnet.score_history) == 3
    out = tnet.output(x)
    assert out.shape == (12, 3) and torch.isfinite(out).all()
    _assert_trees(tnet.params, jnet.params)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), atol=ATOL)


def test_graph_streaming_refuses_bidirectional_layers():
    conf = (TBuilder(backprop_type="tbptt", tbptt_fwd_length=4)
            .add_inputs("in").set_input_types(TI.RecurrentType(3, 8))
            .add_layer("bi", TL.GravesBidirectionalLSTM(n_out=4), "in")
            .add_layer("out", TL.RnnOutputLayer(n_out=3), "bi").set_outputs("out").build())
    net = TGraph(conf, device="cpu")
    x = np.zeros((2, 8, 3), np.float32)
    with pytest.raises(ValueError, match="bidirectional"):
        net.rnn_time_step(x[:, 0])
    with pytest.raises(ValueError, match="bidirectional"):
        net.fit(x, x)


# ---------------------------------------------------------------------------
# remat (gradient_checkpointing) and the TF32 policy
# ---------------------------------------------------------------------------

def _small_net(remat):
    return TNet(TNetConf(seed=4, updater=TU.Sgd(0.1)).list(
        TL.GravesLSTM(n_out=8), TL.LastTimeStep(), TL.DenseLayer(n_out=6, activation="tanh"),
        TL.OutputLayer(n_out=3, loss="mcxent", activation="softmax"),
        input_type=TI.RecurrentType(5, 7), gradient_checkpointing=remat), device="cpu")


def test_gradient_checkpointing_remats_the_layers():
    """Same loss and gradients with and without the flag; fewer tensors
    saved for the backward with it; the LSTM's forward runs again in the
    backward (the plain version's calls counted here, as the kernel's
    launches would be on the card)."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(4, 7, 5).astype(np.float32))
    y = torch.from_numpy(np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)])
    results = {}
    for remat in (False, True):
        net = _small_net(remat)
        net.init()
        saved, calls = [0], [0]
        plain = L.lstm_seq_plain

        def count(*a, **k):
            calls[0] += 1
            return plain(*a, **k)

        L.lstm_seq_plain = count
        try:
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.__setitem__(0, saved[0] + 1) or t, lambda t: t):
                loss, _, grads = net.compute_gradients(net.params, net.state, x, y)
        finally:
            L.lstm_seq_plain = plain
        results[remat] = (float(loss), grads, saved[0], calls[0])
    (l0, g0, s0, c0), (l1, g1, s1, c1) = results[False], results[True]
    assert l1 == l0
    _assert_trees(g1, g0, atol=0, rtol=0)
    assert s1 < s0, (s1, s0)
    assert (c0, c1) == (1, 2)


class _Recorder(TL.LastTimeStep):
    """LastTimeStep that records cuDNN's TF32 flag each time it runs."""

    seen = []

    def apply(self, params, state, x, *, train=False, mask=None):
        _Recorder.seen.append(torch.backends.cudnn.allow_tf32)
        return super().apply(params, state, x, train=train, mask=mask)


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_entry_points_turn_cudnn_tf32_off_under_f32(policy):
    """fit, output and score run with cuDNN's TF32 off under the f32 policy
    (full f32 convolutions, as the reference's) and leave it as it was
    under bf16_policy; the old value is back after each call."""
    net = TNet(TNetConf(seed=4).list(
        TL.GravesLSTM(n_out=4), _Recorder(), TL.OutputLayer(n_out=3, loss="mcxent"),
        input_type=TI.RecurrentType(5, 3)), device="cpu")
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    old = torch.backends.cudnn.allow_tf32
    (TD.bf16_policy if policy == "bf16" else TD.f32_policy)()
    try:
        torch.backends.cudnn.allow_tf32 = True
        _Recorder.seen = []
        net.fit((x, y))
        net.output(x)
        net.score(x, y)
        assert _Recorder.seen == [policy == "bf16"] * 3
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = old
        TD.f32_policy()


def test_graph_entry_points_turn_cudnn_tf32_off_under_f32():
    conf = (TBuilder().add_inputs("in").set_input_types(TI.RecurrentType(5, 3))
            .add_layer("lstm", TL.LSTM(n_out=4), "in")
            .add_layer("rec", _Recorder(), "lstm")
            .add_layer("out", TL.OutputLayer(n_out=3), "rec").set_outputs("out").build())
    net = TGraph(conf, device="cpu")
    x = np.random.RandomState(2).randn(2, 3, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[1, 2]]
    old = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        _Recorder.seen = []
        net.fit(x, y)
        net.output(x)
        net.score(x, y)
        net.rnn_time_step(x[:, 0])
        assert _Recorder.seen == [False] * 4
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _DetRecorder(TL.LastTimeStep):
    """LastTimeStep that records cuDNN's deterministic flag each time it runs."""

    seen = []

    def apply(self, params, state, x, *, train=False, mask=None):
        _DetRecorder.seen.append(torch.backends.cudnn.deterministic)
        return super().apply(params, state, x, train=train, mask=mask)


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_entry_points_make_cudnn_deterministic_under_f32(policy):
    """fit, output and score run with cuDNN's algorithms deterministic
    under the f32 policy (in full float32 cuDNN otherwise picks backward
    algorithms whose sums change order from run to run, so a step would
    not repeat itself to the bit) and leave the flag as it was under
    bf16_policy; the old value is back after each call."""
    net = TNet(TNetConf(seed=4).list(
        TL.GravesLSTM(n_out=4), _DetRecorder(), TL.OutputLayer(n_out=3, loss="mcxent"),
        input_type=TI.RecurrentType(5, 3)), device="cpu")
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    old = torch.backends.cudnn.deterministic
    (TD.bf16_policy if policy == "bf16" else TD.f32_policy)()
    try:
        torch.backends.cudnn.deterministic = False
        _DetRecorder.seen = []
        net.fit((x, y))
        net.output(x)
        net.score(x, y)
        assert _DetRecorder.seen == [policy == "f32"] * 3
        assert torch.backends.cudnn.deterministic is False
    finally:
        torch.backends.cudnn.deterministic = old
        TD.f32_policy()
