"""The port's recurrent layers beyond LSTM/GravesLSTM against the JAX package:
SimpleRnn, Bidirectional, GravesBidirectionalLSTM, RnnLossLayer and
LastTimeStep, forward and gradients, plus ``apply_with_carry`` (the TBPTT
building block) and the config JSON and checkpoint zip of nets holding them.

Every case feeds both packages the same numpy inputs and the same
JAX-initialised parameters, in float32. Tolerances: outputs atol 1e-5 (the
reference's f32 kernel tolerance); gradients atol 2e-5 + rtol 2e-4 (the
same sums in another order through the recurrence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNetConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TNetConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser

B, T, N_IN, H = 3, 6, 5, 8


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def _to_torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _to_torch(v, grad) for k, v in tree.items()}
    return torch.from_numpy(tree).requires_grad_(grad)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _data(seed, mask):
    rs = np.random.RandomState(seed)
    x = (0.5 * rs.randn(B, T, N_IN)).astype(np.float32)
    m = None
    if mask:
        lens = rs.randint(1, T + 1, size=B)
        m = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return x, m


def _compare(jlayer, tlayer, x, m, seed, in_type=None, ff_out=False):
    """Forward and gradients of sum(y * g) of both layers, from the JAX
    layer's parameters."""
    in_type = in_type or JI.RecurrentType(N_IN, T)
    params = _np_tree(jlayer.init(jax.random.PRNGKey(seed), in_type, jnp.float32))
    rs = np.random.RandomState(seed + 1)
    kw_j = {} if m is None else {"mask": jnp.asarray(m)}
    kw_t = {} if m is None else {"mask": torch.from_numpy(m)}
    y_probe, _ = jlayer.apply(_to_jax(params), {}, jnp.asarray(x), **kw_j)
    g = rs.randn(*y_probe.shape).astype(np.float32)

    def jloss(p):
        y, _ = jlayer.apply(p, {}, jnp.asarray(x), **kw_j)
        return jnp.sum(y * g), y

    (_, y_j), g_j = jax.value_and_grad(jloss, has_aux=True)(_to_jax(params))
    tp = _to_torch(params, grad=True)
    y_t, _ = tlayer.apply(tp, {}, torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-5)
    if not params:
        return
    (y_t * torch.from_numpy(g)).sum().backward()
    want, got = _flat(g_j), _flat(tp)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].grad.numpy(), np.asarray(want[k]), atol=2e-5,
                                   rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("mask", [False, True])
def test_simple_rnn_matches_jax(mask):
    x, m = _data(1, mask)
    _compare(JL.SimpleRnn(n_out=H), TL.SimpleRnn(n_out=H), x, m, seed=1)


@pytest.mark.parametrize("mode", ["concat", "add", "mul", "ave"])
@pytest.mark.parametrize("inner", ["lstm", "graves", "simple"])
def test_bidirectional_matches_jax(inner, mode):
    make = {"lstm": lambda L: L.LSTM(n_out=H), "graves": lambda L: L.GravesLSTM(n_out=H),
            "simple": lambda L: L.SimpleRnn(n_out=H)}[inner]
    x, m = _data(2, mask=mode == "concat")
    _compare(JL.Bidirectional(layer=make(JL), mode=mode),
             TL.Bidirectional(layer=make(TL), mode=mode), x, m, seed=2)


@pytest.mark.parametrize("mask", [False, True])
def test_graves_bidirectional_lstm_matches_jax(mask):
    x, m = _data(3, mask)
    _compare(JL.GravesBidirectionalLSTM(n_out=H), TL.GravesBidirectionalLSTM(n_out=H), x, m,
             seed=3)


@pytest.mark.parametrize("mask", [False, True])
def test_last_time_step_matches_jax(mask):
    x, m = _data(4, mask)
    _compare(JL.LastTimeStep(), TL.LastTimeStep(), x, m, seed=4)


def test_rnn_loss_layer_matches_jax():
    x, m = _data(5, True)
    jl, tl = JL.RnnLossLayer(activation="softmax"), TL.RnnLossLayer(activation="softmax")
    _compare(jl, tl, x, None, seed=5)
    labels = np.eye(N_IN, dtype=np.float32)[np.random.RandomState(5).randint(0, N_IN, (B, T))]
    pj, _ = jl.apply({}, {}, jnp.asarray(x))
    pt, _ = tl.apply({}, {}, torch.from_numpy(x))
    np.testing.assert_allclose(
        float(tl.compute_loss(pt, torch.from_numpy(labels), torch.from_numpy(m))),
        float(jl.compute_loss(pj, jnp.asarray(labels), jnp.asarray(m))), atol=1e-6)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "graves", "simple", "lstm_hardtanh"])
def test_apply_with_carry_matches_jax(kind, mask):
    """From a nonzero carry: outputs, final carry and the gradients through
    both (the port's sigmoid/tanh LSTM takes lstm_seq, the JAX package its
    scan)."""
    make = {"lstm": lambda L: L.LSTM(n_out=H), "graves": lambda L: L.GravesLSTM(n_out=H),
            "simple": lambda L: L.SimpleRnn(n_out=H),
            "lstm_hardtanh": lambda L: L.LSTM(n_out=H, activation="hardtanh")}[kind]
    jl, tl = make(JL), make(TL)
    x, m = _data(6, mask)
    params = _np_tree(jl.init(jax.random.PRNGKey(6), JI.RecurrentType(N_IN, T), jnp.float32))
    rs = np.random.RandomState(7)
    shapes = [(B, H)] if kind == "simple" else [(B, H), (B, H)]
    carry = [(0.3 * rs.randn(*s)).astype(np.float32) for s in shapes]
    gy = rs.randn(B, T, H).astype(np.float32)
    gc = [rs.randn(*s).astype(np.float32) for s in shapes]
    kw_j = {} if m is None else {"mask": jnp.asarray(m)}
    kw_t = {} if m is None else {"mask": torch.from_numpy(m)}

    def as_carry(c):
        return c[0] if kind == "simple" else tuple(c)

    def jloss(p, c):
        y, fin = jl.apply_with_carry(p, as_carry(c), jnp.asarray(x), **kw_j)
        fin = [fin] if kind == "simple" else list(fin)
        return jnp.sum(y * gy) + sum(jnp.sum(f * g) for f, g in zip(fin, gc)), (y, fin)

    (_, (y_j, fin_j)), (gp_j, gc_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        _to_jax(params), [jnp.asarray(c) for c in carry])
    tp = _to_torch(params, grad=True)
    tc = [torch.from_numpy(c).requires_grad_(True) for c in carry]
    y_t, fin_t = tl.apply_with_carry(tp, as_carry(tc), torch.from_numpy(x), **kw_t)
    fin_t = [fin_t] if kind == "simple" else list(fin_t)
    assert all(f.dtype == torch.float32 for f in fin_t)
    loss = (y_t * torch.from_numpy(gy)).sum() + sum(
        (f * torch.from_numpy(g)).sum() for f, g in zip(fin_t, gc))
    loss.backward()
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-5)
    for a, b in zip(fin_t, fin_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp_j[k]), atol=2e-5,
                                   rtol=2e-4, err_msg=k)
    for a, b in zip(tc, gc_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=2e-5, rtol=2e-4)


def test_zero_carry_shapes_and_dtype():
    h, c = TL.GravesLSTM(n_out=H).zero_carry(4, torch.float32, "cpu")
    assert h.shape == c.shape == (4, H) and h.dtype == torch.float32 and not h.any()
    assert TL.SimpleRnn(n_out=H).zero_carry(2).shape == (2, H)


def _net_confs(mod, umod, netconf, inputs):
    return netconf(seed=3, updater=umod.RmsProp(learning_rate=1e-2)).list(
        mod.GravesBidirectionalLSTM(n_out=6),
        mod.Bidirectional(layer=mod.SimpleRnn(n_out=4), mode="add"),
        mod.RnnOutputLayer(n_out=5, loss="mcxent"),
        input_type=inputs.RecurrentType(5, 7))


def test_new_layers_config_round_trips_both_ways():
    j_json = _net_confs(JL, JU, JNetConf, JI).to_json()
    assert TConf.from_json(j_json).to_json() == j_json
    assert _net_confs(TL, TU, TNetConf, TI).to_json() == j_json
    assert JConf.from_json(_net_confs(TL, TU, TNetConf, TI).to_json()).to_json() == j_json
    for layer in (TL.RnnLossLayer(), TL.LastTimeStep(), TL.SimpleRnn(n_out=3)):
        conf = TNetConf().list(TL.LSTM(n_out=3), layer, input_type=TI.RecurrentType(2, 4))
        assert JConf.from_json(conf.to_json()).to_json() == conf.to_json()


def test_nested_bidirectional_params_cross_the_zip_both_ways(tmp_path):
    """Bidirectional's fwd/bwd parameters nest in the zip v1 paths
    (params[0]['fwd']['Wx']): a port-trained net restores in the JAX
    package with equal outputs, and a JAX net loads into the port."""
    rs = np.random.RandomState(8)
    x = np.eye(5, dtype=np.float32)[rs.randint(0, 5, (4, 7))]
    tnet = TNet(_net_confs(TL, TU, TNetConf, TI), device="cpu")
    tnet.fit((x, x))
    tser.save_model(tnet, tmp_path / "t.zip")
    jnet = jser.load_model(str(tmp_path / "t.zip"))
    np.testing.assert_allclose(np.asarray(jnet.output(x)), tnet.output(x).numpy(), atol=1e-5)
    assert jnet.iteration == tnet.iteration == 1

    jnet2 = JNet(_net_confs(JL, JU, JNetConf, JI))
    jnet2.init()
    jser.save_model(jnet2, str(tmp_path / "j.zip"))
    tnet2 = tser.load_model(tmp_path / "j.zip", device="cpu")
    assert set(dict(tnet2.params[0])) == {"fwd", "bwd"}
    np.testing.assert_allclose(tnet2.output(x).numpy(), np.asarray(jnet2.output(x)), atol=1e-5)
