"""The port's LSTM sequence op and recurrent layers against the JAX package.

``lstm_seq_plain`` (the plain version the CUDA kernel is held against on
the card) is compared with the Pallas LSTM kernel run in interpret mode,
and the port's ``LSTM``/``GravesLSTM`` layers with the JAX layers' scan
path, on the same numpy inputs. f32 tolerance atol 1e-5 (the reference's
own kernel tolerance, tests/test_ops.py); bf16 operands atol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.ops import lstm_pallas
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.ops import lstm_seq as ops

T = 5


def _inputs(b, h, peephole, mask, seed=0):
    rs = np.random.RandomState(seed)
    f32 = np.float32
    xz = rs.randn(T, b, 4 * h).astype(f32)
    wh = (rs.randn(h, 4 * h) / np.sqrt(h)).astype(f32)
    h0 = (0.1 * rs.randn(b, h)).astype(f32)
    c0 = (0.1 * rs.randn(b, h)).astype(f32)
    wp = (0.1 * rs.randn(3, h)).astype(f32) if peephole else None
    m = None
    if mask:  # ragged lengths, time-major [T, B]
        lens = rs.randint(1, T + 1, size=b)
        m = (np.arange(T)[:, None] < lens[None, :]).astype(f32)
    return xz, wh, h0, c0, wp, m


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("b,h", [(1, 32), (3, 100), (8, 32)])
def test_plain_matches_pallas_kernel(b, h, mask, peephole):
    xz, wh, h0, c0, wp, m = _inputs(b, h, peephole, mask, seed=b * h)
    hs_j, (ht_j, ct_j) = lstm_pallas.fused_sequence_padded(
        _jax(xz), _jax(wh), _jax(h0), _jax(c0), wp=_jax(wp), mask=_jax(m),
        interpret=True)
    hs, cs, ht, ct = ops.lstm_seq_plain(_torch(xz), _torch(wh), _torch(h0),
                                        _torch(c0), wp=_torch(wp), mask=_torch(m))
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(ht_j), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(ct_j), atol=1e-5)
    # cs is not returned by the JAX entry point: its last step is cT
    np.testing.assert_allclose(cs[-1].numpy(), np.asarray(ct_j), atol=1e-5)


def test_plain_matches_pallas_kernel_bf16():
    xz, wh, h0, c0, wp, m = _inputs(3, 32, True, True, seed=11)
    bf = jnp.bfloat16
    hs_j, (ht_j, ct_j) = lstm_pallas.fused_sequence_padded(
        _jax(xz, bf), _jax(wh, bf), _jax(h0, bf), _jax(c0, bf), wp=_jax(wp, bf),
        mask=_jax(m), interpret=True)
    tb = torch.bfloat16
    hs, _, ht, ct = ops.lstm_seq_plain(_torch(xz, tb), _torch(wh, tb), _torch(h0, tb),
                                       _torch(c0, tb), wp=_torch(wp, tb), mask=_torch(m))
    assert hs.dtype == torch.bfloat16
    for got, want in ((hs, hs_j), (ht, ht_j), (ct, ct_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), atol=2e-2)


def _layer_params(jlayer, n_in, seed):
    """JAX-initialised params as numpy f32, shared by both layers."""
    import jax
    p = jlayer.init(jax.random.PRNGKey(seed), JI.RecurrentType(n_in, T), jnp.float32)
    return {k: np.array(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("h", [32, 100])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_layer_matches_jax_scan_path(b, h, mask, peephole):
    n_in = 7
    jcls, tcls = (JL.GravesLSTM, TL.GravesLSTM) if peephole else (JL.LSTM, TL.LSTM)
    jlayer, tlayer = jcls(n_out=h), tcls(n_out=h)
    params = _layer_params(jlayer, n_in, seed=h + b)
    rs = np.random.RandomState(b * 100 + h)
    x = (0.5 * rs.randn(b, T, n_in)).astype(np.float32)
    m = None
    if mask:
        lens = rs.randint(1, T + 1, size=b)
        m = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    y_j, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                          jnp.asarray(x), mask=None if m is None else jnp.asarray(m))
    y_t, _ = tlayer.apply({k: torch.from_numpy(v) for k, v in params.items()}, {},
                          torch.from_numpy(x), mask=_torch(m))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_step_stateful_matches_jax():
    jlayer, tlayer = JL.GravesLSTM(n_out=16), TL.GravesLSTM(n_out=16)
    params = _layer_params(jlayer, 6, seed=3)
    rs = np.random.RandomState(3)
    x_t = rs.randn(2, 6).astype(np.float32)
    hc = (0.1 * rs.randn(2, 16)).astype(np.float32), (0.1 * rs.randn(2, 16)).astype(np.float32)
    (h_j, c_j), _ = jlayer.step_stateful({k: jnp.asarray(v) for k, v in params.items()},
                                         tuple(jnp.asarray(a) for a in hc), jnp.asarray(x_t))
    (h_t, c_t), _ = tlayer.step_stateful({k: torch.from_numpy(v) for k, v in params.items()},
                                         tuple(torch.from_numpy(a) for a in hc),
                                         torch.from_numpy(x_t))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    plain = ops.lstm_seq_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "lstm_seq_plain", spy)
    monkeypatch.setattr(ops, "launches", 0)
    layer = TL.GravesLSTM(n_out=8)
    params = layer.init(torch.Generator().manual_seed(0), TI.RecurrentType(4, 3))
    y, _ = layer.apply(params, {}, torch.zeros(2, 3, 4))
    assert y.shape == (2, 3, 8)
    assert calls == [(3, 2, 32)]
    assert ops.launches == 0


def test_other_activations_take_the_step_loop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a hardtanh LSTM must not reach lstm_seq")

    monkeypatch.setattr(ops, "lstm_seq", refuse)
    jlayer = JL.LSTM(n_out=8, activation="hardtanh")
    tlayer = TL.LSTM(n_out=8, activation="hardtanh")
    params = _layer_params(jlayer, 4, seed=5)
    x = np.random.RandomState(5).randn(2, T, 4).astype(np.float32)
    y_j, _ = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()}, {}, jnp.asarray(x))
    y_t, _ = tlayer.apply({k: torch.from_numpy(v) for k, v in params.items()}, {},
                          torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_kernel_wrapper_validates_inputs(bad):
    xz, wh, h0, c0, _, _ = (_torch(a) for a in _inputs(2, 8, False, False))
    if bad == "dtype":
        xz, err = xz.double(), TypeError
    elif bad == "shape":
        wh, err = wh[:, :16].contiguous(), ValueError
    else:
        wh, err = wh.t().contiguous().t(), ValueError
    with pytest.raises(err):
        ops._check(xz, wh, h0, c0, None, None)
