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
    hs, cs, ht, ct, _, _ = ops.lstm_seq_plain(_torch(xz), _torch(wh), _torch(h0),
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
    hs, _, ht, ct, _, _ = ops.lstm_seq_plain(_torch(xz, tb), _torch(wh, tb), _torch(h0, tb),
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


# ---------------------------------------------------------------------------
# the backward: lstm_seq_bwd against the JAX package's custom VJP (_bwd),
# the autograd.Function in float64, and the final f32 state
# ---------------------------------------------------------------------------

def _cotangents(b, h, final, seed):
    rs = np.random.RandomState(seed)
    f32 = np.float32
    dhs = rs.randn(T, b, h).astype(f32)
    if not final:
        return dhs, None, None
    return dhs, rs.randn(b, h).astype(f32), rs.randn(b, h).astype(f32)


def _jax_vjp(xz, wh, h0, c0, wp, m, dhs, dht, dct, dtype=jnp.float32):
    """(dxz, dwh, dwp, dh0, dc0) of the Pallas sequence op (interpret mode)."""
    import jax

    def f(xz, wh, h0, c0, wp):
        return lstm_pallas.fused_sequence_padded(xz, wh, h0, c0, wp=wp, mask=_jax(m),
                                                 interpret=True)
    args = [_jax(a, dtype) for a in (xz, wh, h0, c0, wp)]
    (hs, (ht, ct)), vjp = jax.vjp(f, *args)
    zeros = jnp.zeros(ht.shape, ht.dtype)
    ct_ = (_jax(dhs, hs.dtype), (zeros if dht is None else _jax(dht, ht.dtype),
                                 zeros if dct is None else _jax(dct, ct.dtype)))
    dxz, dwh, dh0, dc0, dwp = vjp(ct_)
    return dxz, dwh, dwp, dh0, dc0


_GRADS = ("dxz", "dwh", "dwp", "dh0", "dc0")


@pytest.mark.parametrize("final", [False, True], ids=["dhs", "dhs+dhT+dcT"])
@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_bwd_matches_jax_custom_vjp(mask, peephole, final):
    """f32 at atol 2e-5, rtol 2e-4: the same sums as the JAX scan in
    another order (the gate recompute as one product over all steps)."""
    b, h = 3, 8
    xz, wh, h0, c0, wp, m = _inputs(b, h, peephole, mask, seed=7)
    dhs, dht, dct = _cotangents(b, h, final, seed=8)
    want = _jax_vjp(xz, wh, h0, c0, wp, m, dhs, dht, dct)
    fwd = ops.lstm_seq_plain(_torch(xz), _torch(wh), _torch(h0), _torch(c0), wp=_torch(wp),
                             mask=_torch(m))
    got = ops.lstm_seq_bwd(_torch(xz), _torch(wh), _torch(wp), _torch(h0), _torch(c0),
                           _torch(m), fwd.hs, fwd.cs, _torch(dhs), _torch(dht), _torch(dct))
    for name, g, w in zip(_GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-4,
                                   err_msg=name)


def test_bwd_matches_jax_custom_vjp_bf16():
    """bf16 operands (the mixed policy's kernel branch): both round dz to
    bf16 before the products and keep dh in f32, so they differ only where
    a bf16 rounding of hs or dz lands on the other side of a tie between
    two summation orders: atol 2e-2 + rtol 2e-2 (one bf16 ulp is 2^-8
    relative), and dxz comes back in bf16."""
    b, h = 4, 32
    xz, wh, h0, c0, wp, m = _inputs(b, h, True, True, seed=9)
    dhs, dht, dct = _cotangents(b, h, True, seed=10)
    bf, tb = jnp.bfloat16, torch.bfloat16
    want = _jax_vjp(xz, wh, h0, c0, wp, m, dhs, dht, dct, dtype=bf)
    args = [_torch(a, tb) for a in (xz, wh, wp, h0, c0)]
    fwd = ops.lstm_seq_plain(args[0], args[1], args[3], args[4], wp=args[2], mask=_torch(m))
    got = ops.lstm_seq_bwd(*args, _torch(m), fwd.hs, fwd.cs, _torch(dhs, tb), _torch(dht),
                           _torch(dct))
    assert got[0].dtype == torch.bfloat16
    for name, g, w in zip(_GRADS, got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("peephole,mask", [(False, False), (True, False), (True, True)])
def test_lstm_function_gradcheck_float64(peephole, mask):
    """The autograd.Function (plain forward on CPU tensors, lstm_seq_bwd
    backward) against finite differences in float64, every output's
    cotangent included (hs, cs and the final state)."""
    xz, wh, h0, c0, wp, m = _inputs(2, 3, peephole, mask, seed=12)
    f64 = torch.float64
    args = [None if a is None else _torch(a, f64).requires_grad_(True)
            for a in (xz, wh, wp, h0, c0)]
    mask_t = _torch(m, f64)
    assert torch.autograd.gradcheck(
        lambda xz, wh, wp, h0, c0: ops.LstmSeqFunction.apply(xz, wh, wp, h0, c0, mask_t),
        args, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_final_state_is_kept_in_f32():
    """The f32 final state a caller carries: for bf16 operands h_state and
    c_state are the unrounded f32 values whose bf16 roundings are h_last and
    c_last; a run split in two from the carried state equals the whole run."""
    xz, wh, h0, c0, wp, _ = (_torch(a, torch.bfloat16) if a is not None else None
                             for a in _inputs(3, 16, True, False, seed=13))
    whole = ops.lstm_seq_plain(xz, wh, h0, c0, wp=wp)
    assert whole.h_state.dtype == whole.c_state.dtype == torch.float32
    assert torch.equal(whole.h_state.to(torch.bfloat16), whole.h_last)
    assert torch.equal(whole.c_state.to(torch.bfloat16), whole.c_last)
    first = ops.lstm_seq_plain(xz[:2], wh, h0, c0, wp=wp)
    second = ops.lstm_seq_plain(xz[2:], wh, first.h_state, first.c_state, wp=wp)
    assert torch.equal(torch.cat([first.hs, second.hs]), whole.hs)
    assert torch.equal(second.c_state, whole.c_state)


@pytest.mark.parametrize("b", [2, 8])
def test_graves_lstm_bf16_policy_pins_the_kernel_branch(b):
    """The port sends every sigmoid/tanh LSTM to lstm_seq in the compute
    dtype on every device: under bf16_policy its GravesLSTM forward and
    gradients match the JAX layer's kernel branch (Pallas in interpret
    mode, fed the same bf16 operands), which the JAX package takes on its
    accelerator, where its CPU scan branch keeps f32 (1.1e-3 apart at H=128,
    T=32). Tolerance: outputs atol 1e-2, two bf16 ulps of |y| < 1 (the two
    sum the recurrent product in different orders, and a rounding that
    lands on the other side of a tie moves a bf16 output by one ulp); each
    gradient within 5e-3 of its norm, a few such flips downstream. Both
    were equal to the bit in a CPU run."""
    import functools

    import jax
    from deeplearning4j_tpu.utils import dtypes as jdt
    from deeplearning4j_tpu_torch.utils import dtypes as tdt

    h, n_in = 32, 6
    jlayer, tlayer = JL.GravesLSTM(n_out=h), TL.GravesLSTM(n_out=h)
    params = _layer_params(jlayer, n_in, seed=20 + b)
    rs = np.random.RandomState(b)
    x = (0.5 * rs.randn(b, T, n_in)).astype(np.float32)
    g = rs.randn(b, T, h).astype(np.float32)
    orig = lstm_pallas.fused_sequence_padded
    eligible = JL.GravesLSTM._fused_eligible
    jdt.bf16_policy()
    tdt.bf16_policy()
    try:
        lstm_pallas.fused_sequence_padded = functools.partial(orig, interpret=True)
        JL.GravesLSTM._fused_eligible = lambda self, x, mask: True

        def jloss(p):
            y, _ = jlayer.apply(p, {}, jnp.asarray(x))
            return jnp.sum(y.astype(jnp.float32) * g), y

        (_, y_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()})
        tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
        y_t, _ = tlayer.apply(tp, {}, torch.from_numpy(x))
        (y_t.float() * torch.from_numpy(g)).sum().backward()
    finally:
        lstm_pallas.fused_sequence_padded = orig
        JL.GravesLSTM._fused_eligible = eligible
        jdt.f32_policy()
        tdt.f32_policy()
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(y_t.float().detach().numpy(),
                               np.asarray(y_j.astype(jnp.float32)), atol=1e-2, rtol=0)
    for k, v in tp.items():
        want = np.asarray(g_j[k], np.float32)
        err = np.linalg.norm(v.grad.numpy() - want) / np.linalg.norm(want)
        assert err <= 5e-3, (k, err)
