"""The port's flash attention and attention layers against the JAX package.

``flash_attention_plain`` (the plain version the CUDA kernel is held
against on the card) is compared with the Pallas flash kernel run in
interpret mode, its autograd backward with ``jax.grad`` through the JAX
custom VJP, and the port's ``dot_product_attention``, ``MultiHeadAttention``
and ``TransformerBlock`` (flash branch forced with ``min_seq``, and the
naive branch) with the JAX layers, on the same numpy inputs.

Tolerances: forward atol 1e-5 (the reference's own f32 kernel tolerance,
tests/test_ops.py); gradients atol 2e-5 (the same sums in another order
and block size); bf16 operands 2e-2 (one bf16 ulp near 1 is 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import attention as JA
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.ops import attention_pallas as jfa
from deeplearning4j_tpu.utils import dtypes as jdt
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.layers import attention as TA
from deeplearning4j_tpu_torch.ops import attention as tfa
from deeplearning4j_tpu_torch.utils import dtypes as tdt

B, H, D = 2, 2, 16


def _qkv(t, seed, b=B, h=H, d=D):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _mask(t, seed, b=B):
    """Ragged key lengths, with the last batch row fully masked."""
    rs = np.random.RandomState(seed + 1)
    lens = rs.randint(1, t + 1, size=b)
    lens[-1] = 0
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [(t, causal, masked) for t in (100, 256) for causal in (False, True)
         for masked in (False, True)]


@pytest.mark.parametrize("t,causal,masked", CASES)
def test_plain_matches_pallas_kernel(t, causal, masked):
    q, k, v = _qkv(t, seed=t)
    m = _mask(t, t) if masked else None
    fold = [jfa._fold_heads(_j(a)) for a in (q, k, v)]
    scale = float(1.0 / np.sqrt(D))
    out_j, lse_j = jfa._run_fwd(*fold, _j(m), H, causal, scale, 128, 128, True)
    out_t, lse_t = tfa.flash_attention_plain(_t(q), _t(k), _t(v), mask=_t(m), causal=causal)
    np.testing.assert_allclose(out_t.numpy(),
                               np.asarray(jfa._unfold_heads(out_j, B, H)), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j).reshape(B, H, t),
                               atol=1e-5, rtol=1e-6)
    if masked:  # the fully masked row: zeros out, the lse sentinel
        assert not out_t[-1].any()
        assert torch.all(lse_t[-1] == tfa.NEG_INF)


def test_plain_matches_pallas_kernel_bf16():
    t = 100
    q, k, v = _qkv(t, seed=5)
    m = _mask(t, 5)
    bf = jnp.bfloat16
    out_j = jfa.flash_attention(*(jnp.asarray(a, bf) for a in (q, k, v)), mask=_j(m),
                                causal=True, block_q=128, block_k=128, interpret=True)
    out_t, _ = tfa.flash_attention_plain(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                                         mask=_t(m), causal=True)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def _jax_grads(q, k, v, m, causal, g):
    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, mask=_j(m), causal=causal, block_q=128,
                                  block_k=128, interpret=True)
        return jnp.sum(out * _j(g))
    return jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))


@pytest.mark.parametrize("t,causal,masked", CASES)
def test_backward_matches_jax_grad(t, causal, masked):
    q, k, v = _qkv(t, seed=t + 7)
    m = _mask(t, t) if masked else None
    g = np.random.RandomState(t).randn(B, t, H, D).astype(np.float32)
    want = _jax_grads(q, k, v, m, causal, g)
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, mask=_t(m), causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), _t(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("block_k", [32, 64, 1000])
@pytest.mark.parametrize("causal,masked", [(True, True), (False, True), (True, False)])
def test_blockwise_backward_matches_plain_autograd(block_k, causal, masked):
    """The backward over key blocks of any size equals autograd through the
    whole-matrix plain version (the comparison chip_smoke makes on the card)."""
    t = 100
    q, k, v = _qkv(t, seed=block_k)
    m = _t(_mask(t, block_k)) if masked else None
    g = _t(np.random.RandomState(1).randn(B, t, H, D).astype(np.float32))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    out, lse = tfa.flash_attention_plain(qt, kt, vt, mask=m, causal=causal)
    want = torch.autograd.grad(out, (qt, kt, vt), g)
    got = tfa.flash_attention_bwd(qt.detach(), kt.detach(), vt.detach(), m, out.detach(),
                                  lse.detach(), g, causal=causal, scale=1.0 / np.sqrt(D),
                                  block_k=block_k)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
        assert torch.isfinite(a).all()


def test_mask_gets_no_gradient_and_cpu_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(tfa, "launches", 0)
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(64, seed=3))
    m = _t(_mask(64, 3)).requires_grad_(True)
    out = tfa.flash_attention(q, k, v, mask=m, causal=True)
    out.sum().backward()
    assert m.grad is None and q.grad is not None
    assert tfa.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "cross_length", "mask", "stride"])
def test_kernel_wrapper_validates_inputs(bad):
    q, k, v = (_t(a) for a in _qkv(16, seed=0))
    m = None
    if bad == "dtype":
        q, k, v = (a.double() for a in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(B, 16, H, 129) for _ in range(3))
    elif bad == "cross_length":
        k = k[:, :8]
    elif bad == "mask":
        m = torch.ones(B, 8)
    else:
        q = q.transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        tfa._check(q, k, v, m)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_dot_product_attention_matches_jax(flash, masked, causal):
    t = 64
    q, k, v = _qkv(t, seed=11)
    m = _mask(t, 11) if masked else None
    want = JA.dot_product_attention(_j(q), _j(k), _j(v), mask=_j(m), causal=causal)
    got = TA.dot_product_attention(_t(q), _t(k), _t(v), mask=_t(m), causal=causal,
                                   min_seq=0 if flash else 1 << 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_resolve_attention_gates(monkeypatch):
    shape = (2, 2048, 8, 64)
    f32 = torch.float32
    assert TA.resolve_attention(shape, shape, None, f32)
    assert TA.resolve_attention(shape, shape, torch.ones(2, 2048), torch.bfloat16)
    assert not TA.resolve_attention(shape, (2, 1024, 8, 64), None, f32)      # cross-length
    assert not TA.resolve_attention((2, 2048, 8, 256), (2, 2048, 8, 256), None, f32)
    assert not TA.resolve_attention(shape, shape, None, torch.float64)
    assert not TA.resolve_attention(shape, shape, torch.ones(2, 8, 2048, 2048), f32)
    short = (2, TA.MIN_SEQ - 1, 8, 64)
    assert not TA.resolve_attention(short, short, None, f32)
    assert TA.resolve_attention(short, short, None, f32, min_seq=1)
    monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", "1")
    assert TA.resolve_attention(short, short, None, f32)
    monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", "not-a-number")
    assert not TA.resolve_attention(short, short, None, f32)


def _tree_np(p):
    return {k: _tree_np(v) if isinstance(v, dict) else np.array(v, np.float32)
            for k, v in p.items()}


def _tree_t(p):
    return {k: _tree_t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in p.items()}


def _tree_j(p):
    return {k: _tree_j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("layer", ["mha", "block"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_layers_match_jax(layer, masked, flash, monkeypatch):
    t, f = 48, 32
    if layer == "mha":
        jl = JA.MultiHeadAttention(n_out=f, n_heads=2, causal=True)
        tl = TA.MultiHeadAttention(n_out=f, n_heads=2, causal=True)
    else:
        jl = JA.TransformerBlock(n_out=f, n_heads=2, causal=True)
        tl = TA.TransformerBlock(n_out=f, n_heads=2, causal=True)
    params = _tree_np(jl.init(jax.random.PRNGKey(1), JI.RecurrentType(f, t), jnp.float32))
    rs = np.random.RandomState(2)
    x = rs.randn(2, t, f).astype(np.float32)
    m = _mask(t, 2) if masked else None
    monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", "0" if flash else "100000")
    y_j, _ = jl.apply(_tree_j(params), {}, _j(x), mask=_j(m))
    y_t, _ = tl.apply(_tree_t(params), {}, _t(x), mask=_t(m))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_layer_normalization_matches_jax():
    x = (3.0 + 2.0 * np.random.RandomState(4).randn(3, 5, 12)).astype(np.float32)
    rs = np.random.RandomState(5)
    params = {"gamma": rs.randn(12).astype(np.float32), "beta": rs.randn(12).astype(np.float32)}
    y_j, _ = JA.LayerNormalization(eps=1e-3).apply(_tree_j(params), {}, _j(x))
    y_t, _ = TA.LayerNormalization(eps=1e-3).apply(_tree_t(params), {}, _t(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_layer_normalization_on_a_convolutional_input_matches_jax():
    """On a convolutional input the layer normalizes over the channels:
    gamma and beta of shape (channels,), as the JAX layer's ``_nfeat``."""
    in_j, in_t = JI.ConvolutionalType(4, 4, 8), TI.ConvolutionalType(4, 4, 8)
    p_j = JA.LayerNormalization().init(jax.random.PRNGKey(0), in_j, jnp.float32)
    p_t = TA.LayerNormalization().init(torch.Generator().manual_seed(0), in_t)
    assert {k: v.shape for k, v in p_t.items()} == {k: v.shape for k, v in p_j.items()} \
        == {"gamma": (8,), "beta": (8,)}
    rs = np.random.RandomState(6)
    x = (1.0 + rs.randn(2, 4, 4, 8)).astype(np.float32)  # NHWC
    params = {"gamma": rs.randn(8).astype(np.float32), "beta": rs.randn(8).astype(np.float32)}
    y_j, _ = JA.LayerNormalization().apply(_tree_j(params), {}, _j(x))
    y_t, _ = TA.LayerNormalization().apply(_tree_t(params), {}, _t(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_bf16_policy_leaves_f32_qkv_at_attention(monkeypatch):
    """Under bf16_policy the projection returns the accumulation dtype, so
    attention sees f32 q, k, v in both packages: the JAX flash path takes
    them as they come while its naive path rounds them to bf16."""
    seen = {}

    def spy_j(q, k, v, **kw):
        seen["jax"] = q.dtype
        return jnp.zeros(q.shape, q.dtype)

    def spy_t(q, k, v, **kw):
        seen["torch"] = q.dtype
        return torch.zeros(q.shape, dtype=q.dtype)

    monkeypatch.setattr(JA, "dot_product_attention", spy_j)
    monkeypatch.setattr(TA, "dot_product_attention", spy_t)
    f, t = 16, 8
    jl = JA.MultiHeadAttention(n_out=f, n_heads=2)
    params = _tree_np(jl.init(jax.random.PRNGKey(0), JI.RecurrentType(f, t), jnp.float32))
    x = np.random.RandomState(0).randn(2, t, f).astype(np.float32)
    try:
        jdt.bf16_policy()
        tdt.bf16_policy()
        jl.apply(_tree_j(params), {}, _j(x))
        TA.MultiHeadAttention(n_out=f, n_heads=2).apply(_tree_t(params), {}, _t(x))
    finally:
        jdt.set_policy(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                       accum_dtype=jnp.float32)
        tdt.f32_policy()
    assert seen == {"jax": jnp.float32, "torch": torch.float32}
