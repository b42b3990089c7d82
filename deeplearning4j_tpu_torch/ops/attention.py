"""Flash attention: the hand-written Hopper forward kernel, its plain
version, and a blockwise backward.

Replaces the TPU kernel ``_attn_kernel`` of
``deeplearning4j_tpu/ops/attention_pallas.py`` (driven by ``_run_fwd``),
with the contract of that module's ``flash_attention``: self-attention over
``[B, T, H, D]`` q, k, v, an optional ``[B, T]`` key mask (1 = valid)
shared by the heads, causal masking, f32 softmax state, products in the
input dtype with f32 accumulation, fully masked rows emitting 0.

- ``flash_attention_fwd`` returns ``(out [B,T,H,D], lse [B,H,T] f32)``: on
  CUDA tensors it launches ``csrc/flash_attn.cu`` (f32 or bf16, D <= 128),
  on CPU tensors it takes ``flash_attention_plain``. ``launches`` counts the
  kernel launches.
- ``flash_attention`` is the differentiable entry point (one
  ``torch.autograd.Function``): its forward is ``flash_attention_fwd`` and
  keeps ``lse``; its backward is the port of the JAX package's
  ``_bwd_core``, which XLA compiles there (it is not a Pallas kernel), so
  here it is PyTorch over blocks of ``BLOCK_K`` keys, recomputing the
  probabilities from ``lse``: memory O(B·H·T·Bk), never O(T²). The mask
  gets no gradient.

What bounds the kernel on an H100, and its design, are in the CUDA
source's header.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from deeplearning4j_tpu_torch.ops import _build

SOURCE = _build.CSRC / "flash_attn.cu"

#: the masked-score sentinel and the lse of a fully masked row
NEG_INF = -1e30
#: keys per block of the backward (the JAX package's default block)
BLOCK_K = 512

#: kernel launches (wrapper calls that reached the CUDA kernel)
launches = 0
_count_lock = threading.Lock()

_ENTRY_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 5
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _declare(lib):
    for name in ("flash_attn_fwd_f32", "flash_attn_fwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = _ENTRY_ARGS
        fn.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


_LIB = _build.Library(SOURCE, _declare)


def build():
    """Compile ``csrc/flash_attn.cu`` unless built; returns the library path."""
    return _LIB.build()


def _scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _valid(b, t, mask, causal, device, rows=None, cols=None):
    """[B or 1, 1, rows, cols] bool: key inside the mask and, when causal,
    not after the query row. ``rows``/``cols`` are index ranges."""
    rows = torch.arange(t, device=device) if rows is None else rows
    cols = torch.arange(t, device=device) if cols is None else cols
    valid = torch.ones((1, 1, 1, cols.numel()), dtype=torch.bool, device=device)
    if mask is not None:
        valid = (mask[:, cols] > 0)[:, None, None, :]
    if causal:
        valid = valid & (cols[None, :] <= rows[:, None])[None, None]
    return valid


def flash_attention_plain(q, k, v, *, mask=None, causal=False, scale=None):
    """The kernel's function in plain PyTorch: ``(out [B,T,H,D] in q's dtype,
    lse [B,H,T] f32)``. Scores in f32 from operands in their own dtype, the
    probabilities rounded to v's dtype before the PV product, as the kernel
    does; a fully masked row emits 0 with lse = ``NEG_INF``. It holds the
    whole [B,H,T,T] score tensor: a reference, not a fast path."""
    b, t, _, d = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * _scale(scale, d)
    valid = _valid(b, t, mask, causal, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), vh) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _check(q, k, v, mask):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attn kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    b, t, h, d = q.shape
    if d > 128 or min(b, t, h, d) < 1 or b * h > 65535:
        raise ValueError(f"flash_attn kernel takes 1 <= D <= 128 and B*H <= 65535, "
                         f"got {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"{name} must match q's shape {tuple(q.shape)} "
                             f"(self-attention), got {tuple(x.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"{name} is {x.dtype} on {x.device}, q is {q.dtype} on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s feature axis must be contiguous, strides {x.stride()}")
    if mask is not None and (tuple(mask.shape) != (b, t) or mask.device != q.device):
        raise ValueError(f"mask must be [B, T] = {(b, t)} on {q.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")


def flash_attention_fwd(q, k, v, *, mask=None, causal=False, scale=None):
    """``(out [B,T,H,D], lse [B,H,T] f32)``: the Hopper kernel on CUDA
    tensors, ``flash_attention_plain`` on CPU tensors."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask=mask, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, mask)
    lib = _LIB.get()
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    maskf = None if mask is None else mask.to(torch.float32).contiguous()
    fn = lib.flash_attn_fwd_f32 if q.dtype == torch.float32 else lib.flash_attn_fwd_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if maskf is None else maskf.data_ptr(), out.data_ptr(), lse.data_ptr(),
             q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), b, h, t, d, int(bool(causal)),
             _scale(scale, d), _build.device_index(q.device),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err} ({msg})")
    with _count_lock:
        launches += 1
    return out, lse


def _mm(a, b, dtype):
    """a @ b with both operands rounded to ``dtype`` and the products summed
    in f32 (the JAX package's ``preferred_element_type`` einsums)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def flash_attention_bwd(q, k, v, mask, out, lse, g, *, causal, scale, block_k=BLOCK_K):
    """dq, dk, dv for ``flash_attention``: the port of ``_bwd_core``. Key
    blocks of ``block_k`` recompute P = exp(S - lse) one [B,H,T,Bk] tile at
    a time; invalid entries are set to exactly 0 before use (on a fully
    masked row lse is the sentinel and exp(S - lse) would be ~1). Under
    causal masking a key block's rows above its first key contribute
    nothing, so they are skipped. All [B,T,H,D] in and out."""
    dt = q.dtype
    b, t, h, d = q.shape
    qh, kh, vh, oh = (x.permute(0, 2, 1, 3) for x in (q, k, v, out))
    gh = g.to(dt).permute(0, 2, 1, 3)
    delta = (gh.float() * oh.float()).sum(dim=-1, keepdim=True)          # [B,H,T,1]
    dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
    rows_all = torch.arange(t, device=q.device)
    with torch.profiler.record_function("flash_attn.backward"):
        for c0 in range(0, t, block_k):
            c1 = min(c0 + block_k, t)
            r0 = c0 if causal else 0
            rows, cols = rows_all[r0:], rows_all[c0:c1]
            k_j, v_j = kh[:, :, c0:c1], vh[:, :, c0:c1]
            q_i, g_i = qh[:, :, r0:], gh[:, :, r0:]
            s = _mm(q_i, k_j.transpose(-1, -2), dt) * scale                 # [B,H,R,Bk]
            valid = _valid(b, t, mask, causal, q.device, rows=rows, cols=cols)
            p = torch.where(valid, torch.exp(s - lse[:, :, r0:, None]), torch.zeros_like(s))
            dv[:, :, c0:c1] = _mm(p.transpose(-1, -2), g_i, dt)
            dp = _mm(g_i, v_j.transpose(-1, -2), dt)
            ds = p * (dp - delta[:, :, r0:])
            dq[:, :, r0:] += _mm(ds, k_j, dt) * scale
            dk[:, :, c0:c1] = _mm(ds.transpose(-1, -2), q_i, dt) * scale
    return tuple(x.permute(0, 2, 1, 3).to(dt) for x in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.causal, ctx.scale = mask, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, ctx.mask, out, lse, g,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, mask=None, causal=False, scale=None):
    """Differentiable flash attention over [B, T, H, D] self-attention
    inputs (the JAX package's ``ops.attention_pallas.flash_attention``
    contract). ``mask``: optional [B, T] key mask (1 = valid); it gets no
    gradient. Fully masked query rows emit 0."""
    if mask is not None:
        mask = mask.detach()
    return _FlashAttention.apply(q, k, v, mask, bool(causal), _scale(scale, q.shape[-1]))
