"""Flash attention: the hand-written Hopper forward kernel, its plain
version, and a blockwise backward.

Replaces the TPU kernel ``_attn_kernel`` of
``deeplearning4j_tpu/ops/attention_pallas.py`` (driven by ``_run_fwd``),
with the contract of that module's ``flash_attention``: self-attention over
``[B, T, H, D]`` q, k, v, an optional ``[B, T]`` key mask (1 = valid)
shared by the heads, causal masking, f32 softmax state, products in the
input dtype with f32 accumulation, fully masked rows emitting 0.

- ``flash_attention_fwd`` returns ``(out [B,T,H,D], lse [B,H,T] f32)``: on
  CUDA tensors it launches ``csrc/flash_attn.cu`` (f32 or bf16, D <= 128)
  on the variant ``plan()`` names from the shape, strides, dtype and
  alignment (``launch_plan``: a tuning DB's winner where one is bound,
  ``tuning/``); on CPU tensors it takes ``flash_attention_plain``.
  ``launches`` counts the kernel launches, ``launches_by_variant`` the same
  launches by variant:

  - ``f32_3xtf32_wgmma`` (D <= 64) and ``f32_3xtf32`` (D <= 128): tensor
    cores with every operand split into two TF32 halves and each product
    taken as lo.hi + hi.lo + hi.hi, which keeps the f32 contract (out
    within 1e-5); one-pass TF32 would not, and is never used on f32
    inputs. The first runs ``wgmma`` on halves split into shared memory
    (V transposed: TF32 ``wgmma`` reads only K-major operands), the second
    ``mma.sync``; K and V stream through a ``cp.async`` ring.
    ``f32_3xtf32_unaligned``: the ``mma.sync`` body with 4-byte copies, for
    views whose pointers or strides are off 16 bytes.
  - ``bf16_wgmma``: TMA ring over 4-D tensor maps of the views, ``wgmma``
    for both products, P fed from registers. ``bf16_unaligned``: the
    ``mma.sync`` body in one TF32 pass, exact on bf16 operands.

  ``tf32_round`` and ``matmul_3xtf32`` emulate the split on the CPU, for
  the tests that hold its accuracy.
- ``flash_attention`` is the differentiable entry point (one
  ``torch.autograd.Function``, whose ``out`` it returns): its forward is
  ``flash_attention_fwd`` and keeps ``lse``; its backward is the port of the JAX package's
  ``_bwd_core``, which XLA compiles there (it is not a Pallas kernel), so
  here it is PyTorch over blocks of ``BLOCK_K`` keys, recomputing the
  probabilities from ``lse``: memory O(B·H·T·Bk), never O(T²). The mask
  gets no gradient.
- ``flash_attention_block`` is the block entry of ring attention
  (``parallel/sequence.py``): the same Function, returning ``lse`` too as
  a second differentiable output whose cotangent the backward takes.

What bounds the kernel on an H100, and its design, are in the CUDA
source's header.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.ops import _build, _plans

SOURCE = _build.CSRC / "flash_attn.cu"

#: the masked-score sentinel and the lse of a fully masked row
NEG_INF = -1e30
#: keys per block of the backward (the JAX package's default block)
BLOCK_K = 512

#: kernel launches (wrapper calls that reached the CUDA kernel)
launches = 0
#: the same launches by kernel variant (``plan().variant``)
VARIANTS = ("f32_3xtf32", "f32_3xtf32_unaligned", "bf16_wgmma", "bf16_unaligned",
            "f32_3xtf32_wgmma")
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def _declare(lib):
    lib.flash_attn_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                                      + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attn_launch.restype = ctypes.c_int
    lib.flash_attn_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attn_smem_bytes.restype = ctypes.c_int
    lib.flash_attn_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_attn_occupancy.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


_LIB = _build.Library(SOURCE, _declare)


def build():
    """Compile ``csrc/flash_attn.cu`` unless built; returns the library path."""
    return _LIB.build()


def reset_launches():
    global launches
    launches = 0
    for k in launches_by_variant:
        launches_by_variant[k] = 0


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

#: shared memory one block may take on sm_90 (bytes)
SMEM_LIMIT = 232_448

# the compiled configurations of csrc/flash_attn.cu (its constants, mirrored):
# the mma.sync body takes 8 warps of 16 query rows at DP = 64, with K and V
# split once a tile in shared memory, and 4 warps at DP = 128, without
MMA_KEYS = 64
MMA_WARPS = {64: 8, 128: 4}
WG_ROWS, WG_KEYS, WG_THREADS = 128, 64, 288
WG_STAGES = {64: 8, 128: 5}  # the K/V ring's depth by feature width
# f32_3xtf32_wgmma (DP = 64 only): two warpgroups of 64 rows; Q, K and V^T
# halves in 128-byte swizzled boxes, a 2-stage raw ring of rows of 68 floats
TF_ROWS, TF_KEYS, TF_THREADS = 128, 64, 256
WIDTHS = (64, 128)


class Plan(NamedTuple):
    """How one call runs: the kernel variant, the feature width ``dp`` it is
    compiled for (D rides it with a zero-filled tail), query rows and keys
    per tile, ring depth, threads and grid (query tiles, B*H) of a block,
    and the block's shared memory."""
    variant: str
    dp: int
    block_q: int
    block_k: int
    stages: int
    threads: int
    grid: tuple
    smem_bytes: int


def smem_bytes(variant, dp):
    """Shared memory (bytes) of one block of ``variant`` at feature width
    ``dp``, as ``csrc/flash_attn.cu`` lays it out."""
    if variant == "bf16_wgmma":
        nb = dp // 64
        return (nb * WG_ROWS * 128 + WG_STAGES[dp] * 2 * nb * WG_KEYS * 128
                + (1 + 2 * WG_STAGES[dp]) * 8 + 1024)
    if variant == "f32_3xtf32_wgmma":  # Q, K, V^T halves; raw ring; valid flags; slack
        return (2 * 2 * TF_ROWS * 128 + 2 * 2 * 2 * TF_KEYS * 128 + 2 * 2 * TF_KEYS * 68 * 4
                + 2 * TF_KEYS * 4 + 1024)
    ld, rows = dp + 4, 16 * MMA_WARPS[dp]
    presplit = MMA_WARPS[dp] == 8
    return 4 * (2 * rows * ld + (6 if presplit else 4) * MMA_KEYS * ld + 2 * MMA_KEYS)


def _width(d):
    return next(w for w in WIDTHS if d <= w)


def _flat_strides(shape, strides):
    b, t, h, d = shape
    if strides is None:
        strides = ((t * h * d, h * d, d),) * 3
    return strides, [s for triple in strides for s in triple]


def _assemble(variant, d, t, b, h):
    if variant == "bf16_wgmma":
        dp = _width(d)
        rows, keys, stages, threads = WG_ROWS, WG_KEYS, WG_STAGES[dp], WG_THREADS
    elif variant == "f32_3xtf32_wgmma":
        dp = 64
        rows, keys, stages, threads = TF_ROWS, TF_KEYS, 2, TF_THREADS
    else:
        # f32_3xtf32 is compiled at DP = 128 only: a narrower D rides it zero-filled
        dp = 128 if variant == "f32_3xtf32" else _width(d)
        rows, keys, stages, threads = 16 * MMA_WARPS[dp], MMA_KEYS, 2, 32 * MMA_WARPS[dp]
    return Plan(variant, dp, rows, keys, stages, threads, (-(-t // rows), b * h),
                smem_bytes(variant, dp))


@functools.lru_cache(maxsize=None)
def plan(shape, dtype, strides=None, aligned=True):
    """The launch of one flash forward: ``shape`` (B, T, H, D), ``dtype``
    float32 or bfloat16, ``strides`` the (batch, time, head) element
    strides of q, k and v (three triples; None: each contiguous), and
    ``aligned`` whether q, k and v start on 16 bytes. f32 takes
    ``f32_3xtf32_wgmma`` (D <= 64) or ``f32_3xtf32`` (D > 64) where the
    pointers are aligned and D and every stride are multiples of 4 elements
    (16 bytes), else ``f32_3xtf32_unaligned``;
    bf16 takes ``bf16_wgmma`` where the pointers are aligned and every
    stride is a multiple of 8 elements and the strides nest (head inside
    time inside batch, as TMA's maps walk them), else ``bf16_unaligned``.
    The hand-picked plan: ``launch_plan`` gives a tuned one where a tuning
    DB is bound."""
    b, t, h, d = shape
    strides, flat = _flat_strides(shape, strides)
    if dtype == torch.float32:
        vec = aligned and d % 4 == 0 and all(s % 4 == 0 for s in flat)
        variant = (("f32_3xtf32_wgmma" if d <= 64 else "f32_3xtf32") if vec
                   else "f32_3xtf32_unaligned")
    elif dtype == torch.bfloat16:
        nested = all(sh >= d and st >= h * sh and sb >= t * st for sb, st, sh in strides)
        tma = aligned and nested and all(s % 8 == 0 for s in flat)
        variant = "bf16_wgmma" if tma else "bf16_unaligned"
    else:
        raise TypeError(f"flash_attn kernel takes float32 or bfloat16, got {dtype}")
    return _assemble(variant, d, t, b, h)


#: the variants of each dtype
DTYPE_VARIANTS = {torch.float32: ("f32_3xtf32_wgmma", "f32_3xtf32", "f32_3xtf32_unaligned"),
                  torch.bfloat16: ("bf16_wgmma", "bf16_unaligned")}


def config_of(pl):
    """The tunable field of a plan: its variant (``backend`` flash)."""
    return {"backend": "flash", "variant": pl.variant}


def configured(shape, dtype, strides, aligned, config):
    """The plan ``config`` ({"backend": "flash", "variant": v}) gives a
    call, or the reason it is refused: a variant of another dtype or one
    not compiled for D, or a call that breaks the variant's alignment or
    stride rule (16-byte pointers and strides for ``f32_3xtf32*`` and
    ``bf16_wgmma``, D a multiple of 4 for the f32 ones, nested strides for
    TMA's maps)."""
    b, t, h, d = shape
    variant = config.get("variant") if isinstance(config, dict) else None
    if not isinstance(config, dict) or config.get("backend", "flash") != "flash":
        return f"config: not a flash config: {config}"
    if variant not in DTYPE_VARIANTS.get(dtype, ()):
        return f"dtype: {dtype} takes variants {list(DTYPE_VARIANTS.get(dtype, ()))}, not {variant}"
    if not 1 <= d <= 128 or (variant == "f32_3xtf32_wgmma" and d > 64):
        return f"not compiled: {variant} takes D up to {64 if 'wgmma' in variant else 128}, D is {d}"
    strides, flat = _flat_strides(shape, strides)
    if variant in ("f32_3xtf32_wgmma", "f32_3xtf32"):
        if not (aligned and d % 4 == 0 and all(s % 4 == 0 for s in flat)):
            return f"alignment: {variant} needs 16-byte pointers, D and strides"
    if variant == "bf16_wgmma":
        nested = all(sh >= d and st >= h * sh and sb >= t * st for sb, st, sh in strides)
        if not (aligned and nested and all(s % 8 == 0 for s in flat)):
            return "alignment: bf16_wgmma needs 16-byte pointers and strides, nested"
    pl = _assemble(variant, d, t, b, h)
    if pl.smem_bytes > SMEM_LIMIT:
        return f"smem: {pl.smem_bytes} B exceeds the {SMEM_LIMIT} B a block may take"
    return pl


#: the tuning DB's verdicts by (shape, dtype, binding): resolve_attention's
#: and the plan's one lookup
_VERDICTS = {}
_plans.register(_VERDICTS)


def tuned_config(shape, dtype):
    """The bound tuning DB's config for attention at [B, T, H, D]
    ``shape`` (``{"backend": "plain"}`` or ``{"backend": "flash",
    "variant": ...}``), or None; one lookup per shape, dtype and binding."""
    db, token = _plans.binding_token()
    if db is None:
        return None
    dtype = _plans.dtype_name(dtype)
    key = (tuple(int(x) for x in shape), dtype, token)
    if key not in _VERDICTS:
        _VERDICTS[key] = db.lookup("attention", key[0], dtype)
    return _VERDICTS[key]


def _resolve(db, key):
    shape, dtype, strides, aligned = key
    dt = _plans.DTYPES[dtype]
    default = plan(shape, dt, strides, aligned)
    cfg = tuned_config(shape, dtype) if db is not None else None
    if cfg is not None and cfg.get("backend", "flash") == "flash":
        pl = configured(shape, dt, strides, aligned, cfg)
        if isinstance(pl, Plan):
            return config_of(pl), pl
    return config_of(default), default


def _configured_at(key, config):
    shape, dtype, strides, aligned = key
    return configured(shape, _plans.DTYPES[dtype], strides, aligned, config)


#: the plans of this library's calls, per call key and tuning-DB binding
PLANS = _plans.PlanCache("flash_attn", _resolve, _configured_at)


def plan_key(shape, dtype, strides=None, aligned=True):
    """The key ``PLANS`` keeps a call's plan under (``launch_plan``'s
    arguments)."""
    return (tuple(int(x) for x in shape), _plans.dtype_name(dtype),
            None if strides is None else tuple(tuple(int(s) for s in tr) for tr in strides),
            bool(aligned))


def launch_plan(shape, dtype, strides=None, aligned=True):
    """The plan a launch takes: ``plan()``'s, or with a tuning DB bound the
    tuned variant of the call's bucket (kernel id ``attention``, shape (B,
    T, H, D)) where it validates here; resolved once per call key and
    binding."""
    return PLANS.get(plan_key(shape, dtype, strides, aligned))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

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


def tf32_round(x):
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: the low 13
    of the 23 mantissa bits cleared, to nearest, ties away from zero (half
    an ulp added to the magnitude bits, whatever the sign)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b):
    """a @ b as the f32 kernel's tensor cores take it: each operand split
    into x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and the product
    as lo.hi + hi.lo + hi.hi, the TF32 products exact and the sums in f32
    (in that order). A CPU emulation for the tests of the split's
    accuracy; the port's forward never calls it."""
    def split(x):
        hi = tf32_round(x)
        return hi, tf32_round(x.float() - hi)
    (ah, al), (bh, bl) = split(a), split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

#: the dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)


def supported(shape, dtype):
    """Whether the kernel takes self-attention over [B, T, H, D] ``shape``
    in ``dtype``: float32 or bfloat16, 1 <= D <= 128, B*H <= 65535."""
    b, t, h, d = shape
    return dtype in DTYPES and 1 <= d <= 128 and min(b, t, h) >= 1 and b * h <= 65535


def _check(q, k, v, mask):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    if not supported(tuple(q.shape), q.dtype):
        raise (ValueError if q.dtype in DTYPES else TypeError)(
            f"flash_attn kernel takes float32 or bfloat16 with 1 <= D <= 128 and "
            f"B*H <= 65535, got {q.dtype} {tuple(q.shape)}")
    b, t, h, d = q.shape
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
    strides = tuple(tuple(x.stride()[:3]) for x in (q, k, v))
    pl = launch_plan(tuple(q.shape), q.dtype, strides,
                     all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    maskf = None if mask is None else mask.to(torch.float32).contiguous()
    err = lib.flash_attn_launch(
        VARIANTS.index(pl.variant), pl.dp, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if maskf is None else maskf.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *(s for triple in strides for s in triple), b, h, t, d, int(bool(causal)),
        _scale(scale, d), _build.device_index(q.device),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn kernel launch failed ({pl}): CUDA error {err} ({msg})")
    with _count_lock:
        launches += 1
        launches_by_variant[pl.variant] += 1
    return out, lse


def _mm(a, b, dtype):
    """a @ b with both operands rounded to ``dtype`` and the products summed
    in f32 (the JAX package's ``preferred_element_type`` einsums)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def flash_attention_bwd(q, k, v, mask, out, lse, g, *, causal, scale, block_k=BLOCK_K,
                        g_lse=None):
    """dq, dk, dv for ``flash_attention``: the port of ``_bwd_core``. Key
    blocks of ``block_k`` recompute P = exp(S - lse) one [B,H,T,Bk] tile at
    a time; invalid entries are set to exactly 0 before use (on a fully
    masked row lse is the sentinel and exp(S - lse) would be ~1). Under
    causal masking a key block's rows above its first key contribute
    nothing, so they are skipped. All [B,T,H,D] in and out. ``g_lse``
    ([B,H,T], optional) is a cotangent on the lse output: d(lse)/d(s) is
    the softmax row, so it adds ``p * g_lse`` to ds (``flash_attention_block``)."""
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
            if g_lse is not None:
                ds = ds + p * g_lse[:, :, r0:, None].float()
            dq[:, :, r0:] += _mm(ds, k_j, dt) * scale
            dk[:, :, c0:c1] = _mm(ds.transpose(-1, -2), q_i, dt) * scale
    return tuple(x.permute(0, 2, 1, 3).to(dt) for x in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    """(out, lse), both differentiable; an output that takes no part in the
    loss passes None to the backward (grads are not materialised), so
    ``flash_attention``'s backward never sees an lse cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        ctx.set_materialize_grads(False)
        out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.causal, ctx.scale = mask, causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, ctx.mask, out, lse, g_out, causal=ctx.causal,
                                         scale=ctx.scale, g_lse=g_lse)
        return dq, dk, dv, None, None, None


def flash_attention_block(q, k, v, causal, scale):
    """``(out [B,T,H,D], lse [B,H,T] f32)`` of one ring-attention block pair
    (the JAX package's ``ops.attention_pallas.flash_attention_block``):
    both outputs are differentiable, so a caller may combine blocks by
    log-sum-exp. The forward is ``flash_attention_fwd`` (the kernel on CUDA
    tensors, the plain version on CPU tensors); the backward is
    ``flash_attention_bwd`` with the lse cotangent. A fully masked row's
    lse is the ``NEG_INF`` sentinel, not -inf."""
    return _FlashAttention.apply(q, k, v, None, bool(causal), _scale(scale, q.shape[-1]))


def flash_attention(q, k, v, *, mask=None, causal=False, scale=None):
    """Differentiable flash attention over [B, T, H, D] self-attention
    inputs (the JAX package's ``ops.attention_pallas.flash_attention``
    contract). ``mask``: optional [B, T] key mask (1 = valid); it gets no
    gradient. Fully masked query rows emit 0."""
    if mask is not None:
        mask = mask.detach()
    return _FlashAttention.apply(q, k, v, mask, bool(causal), _scale(scale, q.shape[-1]))[0]
