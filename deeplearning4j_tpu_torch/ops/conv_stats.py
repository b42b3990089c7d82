"""Convolution with fused batch-norm statistics: the hand-written Hopper
kernels, their plain versions, and the fused conv + BN + residual +
activation op.

Replaces the TPU kernels ``_mm_stats_kernel`` (1x1 convs) and
``_conv3x3_stats_kernel`` (SAME 3x3 convs) of
``deeplearning4j_tpu/ops/conv_pallas.py``, with the contract of that
module's ``fused_conv_bn_act``:

- ``conv_mm_stats(x, w2d, stride)`` and ``conv3x3_stats(x, w, stride)``
  return ``(z [B,Ho,Wo,Cout] in x's dtype, stats [2,Cout] f32)``: the conv
  accumulated in f32, z written once, and per-channel ``[sum z, sum z^2]``
  taken from the unrounded f32 accumulator. On CUDA tensors they launch
  ``csrc/conv_stats.cu`` (f32 or bf16); on CPU tensors they take
  ``conv_mm_stats_plain`` / ``conv3x3_stats_plain``. ``launches`` counts
  the kernel launches of each, ``launches_by_variant`` the same launches
  by kernel variant; ``plan()`` chooses the variant, tile and persistent
  grid of a call from its shape, before the launch, and ``launch_plan``
  replaces the tile and grid by a tuning DB's winner where one is bound
  (``tuning/``).
- ``fused_conv_bn_act`` is the train-mode fused op (one
  ``torch.autograd.Function``). Forward: the kernel's z and sums, then
  ``var = max(E[z^2] - mean^2, 0)``, the normalize, affine, residual add
  and activation in f32, y in z's dtype; the batch mean and variance come
  back for the caller's running-average update and get no gradient.
  Backward: the train-mode BN backward to dz (rounded to z's dtype), then
  dx and dW by ``torch.matmul`` (1x1; a strided conv's dx scattered into
  zeros at ``::s``) or by the library's conv gradients (3x3), as the JAX
  package leaves them to XLA.

Layouts are the JAX package's: x NHWC, w HWIO. SAME padding is XLA's: a
3x3 at stride 1 pads (1, 1), at stride 2 on even H, W it pads (0, 1).
What bounds the kernels on an H100, and their design, are in the CUDA
source's header.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _build, _plans
from deeplearning4j_tpu_torch.utils import collectives as _collectives

SOURCE = _build.CSRC / "conv_stats.cu"

#: kernel launches (wrapper calls that reached each CUDA kernel)
launches = {"conv_mm_stats": 0, "conv3x3_stats": 0}
#: the same launches by kernel variant (``plan().variant``)
VARIANTS = ("bf16_wgmma", "bf16_unaligned", "f32_pipelined", "f32_unaligned")
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def _declare(lib):
    lib.conv_stats_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.conv_stats_launch.restype = ctypes.c_int
    lib.conv_stats_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.conv_stats_smem_bytes.restype = ctypes.c_int
    lib.conv_stats_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.conv_stats_occupancy.restype = ctypes.c_int
    lib.conv_stats_error_string.argtypes = [ctypes.c_int]
    lib.conv_stats_error_string.restype = ctypes.c_char_p


_LIB = _build.Library(SOURCE, _declare)


def build():
    """Compile ``csrc/conv_stats.cu`` unless built; returns the library path."""
    return _LIB.build()


def reset_launches():
    for counts in (launches, launches_by_variant):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def same_pads(size, kernel, stride):
    """XLA's SAME padding of one spatial axis: (lo, hi), the extra pad high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def supported(kernel, stride, padding, dilation, act, x_shape=None):
    """Geometries the kernels cover (the JAX package's ``supported``): 1x1
    at any stride, SAME 3x3 at stride 1, or at stride 2 on even spatial
    dims (``x_shape`` [B,H,W,C] must say so; without it stride-2 3x3 is
    refused). No dilation; relu or identity."""
    if act not in ("relu", "identity") or tuple(dilation) != (1, 1):
        return False
    k, s = tuple(kernel), tuple(stride)
    if k == (1, 1):
        return True
    if k != (3, 3) or padding != "same":
        return False
    if s == (1, 1):
        return True
    return s == (2, 2) and x_shape is not None and x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

#: shared memory one block may take on sm_90 (bytes)
SMEM_LIMIT = 232_448
#: SMs of an H100 SXM: what plan() assumes when no card is asked
H100_SMS = 132

# the compiled configurations of csrc/conv_stats.cu (its constants, mirrored)
WG_BM, WG_STAGES, WG_BK = 128, 4, 64
F32_STAGES, F32_BK = 3, 16
U_BM, U_BN, U_BK = 128, 64, 32


class Plan(NamedTuple):
    """How one call runs: the kernel variant, its tile (``bm`` output pixels
    x ``bn`` channels) and ring depth, the persistent grid, the partials
    buffer's rows and the block's shared memory."""
    variant: str
    bm: int
    bn: int
    stages: int
    blocks_per_sm: int  # blocks the grid puts on one SM (0: one tile per block)
    grid: int
    row_tiles: int
    col_tiles: int
    smem_bytes: int

    @property
    def tiles(self):
        return self.row_tiles * self.col_tiles


def smem_bytes(variant, bm, bn):
    """Shared memory (bytes) of one block of ``variant`` at a ``bm`` x
    ``bn`` tile, as ``csrc/conv_stats.cu`` lays it out."""
    if variant == "bf16_wgmma":
        nwg = bm // 64
        stage = (bm + bn) * WG_BK * 2
        return (WG_STAGES * stage + nwg * 64 * (bn + 8) * 2 + 4 * nwg * 2 * bn * 4
                + 2 * WG_STAGES * 8 + 1024)
    if variant == "bf16_unaligned":
        tiles = max((U_BM * (U_BK + 8) + U_BK * (U_BN + 8)) * 2, U_BM * (U_BN + 4) * 4)
        return tiles + 3 * U_BM * 4 + 8 * 2 * U_BN * 4
    threads = bm * bn // 64
    return 4 * (F32_STAGES * (bm * (F32_BK + 4) + F32_BK * bn) + threads // 32 * 2 * bn)


#: the compiled (bm, bn) tiles of each variant (``compiled()`` of the source)
TILES = {"bf16_wgmma": ((WG_BM, 64), (WG_BM, 128)),
         "bf16_unaligned": ((U_BM, U_BN),),
         "f32_pipelined": ((128, 128), (64, 128), (128, 64)),
         "f32_unaligned": ((128, 128), (64, 128), (128, 64))}
#: the blocks an SM a variant's persistent grid may take (0: one tile a block)
BLOCKS_PER_SM = {"bf16_wgmma": (1, 2), "bf16_unaligned": (0,),
                 "f32_pipelined": (1, 2, 4), "f32_unaligned": (1, 2, 4)}
#: shared memory of one SM on sm_90 (bytes): the blocks it holds at once share it
SM_SMEM = 233_472
_STAGES = {"bf16_wgmma": WG_STAGES, "bf16_unaligned": 1}


def variant_of(dtype, aligned, cin, cout):
    """The variant a call takes, from its dtype and alignment alone."""
    if dtype == torch.bfloat16:
        return "bf16_wgmma" if aligned and cin % 8 == 0 and cout % 8 == 0 else "bf16_unaligned"
    if dtype == torch.float32:
        return "f32_pipelined" if aligned and cin % 4 == 0 and cout % 4 == 0 else "f32_unaligned"
    raise TypeError(f"conv-statistics kernels take float32 or bfloat16, got {dtype}")


def _assemble(variant, m, cout, bm, bn, per_sm, sms):
    col_tiles = -(-cout // bn)
    row_tiles = -(-m // bm)
    tiles = row_tiles * col_tiles
    grid = min(tiles, sms * per_sm) if per_sm else tiles
    return Plan(variant, bm, bn, _STAGES.get(variant, F32_STAGES), per_sm, grid, row_tiles,
                col_tiles, smem_bytes(variant, bm, bn))


@functools.lru_cache(maxsize=None)
def plan(kernel, x_shape, cout, stride, dtype, sms=H100_SMS, aligned=True):
    """The launch of one conv-statistics call: ``kernel`` 1 or 3, x_shape
    (B, H, W, Cin), ``stride`` (sh, sw), ``dtype`` float32 or bfloat16,
    ``sms`` the card's SM count, ``aligned`` whether x and w start on 16
    bytes. The variant follows from dtype and alignment alone: bf16 with
    Cin and Cout multiples of 8 takes ``bf16_wgmma``, f32 with Cin and
    Cout multiples of 4 ``f32_pipelined``, other shapes the unaligned
    variants. Tiles are 64 channels wide where Cout <= 64, else 128;
    bf16_wgmma tiles are 128 rows tall, f32 tiles 128 rows or, where that
    leaves an SM without a tile, 64. The grid is persistent: at most
    ``blocks_per_sm`` blocks an SM, block i taking tiles i, i + grid, ...
    (``schedule``). The hand-picked plan: ``launch_plan`` gives a tuned
    one where a tuning DB is bound."""
    b, h, w, cin = x_shape
    sh, sw = stride
    m = b * -(-h // sh) * -(-w // sw)
    narrow = cout <= 64  # a 64-channel tile: no idle half tile
    variant = variant_of(dtype, aligned, cin, cout)
    if variant == "bf16_wgmma":
        # 128 rows even where fewer tiles than SMs result (the 7x7 stage:
        # 100 tiles): on the H100 they beat 64-row tiles on every SM
        bn, bms = 64 if narrow else 128, (WG_BM,)
    elif variant == "bf16_unaligned":
        bn, bms = U_BN, (U_BM,)
    else:
        bn, bms = (64, (128,)) if narrow else (128, (128, 64))
    col_tiles = -(-cout // bn)
    bm = next((c for c in bms if -(-m // c) * col_tiles >= sms), bms[-1])
    # bf16_wgmma: one block an SM; f32: 256 threads an SM (one 128 x 128
    # block or two of 128 threads); bf16_unaligned: one tile a block
    per_sm = {"bf16_wgmma": 1, "bf16_unaligned": 0}.get(variant, 256 * 64 // (bm * bn))
    return _assemble(variant, m, cout, bm, bn, per_sm, sms)


def config_of(pl):
    """The tunable fields of a plan: its tile and blocks an SM."""
    return {"bm": pl.bm, "bn": pl.bn, "blocks_per_sm": pl.blocks_per_sm}


def configured(m, cin, cout, dtype, aligned, sms, config):
    """The plan ``config`` ({bm, bn, blocks_per_sm}) gives a call of ``m``
    output pixels, ``cin`` and ``cout`` channels, or the reason it is
    refused: a tile the variant has not compiled, a grid the variant does
    not take, shared memory above ``SMEM_LIMIT``, or blocks an SM whose
    shared memory exceeds the SM's. (Two configs whose grids clamp to the
    same tiles launch alike: ``tuning/space.prune`` keeps one.)"""
    variant = variant_of(dtype, aligned, cin, cout)
    try:
        bm, bn, per_sm = (int(config[k]) for k in ("bm", "bn", "blocks_per_sm"))
    except (KeyError, TypeError, ValueError):
        return f"config: needs integer bm, bn and blocks_per_sm, got {config}"
    if (bm, bn) not in TILES[variant]:
        return f"not compiled: {variant} has tiles {list(TILES[variant])}, not {(bm, bn)}"
    options = BLOCKS_PER_SM[variant]
    if per_sm not in options:
        return f"grid: {variant} takes blocks_per_sm in {list(options)}, not {per_sm}"
    smem = smem_bytes(variant, bm, bn)
    if smem > SMEM_LIMIT:
        return f"smem: {smem} B exceeds the {SMEM_LIMIT} B a block may take"
    if per_sm * smem > SM_SMEM:
        return f"co-residency: {per_sm} blocks of {smem} B exceed an SM's {SM_SMEM} B"
    return _assemble(variant, m, cout, bm, bn, per_sm, sms)


def _resolve(db, key):
    ks, b, h, w, cin, cout, sh, sw, dtype, sms, aligned = key
    dt = _plans.DTYPES[dtype]
    default = plan(ks, (b, h, w, cin), cout, (sh, sw), dt, sms, aligned)
    if db is not None:
        ho, wo = -(-h // sh), -(-w // sw)
        if ks == 1:
            cfg = db.lookup("conv_matmul", (b * ho * wo, cin, cout), dtype)
        else:
            cfg = db.lookup("conv3x3", (b, ho, wo, cin, cout), dtype)
        if cfg is not None:
            pl = configured(b * ho * wo, cin, cout, dt, aligned, sms, cfg)
            if isinstance(pl, Plan):
                return config_of(pl), pl
    return config_of(default), default


def _configured_at(key, config):
    ks, b, h, w, cin, cout, sh, sw, dtype, sms, aligned = key
    return configured(b * -(-h // sh) * -(-w // sw), cin, cout, _plans.DTYPES[dtype], aligned,
                      sms, config)


#: the plans of this library's calls, per call key and tuning-DB binding
PLANS = _plans.PlanCache("conv_stats", _resolve, _configured_at)


def plan_key(kernel, x_shape, cout, stride, dtype, sms=H100_SMS, aligned=True):
    """The key ``PLANS`` keeps a call's plan under (``launch_plan``'s
    arguments)."""
    b, h, w, cin = x_shape
    return (int(kernel), b, h, w, cin, cout, stride[0], stride[1], _plans.dtype_name(dtype),
            sms, bool(aligned))


def launch_plan(kernel, x_shape, cout, stride, dtype, sms=H100_SMS, aligned=True):
    """The plan a launch takes: ``plan()``'s, or with a tuning DB bound the
    tuned config of the call's bucket where it validates here (kernel ids
    ``conv_matmul`` (rows, Cin, Cout) and ``conv3x3`` (B, Ho, Wo, Cin,
    Cout)); resolved once per call key and binding (``ops/_plans.py``)."""
    return PLANS.get(plan_key(kernel, x_shape, cout, stride, dtype, sms, aligned))


def schedule(pl):
    """The output tiles each block of the plan takes, in order (row tile =
    tile // col_tiles, column tile = tile % col_tiles)."""
    return [range(i, pl.tiles, pl.grid) for i in range(pl.grid)]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _stats(acc2d):
    return torch.stack((acc2d.sum(0), (acc2d * acc2d).sum(0)))


def conv_mm_stats_plain(x, w2d, stride=(1, 1)):
    """The 1x1 kernel's function: x [B,H,W,Cin] subsampled at ``::stride``
    times w2d [Cin,Cout], operands rounded to x's dtype and multiplied in
    f32 by ``torch.matmul``. Returns (z in x's dtype, stats [2,Cout] f32
    from the f32 product)."""
    sh, sw = stride
    xs = x[:, ::sh, ::sw, :]
    b, ho, wo, cin = xs.shape
    ad = _acc_dtype(x.dtype)
    acc = torch.matmul(xs.reshape(-1, cin).to(ad), w2d.to(x.dtype).to(ad))
    return acc.to(x.dtype).reshape(b, ho, wo, -1), _stats(acc)


def conv3x3_stats_plain(x, w, stride=(1, 1)):
    """The 3x3 kernel's function: an explicitly padded (XLA SAME) library
    conv of x [B,H,W,Cin] with w [3,3,Cin,Cout], operands rounded to x's
    dtype and convolved in f32. Returns (z in x's dtype, stats [2,Cout])."""
    sh, sw = stride
    _, h, wd, _ = x.shape
    (hl, hh), (wl, wh) = same_pads(h, 3, sh), same_pads(wd, 3, sw)
    ad = _acc_dtype(x.dtype)
    xn = F.pad(x.to(ad).permute(0, 3, 1, 2), (wl, wh, hl, hh))
    acc = F.conv2d(xn, w.to(x.dtype).to(ad).permute(3, 2, 0, 1), stride=(sh, sw))
    acc = acc.permute(0, 2, 3, 1)
    return acc.to(x.dtype).contiguous(), _stats(acc.reshape(-1, acc.shape[-1]))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, x, w, ks, stride):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (ks, ks) or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x must be [B,H,W,Cin] and w [{ks},{ks},Cin,Cout], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"{name}: w is {w.dtype} on {w.device}, x is {x.dtype} on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous (NHWC and HWIO)")
    if ks == 3 and not supported((3, 3), stride, "same", (1, 1), "identity", x.shape):
        raise ValueError(f"{name}: stride {tuple(stride)} on a {x.shape[1]}x{x.shape[2]} input "
                         "is not covered (stride 1, or stride 2 on even H and W)")


_sm_counts = {}


def _sm_count(dev):
    idx = _build.device_index(dev)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _launch(name, x, w, stride):
    lib = _LIB.get()
    b, h, wd, cin = x.shape
    ks, cout = w.shape[0], w.shape[3]
    sh, sw = stride
    dev = x.device
    idx = _build.device_index(dev)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    pl = launch_plan(ks, tuple(x.shape), cout, stride, x.dtype, _sm_count(dev), aligned)
    z = torch.empty((b, -(-h // sh), -(-wd // sw), cout), dtype=x.dtype, device=dev)
    # one allocation: stats [2, Cout], then the partials [row_tiles, 2, Cout]
    scratch = torch.empty((pl.row_tiles + 1) * 2 * cout, dtype=torch.float32, device=dev)
    stats = scratch[:2 * cout].view(2, cout)
    err = lib.conv_stats_launch(VARIANTS.index(pl.variant), ks, x.data_ptr(), w.data_ptr(),
                                z.data_ptr(), scratch.data_ptr() + 8 * cout, scratch.data_ptr(),
                                b, h, wd, cin, cout, sh, sw, pl.bm, pl.bn, pl.stages, pl.grid, idx,
                                torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        msg = lib.conv_stats_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed ({pl}): CUDA error {err} ({msg})")
    with _count_lock:
        launches[name] += 1
        launches_by_variant[pl.variant] += 1
    return z, stats


def conv_mm_stats(x, w2d, stride=(1, 1)):
    """1x1 conv with fused statistics: ``(z [B,Ho,Wo,Cout], stats [2,Cout]
    f32)`` for x [B,H,W,Cin] NHWC, w2d [Cin,Cout] and ``stride`` (sh, sw),
    Ho = ceil(H / sh). CUDA tensors launch the Hopper kernel, which reads
    the strided input in place; CPU tensors take ``conv_mm_stats_plain``."""
    stride = tuple(stride)
    w = w2d.reshape(1, 1, *w2d.shape)
    if x.device.type == "cpu":
        return conv_mm_stats_plain(x, w2d, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv_mm_stats runs on cuda or cpu tensors, got {x.device}")
    _check("conv_mm_stats", x, w, 1, stride)
    return _launch("conv_mm_stats", x, w, stride)


def conv3x3_stats(x, w, stride=(1, 1)):
    """SAME 3x3 conv with fused statistics: ``(z [B,Ho,Wo,Cout], stats
    [2,Cout] f32)`` for x [B,H,W,Cin] NHWC and w [3,3,Cin,Cout] HWIO, at
    stride 1, or 2 on even H and W. CUDA tensors launch the Hopper kernel
    (shifted reads with bounds checks, no padded copy); CPU tensors take
    ``conv3x3_stats_plain``."""
    stride = tuple(stride)
    if x.device.type == "cpu":
        return conv3x3_stats_plain(x, w, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_stats runs on cuda or cpu tensors, got {x.device}")
    _check("conv3x3_stats", x, w, 3, stride)
    return _launch("conv3x3_stats", x, w, stride)


def conv_z(x, w, stride):
    """The kernel for the conv geometry: (z, stats) of the 1x1 or 3x3 conv
    of x with w (HWIO)."""
    if tuple(w.shape[:2]) == (1, 1):
        return conv_mm_stats(x, w.reshape(w.shape[2], w.shape[3]), stride)
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"no conv-stats kernel for a {tuple(w.shape[:2])} kernel")
    return conv3x3_stats(x, w, stride)


# ---------------------------------------------------------------------------
# the fused op
# ---------------------------------------------------------------------------

def _act(name, z):
    if name == "relu":
        return torch.relu(z)
    if name == "identity":
        return z
    raise ValueError(f"fused conv-bn supports relu|identity, got {name!r}")


def _conv_grads(x, w, dz, stride):
    """dx, dW of the conv z = conv(x, w) for the cotangent dz."""
    sh, sw = stride
    if tuple(w.shape[:2]) == (1, 1):
        xs = x[:, ::sh, ::sw, :]
        cin = xs.shape[3]
        x2d = xs.reshape(-1, cin)
        dz2d = dz.reshape(-1, dz.shape[3])
        dw = torch.matmul(x2d.t(), dz2d).to(w.dtype).reshape(w.shape)
        dxs = torch.matmul(dz2d, w.reshape(cin, -1).t()).to(x.dtype).reshape(xs.shape)
        if (sh, sw) == (1, 1):
            return dxs, dw
        dx = torch.zeros_like(x)
        dx[:, ::sh, ::sw, :] = dxs
        return dx, dw
    _, h, wd, _ = x.shape
    (hl, hh), (wl, wh) = same_pads(h, 3, sh), same_pads(wd, 3, sw)
    xn, wn, dzn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), dz.permute(0, 3, 1, 2)
    if (hl, wl) == (hh, wh):
        padding = (hl, wl)
    else:  # XLA's (lo, hi) pads: pad x itself, then cut the pad's gradient off
        xn, padding = F.pad(xn, (wl, wh, hl, hh)), (0, 0)
    dxn = torch.nn.grad.conv2d_input(xn.shape, wn, dzn, stride=(sh, sw), padding=padding)
    dwn = torch.nn.grad.conv2d_weight(xn, wn.shape, dzn, stride=(sh, sw), padding=padding)
    if padding == (0, 0) and (hl, hh, wl, wh) != (0, 0, 0, 0):
        dxn = dxn[:, :, hl:hl + h, wl:wl + wd]
    return (dxn.permute(0, 2, 3, 1).to(x.dtype).contiguous(),
            dwn.permute(2, 3, 1, 0).to(w.dtype).contiguous())


class _FusedConvBNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, gamma, beta, residual, stride, eps, act):
        z, stats = conv_z(x.contiguous(), w.contiguous(), stride)
        f32 = _acc_dtype(z.dtype)  # f32 (f64 stays f64 on the CPU)
        n = z.shape[0] * z.shape[1] * z.shape[2]
        # a batch group: the kernel's per-channel sums are this rank's
        # partials of the global batch's
        bg = _collectives.active()
        if bg is not None:
            stats = _collectives.all_reduce_(stats.clone(), bg.group)
            n *= bg.world
        mean = stats[0] / n
        var = torch.clamp(stats[1] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        scale = gamma.to(f32) * invstd
        shift = beta.to(f32) - mean * scale
        ypre = z.to(f32) * scale + shift
        if residual is not None:
            ypre = ypre + residual.to(f32)
        y = _act(act, ypre).to(z.dtype)
        ctx.save_for_backward(x, w, gamma, z, mean, invstd, y)
        ctx.stride, ctx.act, ctx.has_res, ctx.beta_dtype = stride, act, residual is not None, \
            beta.dtype
        ctx.bg, ctx.n = bg, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, gamma, z, mean, invstd, y = ctx.saved_tensors
        f32 = _acc_dtype(z.dtype)
        dy = dy.to(f32)
        if ctx.act == "relu":
            dy = dy * (y > 0).to(f32)
        # dy is now the cotangent of (bn_out + residual)
        dres = dy.to(z.dtype) if ctx.has_res else None
        axes = (0, 1, 2)
        n = ctx.n
        xhat = (z.to(f32) - mean) * invstd
        dgamma = (dy * xhat).sum(axes)
        dbeta = dy.sum(axes)
        g = gamma.to(f32)
        sb, sg = dbeta, dgamma
        if ctx.bg is not None:
            # the statistics span the group: dz takes the global sums of
            # the ranks' cotangents, each at its own loss's scale, while
            # gamma and beta get this rank's share (the trainer averages)
            sb, sg = _collectives.all_reduce_(torch.stack((dbeta, dgamma)), ctx.bg.group)
        # train-mode BN backward: the batch statistics are part of the graph
        dz = invstd * (dy * g - sb * g / n - xhat * (sg * g / n))
        dx, dw = _conv_grads(x, w, dz.to(z.dtype), ctx.stride)
        return (dx, dw, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), dres,
                None, None, None)


def fused_conv_bn_act(x, w, gamma, beta, residual=None, stride=(1, 1), eps=1e-5, act="relu"):
    """Train-mode fused conv + batch-norm + (residual add) + activation.

    x [B,H,W,Cin] NHWC, w HWIO ([1,1,Cin,Cout], or [3,3,Cin,Cout] SAME),
    gamma/beta [Cout], residual [B,Ho,Wo,Cout] or None. Returns (y, mean,
    var): y in x's dtype, mean/var the f32 batch statistics (no gradient).
    The kernels take f32 and bf16; float64 runs only on the CPU, through
    the plain versions, in float64 throughout."""
    return _FusedConvBNAct.apply(x, w, gamma, beta, residual, tuple(stride), float(eps), act)
