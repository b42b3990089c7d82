"""The flash-attention backward kernels' plan, wrapper and arithmetic.

``csrc/flash_attn_bwd_wgmma.cu`` and ``csrc/flash_attn_bwd.cu`` cannot run
here (no nvcc, no card); chip_smoke holds them against
``flash_attention_bwd_plain`` on the card. Here:

- ``plan_bwd``: variants by dtype, width and alignment, the two passes'
  grids, shared memory within ``SMEM_LIMIT``, and the constants the CUDA
  sources compile in;
- the wrapper: CPU tensors take the plain version and count no launch;
  ``_check_bwd`` refuses shapes, dtypes and strides the kernel does not take;
- the kernel's arithmetic, emulated on the CPU (``kernel_bwd`` below: the
  dq pass, then the dk/dv pass over 64-row tiles from the causal diagonal,
  S and dP 16 features at a time and each tile's dq, dk, dv product in
  fresh sums, every product through the 3xTF32 split ``matmul_3xtf32``),
  against the JAX package's ``_bwd_core`` through ``jax.vjp`` of
  ``flash_attention`` (interpret mode) and of ``flash_attention_block``
  with an lse cotangent.

Tolerance: chip_smoke's FLASH_GRAD_ATOL / FLASH_GRAD_RTOL (1e-5 + 1e-4 of
the reference), which the kernel is held to on the card: the split's
products are f32 to ~2^-22, and the sums run in another order.
"""

import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention_pallas as jfa
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops import attention as tfa

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TILE = tfa.BWD_COLS  # a swept tile's columns (the row blocks do not change the sums)
CHUNK = 16  # features a fresh S or dP accumulator sums


def _inputs(b, t, h, d, seed):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    return q, k, v, g, rs


def _mask(rs, b, t):
    """Ragged key lengths, the last batch row fully masked."""
    lens = rs.randint(1, t + 1, size=b)
    lens[-1] = 0
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def kernel_bwd(q, k, v, mask, out, lse, g, *, causal, scale, g_lse=None):
    """dq, dk, dv as the f32 backward kernels compute them, in f32 on the
    CPU: the dq pass (delta per row; per key tile S and dP from 16-feature
    fresh sums, P, dS, the tile's dS.K added to dq) and the dk/dv pass (per
    query tile from the diagonal, S^T and dP^T with the keys as rows, the
    tile's P^T.dO and dS^T.Q added to dv and dk), every product through
    ``matmul_3xtf32``. ``f32_3xtf32_wgmma`` (two warpgroups of 64 kept rows)
    and ``f32_3xtf32`` (warps of 16) keep the same sums in the same order:
    the kept rows a block holds do not enter them, and the order within one
    tensor-core product (mma.sync's 8-deep, wgmma's 8-deep steps) is not
    modelled. [B,T,H,D] in and out."""
    b, t, h, d = q.shape
    qh, kh, vh, oh, gh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, out, g))
    delta = (gh * oh).sum(-1)                                          # [B,H,T]
    gl = torch.zeros_like(delta) if g_lse is None else g_lse.float()
    keyok = torch.ones(b, t, dtype=torch.bool) if mask is None else mask > 0

    def abt(a, bm):
        c = 0.0
        for f0 in range(0, d, CHUNK):
            c = c + tfa.matmul_3xtf32(a[..., f0:f0 + CHUNK],
                                      bm[..., f0:f0 + CHUNK].transpose(-1, -2))
        return c

    def valid(r0, r1, c0, c1):                                        # [B,1,R,C]
        rows, cols = torch.arange(r0, r1), torch.arange(c0, c1)
        ok = keyok[:, None, None, c0:c1].expand(b, 1, r1 - r0, c1 - c0)
        if causal:
            ok = ok & (cols[None, :] <= rows[:, None])
        return ok

    def ds_of(p, dp, r0, r1):
        ds = p * (dp - delta[:, :, r0:r1, None])
        if g_lse is not None:
            ds = ds + p * gl[:, :, r0:r1, None]
        return ds

    dq = torch.zeros(b, h, t, d)
    for r0 in range(0, t, TILE):
        r1 = min(r0 + TILE, t)
        for c0 in range(0, t, TILE):
            if causal and c0 > r1 - 1:
                break
            c1 = min(c0 + TILE, t)
            s, dp = abt(qh[:, :, r0:r1], kh[:, :, c0:c1]), abt(gh[:, :, r0:r1], vh[:, :, c0:c1])
            p = torch.where(valid(r0, r1, c0, c1), torch.exp(s * scale - lse[:, :, r0:r1, None]),
                            torch.zeros_like(s))
            dq[:, :, r0:r1] += tfa.matmul_3xtf32(ds_of(p, dp, r0, r1), kh[:, :, c0:c1])
    dk, dv = torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    for c0 in range(0, t, TILE):
        c1 = min(c0 + TILE, t)
        for r0 in range(c0 if causal else 0, t, TILE):
            r1 = min(r0 + TILE, t)
            st = abt(kh[:, :, c0:c1], qh[:, :, r0:r1])                 # [B,H,C,R]
            dpt = abt(vh[:, :, c0:c1], gh[:, :, r0:r1])
            pt = torch.where(valid(r0, r1, c0, c1).transpose(-1, -2),
                             torch.exp(st * scale - lse[:, :, None, r0:r1]), torch.zeros_like(st))
            dst = ds_of(pt.transpose(-1, -2), dpt.transpose(-1, -2), r0, r1).transpose(-1, -2)
            dv[:, :, c0:c1] += tfa.matmul_3xtf32(pt, gh[:, :, r0:r1])
            dk[:, :, c0:c1] += tfa.matmul_3xtf32(dst, qh[:, :, r0:r1])
    return tuple(x.permute(0, 2, 1, 3) for x in (dq * scale, dk * scale, dv))


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the kernel's arithmetic against the JAX package's _bwd_core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,causal,masked", [
    (64, 16, True, False), (100, 32, True, True), (130, 16, False, True),
    (130, 32, True, True), (70, 64, False, False)])
def test_emulated_kernel_matches_jax_bwd_core(t, d, causal, masked):
    """Causal or not, masked with one fully masked row, T off the 64-row
    tile: the emulation within the f32 gradient tolerance of jax.vjp
    through the JAX package's flash_attention (interpret mode)."""
    b, h = 2, 2
    q, k, v, g, rs = _inputs(b, t, h, d, seed=t + d)
    m = _mask(rs, b, t) if masked else None
    scale = float(1.0 / np.sqrt(d))
    _, vjp = jax.vjp(lambda a, c, e: jfa.flash_attention(
        a, c, e, mask=None if m is None else jnp.asarray(m), causal=causal, block_q=128,
        block_k=128, interpret=True), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tm = None if m is None else torch.from_numpy(m)
    out, lse = tfa.flash_attention_plain(tq, tk, tv, mask=tm, causal=causal, scale=scale)
    got = kernel_bwd(tq, tk, tv, tm, out, lse, tg, causal=causal, scale=scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), w, name)
    if masked:  # the fully masked batch row's queries get exactly zero
        assert (got[0][-1] == 0).all()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_emulated_kernel_matches_jax_block_with_lse_cotangent(causal):
    """The ring block entry: jax.vjp of flash_attention_block with nonzero
    cotangents on out and lse (``_bwd_core``'s g_lse term)."""
    b, t, h, d = 1, 90, 2, 32
    q, k, v, g, rs = _inputs(b, t, h, d, seed=5 + causal)
    g_lse = rs.randn(b, h, t).astype(np.float32)
    scale = float(1.0 / np.sqrt(d))
    _, vjp = jax.vjp(lambda a, c, e: jfa.flash_attention_block(a, c, e, causal, scale, True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, scale=scale)
    got = kernel_bwd(tq, tk, tv, None, out, lse, tg, causal=causal, scale=scale,
                     g_lse=torch.from_numpy(g_lse))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), w, name)


def test_emulated_kernel_matches_the_plain_backward():
    """The emulation and ``flash_attention_bwd_plain`` (what chip_smoke
    holds the kernel against) agree within the same tolerance."""
    b, t, h, d = 2, 150, 2, 32
    q, k, v, g, rs = _inputs(b, t, h, d, seed=9)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tm = torch.from_numpy(_mask(rs, b, t))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, mask=tm, causal=True, scale=0.2)
    got = kernel_bwd(tq, tk, tv, tm, out, lse, tg, causal=True, scale=0.2)
    want = tfa.flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tg, causal=True, scale=0.2)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), w.numpy(), name)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

LM_STRIDES = ((4096 * 3 * 512, 3 * 512, 64),) * 3  # views of one [B,T,3,H,D] projection


@pytest.mark.parametrize("shape,dtype,strides,aligned,variant,dp", [
    ((4, 4096, 8, 64), torch.float32, LM_STRIDES, True, "f32_3xtf32_wgmma", 64),
    ((4, 4096, 8, 64), torch.float32, None, True, "f32_3xtf32_wgmma", 64),
    ((4, 1000, 8, 32), torch.float32, None, True, "f32_3xtf32_wgmma", 64),
    ((4, 1000, 8, 128), torch.float32, None, True, "f32_3xtf32", 128),
    ((4, 1000, 8, 100), torch.float32, None, True, "f32_3xtf32", 128),
    ((4, 1000, 8, 64), torch.float32, None, False, "f32_3xtf32_unaligned", 64),
    ((4, 1000, 8, 64), torch.float32, ((1000 * 3 * 8 * 65, 3 * 8 * 65, 65),) * 3, True,
     "f32_3xtf32_unaligned", 64),
    ((4, 1000, 8, 30), torch.float32, None, True, "f32_3xtf32_unaligned", 64),
    ((4, 4096, 8, 64), torch.bfloat16, LM_STRIDES, True, "bf16_wgmma", 64),
    ((4, 1000, 8, 128), torch.bfloat16, None, True, "bf16_wgmma", 128),
    ((4, 1000, 8, 128), torch.bfloat16, None, False, "bf16_tf32", 128),
    ((4, 1000, 8, 100), torch.bfloat16, None, True, "bf16_tf32", 128),
    ((4, 1000, 8, 64), torch.bfloat16, ((1000 * 3 * 8 * 65, 3 * 8 * 65, 65),) * 3, True,
     "bf16_tf32", 64),
    ((4, 1000, 8, 64), torch.bfloat16, ((1000 * 8 * 64, 64, 1000 * 64),) * 3, True,
     "bf16_tf32", 64),
])
def test_plan_bwd_variants(shape, dtype, strides, aligned, variant, dp):
    """LM strides and aligned calls at D <= 64 (f32) or any D (bf16, D a
    multiple of 8) take the wgmma variants; D > 64 in f32 keeps
    ``f32_3xtf32``, unaligned views, odd strides and strides that do not
    nest keep ``f32_3xtf32_unaligned`` and ``bf16_tf32``."""
    pl = tfa.plan_bwd(shape, dtype, strides, aligned)
    assert (pl.variant, pl.dp) == (variant, dp)
    b, t, h, _ = shape
    rows, threads = {"f32_3xtf32_wgmma": (128, 256), "bf16_wgmma": (64, 160)}.get(
        variant, ({64: 128, 128: 64}[dp], 2 * {64: 128, 128: 64}[dp]))
    grid = (-(-t // rows), b * h)
    assert pl.grid_dq == pl.grid_dkdv == (grid[::-1] if "wgmma" in variant else grid)
    assert (pl.block_rows, pl.block_cols, pl.threads) == (rows, 64, threads)
    assert pl.smem_bytes == tfa.bwd_smem_bytes(variant, dp) <= tfa.SMEM_LIMIT


@pytest.mark.parametrize("variant,dp,want,blocks", [
    ("f32_3xtf32", 64, 176_128, 1), ("f32_3xtf32", 128, 204_544, 1),
    ("f32_3xtf32_wgmma", 64, 231_936, 1), ("bf16_wgmma", 64, 86_344, 2),
    ("bf16_wgmma", 128, 168_264, 1)])
def test_plan_bwd_shared_memory(variant, dp, want, blocks):
    """Blocks an SM by shared memory (1 KB reserved a block of the SM's 228
    KB): the mma.sync variants and f32_3xtf32_wgmma one (DP = 64 holds 128
    kept rows, the swept pair and its lo halves; DP = 128 64 kept rows and
    the swept pair; the wgmma dk/dv pass 128 kept keys raw, Q, Q^T, dO,
    dO^T as TF32 halves and the raw swept pair, 512 bytes under the limit),
    bf16_wgmma two at DP = 64 (64 kept keys, a 4-stage ring)."""
    assert tfa.bwd_smem_bytes(variant, dp) == want
    assert want <= tfa.SMEM_LIMIT and (233_472 // (want + 1024)) == blocks


def test_plan_bwd_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tfa.plan_bwd((1, 8, 1, 8), torch.float16)


@pytest.mark.parametrize("passes", [0, 4, -1])
def test_backward_refuses_other_pass_masks(passes):
    """``passes`` is a mask of the dq (1) and dk/dv (2) passes: anything
    else is refused before any launch, on the CPU too."""
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="passes"):
        tfa.flash_attention_bwd(q, q, q, None, q, torch.zeros(1, 1, 8), q, causal=False,
                                scale=1.0, passes=passes)


def test_bwd_constants_mirror_the_cuda_source():
    src = tfa.BWD_SOURCE.read_text()
    assert re.search(r"constexpr int kCols = (\d+);", src).group(1) == str(tfa.BWD_COLS)
    assert "PRESPLIT = DP == 64;" in src
    assert "ROWS = PRESPLIT ? 128 : 64;" in src and tfa.BWD_ROWS == {64: 128, 128: 64}
    assert "THREADS = 2 * ROWS;" in src
    wsrc = tfa.BWD_WGMMA_SOURCE.read_text()
    # the variants' indices: BWD_VARIANTS' order across the two sources
    enums = [dict(re.findall(r"(k\w+) = (\d+)", re.search(r"enum Variant \{([^}]*)\}", x)
                                                          .group(1))) for x in (src, wsrc)]
    assert sorted(int(i) for e in enums for i in e.values()) == list(range(len(tfa.BWD_VARIANTS)))
    assert enums[1] == {"kF32Tf32x3Wgmma": str(tfa.BWD_VARIANTS.index("f32_3xtf32_wgmma")),
                        "kBf16Wgmma": str(tfa.BWD_VARIANTS.index("bf16_wgmma"))}
    for x in (src, wsrc):  # the pass bits
        assert "enum Pass { kDqPass = 1, kDkDvPass = 2 };" in x
    assert tfa.BWD_PASSES == {"dq": 1, "dkdv": 2} and tfa.BOTH_PASSES == 3
    # the wgmma variants' blocks
    for name, want in (("kTRows", tfa.BWD_WGMMA_ROWS["f32_3xtf32_wgmma"]),
                       ("kTCols", tfa.BWD_COLS), ("kTThreads",
                                                 tfa.BWD_WGMMA_THREADS["f32_3xtf32_wgmma"]),
                       ("kBRows", tfa.BWD_WGMMA_ROWS["bf16_wgmma"]), ("kBCols", tfa.BWD_COLS)):
        found = re.search(rf"constexpr int {name} = (\d+);", wsrc).group(1)
        assert found == str(want), name
    assert "constexpr int kBThreads = 128 + 32;" in wsrc
    assert tfa.BWD_WGMMA_THREADS["bf16_wgmma"] == 160
    assert f"static constexpr int S = {tfa.BWD_BF16_STAGES};" in wsrc
    for line in ("uint32_t kept = (2 + NTR) * 2 * kTCopy;",
                 "uint32_t raw = kept + 2 * kTRows * 256;",
                 "uint32_t vec = raw + 2 * kTCols * 256;",
                 "uint32_t rowv = vec + 2 * NV * kTCols * 4;",
                 "int bytes = rowv + (DQ ? kTRows * 4 : 0) + 1024;",
                 "uint32_t ring = 2 * NB * kBBox;", "uint32_t vec = ring + S * stage_bytes;",
                 "uint32_t rowv = vec + S * NV * kBCols * 4;",
                 "uint32_t bars = rowv + kBRows * 4;",
                 "int bytes = bars + (1 + 2 * S) * 8 + 1024;"):
        assert f"static constexpr {line}" in wsrc, line
    assert "constexpr uint32_t kTCopy = 2 * kTBox;" in wsrc and "kTBox = 64 * 128;" in wsrc
    assert "kBBox = 64 * 128;" in wsrc
    # the layout bwd_smem_bytes counts
    for line in ("ring = 2 * ROWS * LD;", "lo = ring + 4 * tile;",
                 "vec = lo + (PRESPLIT ? 2 * tile : 0);", "rowv = vec + 2 * 3 * kCols;",
                 "bytes = (rowv + ROWS) * 4;"):
        assert f"static constexpr int {line}" in src, line


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_backward_and_count_no_launch(monkeypatch):
    monkeypatch.setattr(tfa, "launches_bwd", 0)
    monkeypatch.setattr(tfa, "launches_bwd_by_variant", dict.fromkeys(tfa.BWD_VARIANTS, 0))
    q, k, v, g, rs = _inputs(2, 40, 2, 8, seed=1)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    got = tfa.flash_attention_bwd(tq, tk, tv, None, out, lse, tg, causal=True, scale=0.3)
    want = tfa.flash_attention_bwd_plain(tq, tk, tv, None, out, lse, tg, causal=True, scale=0.3)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    qg = tq.clone().requires_grad_(True)
    tfa.flash_attention(qg, tk, tv, causal=True).sum().backward()
    assert tfa.launches_bwd == 0 and not any(tfa.launches_bwd_by_variant.values())


def test_reset_launches_clears_the_backward_counts(monkeypatch):
    monkeypatch.setattr(tfa, "launches_bwd", 3)
    monkeypatch.setattr(tfa, "launches_bwd_by_variant",
                        {**dict.fromkeys(tfa.BWD_VARIANTS, 0), "bf16_tf32": 3})
    monkeypatch.setattr(tfa, "launches", 0)
    monkeypatch.setattr(tfa, "launches_by_variant", dict.fromkeys(tfa.VARIANTS, 0))
    tfa.reset_launches()
    assert tfa.launches_bwd == 0 and not any(tfa.launches_bwd_by_variant.values())


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "stride", "out", "g", "lse", "g_lse",
                                 "lse_dtype", "mask"])
def test_check_bwd_refuses(bad):
    b, t, h, d = 2, 16, 2, 8
    q, k, v, out, g = (torch.zeros(b, t, h, d) for _ in range(5))
    lse, g_lse, m = torch.zeros(b, h, t), None, None
    if bad == "dtype":
        q, k, v = (x.double() for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v, out, g = (torch.zeros(b, t, h, 129) for _ in range(5))
    elif bad == "stride":
        q = torch.zeros(b, t, d, h).transpose(2, 3)
    elif bad == "out":
        out = torch.zeros(b, t - 1, h, d)
    elif bad == "g":
        g = torch.zeros(b, t, h, d + 1)
    elif bad == "lse":
        lse = torch.zeros(b, t, h)
    elif bad == "g_lse":
        g_lse = torch.zeros(b, h, t + 1)
    elif bad == "lse_dtype":
        lse = torch.zeros(b, h, t, dtype=torch.int32)
    else:
        m = torch.ones(b, t + 1)
    with pytest.raises((TypeError, ValueError)):
        tfa._check_bwd(q, k, v, m, out, lse, g, g_lse)


def test_check_bwd_takes_the_path_views():
    """The fused projection's views, with the residuals and cotangents the
    autograd.Function hands the backward, pass the checks."""
    qkv = torch.zeros(2, 16, 3, 2, 8)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    tfa._check_bwd(q, k, v, torch.ones(2, 16), torch.zeros(2, 16, 2, 8), torch.zeros(2, 2, 16),
                   torch.zeros(2, 16, 2, 8), torch.zeros(2, 2, 16))


def test_non_cuda_device_is_refused():
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd(q, q, q, None, q, torch.zeros(1, 1, 4, device="meta"), q,
                                causal=False, scale=1.0)


def test_backward_notes_into_the_tally_and_recording_of_its_forward(monkeypatch):
    """Autograd runs a CUDA backward on its worker thread, which has no
    tally or recording of its own: the backward notes into those open when
    its forward ran (a K-step capture then counts it, a warm-up records its
    library), and the thread's own state is back after it."""
    seen = []
    plain = tfa.flash_attention_bwd

    def noting(*args, **kwargs):
        seen.append(_build.thread_state())
        _build.note_launch("attention_bwd", "attention_bwd.variant.f32_3xtf32")
        return plain(*args, **kwargs)
    monkeypatch.setattr(tfa, "flash_attention_bwd", noting)
    q = torch.randn(1, 8, 1, 4, requires_grad=True)
    with _build.recording() as rec, _build.launch_tally() as tally:
        out = tfa.flash_attention(q, q.detach(), q.detach(), causal=True)
    worker = {}

    def backward():
        torch.autograd.grad(out.sum(), q)
        worker["after"] = _build.thread_state()
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert tally == {"attention_bwd": 1, "attention_bwd.variant.f32_3xtf32": 1}
    assert len(seen) == 1 and seen[0][0] is rec and seen[0][1] is tally
    assert worker["after"] == (None, None) and _build.thread_state() == (None, None)
