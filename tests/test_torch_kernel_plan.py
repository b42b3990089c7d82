"""The launch plans of the flash-attention and LSTM kernels
(``ops/attention.plan``, ``ops/lstm_seq.plan``), on the CPU: the variant,
tile and shared memory each shape gets, for the training path's flash
shape and the served LSTM buckets and for the edge cases; the constants
the plans mirror, read back from the CUDA sources; and the accuracy of the
3xTF32 split the f32 flash kernel runs on the tensor cores, emulated in
PyTorch at the path's statistics."""

from __future__ import annotations

import math
import re

import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as A
from deeplearning4j_tpu_torch.ops import lstm_seq as L

# the LM path: transformer_lm(8192, 6 x 512, 8 heads, seq 4096) at batch 4;
# q, k, v are views of one [B, T, 3, H, D] projection
B, T, H, D = 4, 4096, 8, 64
VIEW_STRIDES = ((T * 3 * H * D, 3 * H * D, D),) * 3


def view_strides(b, t, h, d):
    return ((t * 3 * h * d, 3 * h * d, d),) * 3


def const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,variant,block_q,threads", [
    ("float32", "f32_3xtf32_wgmma", 128, 256), ("bfloat16", "bf16_wgmma", 128, 288)])
def test_flash_plan_at_the_path_shape(dtype, variant, block_q, threads):
    pl = A.plan((B, T, H, D), getattr(torch, dtype), VIEW_STRIDES)
    assert (pl.variant, pl.dp, pl.block_q, pl.block_k, pl.threads) == (variant, 64, block_q, 64,
                                                                       threads)
    assert pl.grid == (T // block_q, B * H)
    assert pl.smem_bytes == A.smem_bytes(variant, 64) <= A.SMEM_LIMIT
    if variant == "f32_3xtf32_wgmma":  # Q, K, V^T halves; the raw ring; flags; slack
        assert pl.smem_bytes == 2 * 2 * 128 * 128 + 2 * 2 * 2 * 64 * 128 + 2 * 2 * 64 * 68 * 4 \
            + 2 * 64 * 4 + 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_plan_feature_widths(dtype, d):
    dt = getattr(torch, dtype)
    pl = A.plan((2, 1000, 4, d), dt, view_strides(2, 1000, 4, d))
    f32 = "f32_3xtf32_wgmma" if d <= 64 else "f32_3xtf32"
    assert pl.variant == (f32 if dt == torch.float32 else "bf16_wgmma")
    # the compiled width at or above D (64 or 128; zeros fill the tail)
    assert pl.dp == max(d, 64) and pl.dp in A.WIDTHS
    assert pl.grid == (-(-1000 // pl.block_q), 8)
    assert 0 < pl.smem_bytes <= A.SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["odd_stride", "d36", "pointer"])
def test_flash_plan_takes_the_unaligned_variant(dtype, case):
    dt = getattr(torch, dtype)
    shape, strides, aligned = (2, 300, 2, 64), view_strides(2, 300, 2, 64), True
    if case == "odd_stride":  # a view of a [B, T, H, 65] tensor
        strides = ((300 * 2 * 65, 2 * 65, 65),) * 3
    elif case == "d36":  # rows of 72 bytes in bf16; f32 stays aligned
        shape, strides = (2, 300, 2, 36), view_strides(2, 300, 2, 36)
    else:
        aligned = False
    pl = A.plan(shape, dt, strides, aligned)
    f32_aligned = dt == torch.float32 and case == "d36"
    want = ("f32_3xtf32_wgmma" if f32_aligned else "f32_3xtf32_unaligned") \
        if dt == torch.float32 else "bf16_unaligned"
    assert pl.variant == want
    assert pl.dp == 64 and pl.smem_bytes <= A.SMEM_LIMIT


def test_flash_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        A.plan((1, 8, 1, 8), torch.float64)


def test_flash_constants_mirror_the_cuda_source():
    src = A.SOURCE.read_text()
    assert const(src, "kMKeys") == A.MMA_KEYS
    assert "static constexpr bool PRESPLIT = DP == 64;" in src and \
        "static constexpr int WARPS = PRESPLIT ? 8 : 4;" in src and A.MMA_WARPS == {64: 8, 128: 4}
    assert "static constexpr int valid = kv_lo + (PRESPLIT ? 2 * tile : 0);" in src
    assert (const(src, "kWRows"), const(src, "kWKeys")) == (A.WG_ROWS, A.WG_KEYS)
    assert "static constexpr int S = DP == 64 ? 8 : 5;" in src and A.WG_STAGES == {64: 8, 128: 5}
    assert "constexpr int kWThreads = 128 * 2 + 32;" in src and A.WG_THREADS == 288
    assert "static constexpr int LD = DP + 4;" in src  # smem_bytes() counts the row so
    assert re.search(r"enum Variant \{\s*kF32Tf32x3 = 0,\s*kF32Tf32x3Unaligned = 1,\s*"
                     r"kBf16Wgmma = 2,\s*kBf16Unaligned = 3,\s*kF32Tf32x3Wgmma = 4\s*\};", src)
    assert A.VARIANTS == ("f32_3xtf32", "f32_3xtf32_unaligned", "bf16_wgmma", "bf16_unaligned",
                          "f32_3xtf32_wgmma")
    assert (const(src, "kTRows"), const(src, "kTKeys"), const(src, "kTThreads")) == \
        (A.TF_ROWS, A.TF_KEYS, A.TF_THREADS)
    assert "static constexpr int LD = 68;" in src  # the raw ring's rows, as smem_bytes() counts
    # the f32 variants take both products as lo.hi + hi.lo + hi.hi
    assert "cvt.rna.tf32.f32" in src
    for i in ("j", "dn"):
        for a, b in (("al", "bh"), ("ah", "bl"), ("ah", "bh")):
            assert f"mma_tf32(part + 4 * {i}, {a}, {b}[{i}][0], {b}[{i}][1]);" in src
    # ... on wgmma too: S from shared halves, P.V from P's register halves
    for a, b in (("ql", "k_hi"), ("qh", "k_lo"), ("qh", "k_hi")):
        assert f"wgmma_tf32_ss(a, at({a}, L::box_q, kk), at(base + L::{b}, L::box_kv, kk)" in src
    for a, b in (("pl", "vt_hi"), ("ph", "vt_lo"), ("ph", "vt_hi")):
        assert f"wgmma_tf32_rs(part, {a}[kk], at(base + L::{b}, L::box_kv, kk)" in src


def test_tf32_round_matches_the_hardware_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12,
                      3.0 * 2 ** -20])
    got = A.tf32_round(x)
    # TF32 keeps 10 fraction bits: 1 + 2^-11 is a tie, rounded away from zero
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10), 1.0 + 2 ** -10,
                            3.0 * 2 ** -20]
    r = torch.randn(10_000)
    rel = ((A.tf32_round(r) - r).abs() / r.abs()).max().item()
    assert rel <= 2 ** -11


def _attention(q, k, v, mm, scale):
    """Causal softmax attention of the last rows of a T-row sequence with
    products by ``mm``, in the kernel's order: scores, f32 softmax, PV."""
    t = k.shape[0]
    rows = torch.arange(t - q.shape[0], t)
    s = mm(q, k.t()) * scale
    s = torch.where(torch.arange(t)[None, :] <= rows[:, None], s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return mm(p, v) / p.sum(-1, keepdim=True)


def test_3xtf32_split_keeps_the_f32_tolerance():
    # the path's statistics: q, k, v ~ N(0, 1), D = 64, scale 1/8, a causal
    # softmax over up to T = 4096 keys (the last 256 query rows: the longest)
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn(T, D, generator=g) for _ in range(2))
    q = torch.randn(256, D, generator=g)
    scale = 1.0 / math.sqrt(D)
    want = _attention(q.double(), k.double(), v.double(), torch.matmul, scale)
    split = _attention(q, k, v, A.matmul_3xtf32, scale)
    err = (split.double() - want).abs().max().item()
    assert err < 1e-5  # FLASH_F32_ATOL of chip_smoke.py
    # one pass of TF32 would not hold it: why the kernel splits
    one_pass = _attention(q, k, v, lambda a, b: torch.matmul(A.tf32_round(a), A.tf32_round(b)),
                          scale)
    assert (one_pass.double() - want).abs().max().item() > 1e-5


# ---------------------------------------------------------------------------
# lstm_seq
# ---------------------------------------------------------------------------

SERVED = [(b, t) for b in (1, 2, 4, 8, 16, 32, 64) for t in (32, 64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", SERVED, ids=[f"B{b}-T{t}" for b, t in SERVED])
def test_lstm_plan_is_persistent_on_every_served_bucket(b, t, dtype):
    pl = L.plan(b, 512, getattr(torch, dtype))
    assert pl.variant == "persistent"
    rows = 8 * pl.rt
    assert pl.groups == -(-b // rows) and (pl.groups - 1) * rows < b
    # one block on every SM at most: the cooperative grid is co-resident
    assert pl.grid == (512 // L.P_UNITS) * pl.groups <= L.H100_SMS
    # the Wh slice (every K row of 8 units x 4 gates, f32) and h rows and
    # partials fit a block's shared memory
    kp = L.k_padded(512)
    assert kp == 512 and pl.smem_bytes == L.persistent_smem(pl.rt, 512) <= L.SMEM_LIMIT
    assert kp * 4 * L.P_UNITS * 4 < pl.smem_bytes
    # the smallest rows per lane whose grid fits
    smaller = [rt for rt in L.P_ROWS_PER_LANE if rt < pl.rt]
    assert all(512 // L.P_UNITS * -(-b // (8 * rt)) > L.H100_SMS for rt in smaller)


@pytest.mark.parametrize("b,h,variant", [(8, 1024, "persistent"), (16, 1024, "persistent"),
                                         (64, 1024, "step_cluster"), (5, 100, "persistent"),
                                         (100, 512, "step_cluster"), (3, 102, "step_cluster")])
def test_lstm_plan_at_other_widths(b, h, variant):
    pl = L.plan(b, h, torch.float32)
    assert pl.variant == variant
    assert 0 < pl.smem_bytes <= L.SMEM_LIMIT
    if variant == "persistent":
        assert pl.grid == -(-h // 8) * pl.groups <= L.H100_SMS and pl.split == 0
        assert L.k_padded(h) >= h and L.k_padded(h) % (4 * L.P_WARPS) == 0
    else:
        assert pl.split == L.step_split(b, h, L.H100_SMS) in (1, 2, 4, 8)


def test_lstm_plan_follows_the_card():
    # fewer SMs or less shared memory push a shape to the step variant
    assert L.plan(64, 512, torch.float32).variant == "persistent"
    assert L.plan(64, 512, torch.float32, sms=100).variant == "step_cluster"
    assert L.plan(64, 512, torch.float32, smem_limit=100_000).variant == "step_cluster"
    with pytest.raises(TypeError):
        L.plan(1, 8, torch.float64)


def test_lstm_constants_mirror_the_cuda_source():
    src = L.SOURCE.read_text()
    assert (const(src, "kPUnits"), const(src, "kPWarps"), const(src, "kRedLd")) == \
        (L.P_UNITS, L.P_WARPS, L.P_RED_LD)
    assert (const(src, "kUnits"), const(src, "kRows"), const(src, "kMaxSplit"),
            const(src, "kMinKPerBlock")) == (L.S_UNITS, L.S_ROWS, L.S_MAX_SPLIT, L.S_MIN_K)
    assert "enum Variant { kPersistent = 0, kStepCluster = 1 };" in src
    assert L.VARIANTS == ("persistent", "step_cluster")
    assert "cudaLaunchAttributeCooperative" in src and "ld.acquire.gpu" in src
    assert "kp * kPCols + 8 * rt * (kp + 4) + kPWarps * 8 * rt * kRedLd" in src


def test_cpu_tensors_count_no_launch_of_any_variant():
    before = (dict(A.launches_by_variant), dict(L.launches_by_variant))
    q = torch.randn(1, 16, 2, 8)
    A.flash_attention_fwd(q, q, q, causal=True)
    L.lstm_seq(torch.randn(3, 2, 32), torch.randn(8, 32), torch.zeros(2, 8), torch.zeros(2, 8))
    assert (A.launches_by_variant, L.launches_by_variant) == before
    for mod in (A, L):
        mod.reset_launches()
        assert set(mod.launches_by_variant) == set(mod.VARIANTS)
        assert not any(mod.launches_by_variant.values()) and mod.launches == 0


@pytest.mark.parametrize("kind", ["flash", "lstm", "flash_bwd"])
def test_ablation_edits_find_their_code(kind):
    # ops/ablation.py switches parts of the kernels off by editing their
    # sources: every edit must still find its text, and only base is unedited
    from deeplearning4j_tpu_torch.ops import ablation as X

    source, variants, after = {"flash": (A.SOURCE, X.FLASH, X.TF32_KERNEL),
                               "lstm": (L.SOURCE, X.LSTM, None),
                               "flash_bwd": (A.BWD_WGMMA_SOURCE, X.FLASH_BWD, None)}[kind]
    src = source.read_text()
    for name, edits in variants.items():
        assert (X.variant_source(src, edits, after) == src) == (name == "base")
    with pytest.raises(ValueError):
        X.variant_source(src, [("no such text", "")], after)
