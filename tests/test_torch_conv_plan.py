"""The conv-statistics kernels' launch plan (``ops/conv_stats.plan``), on the
CPU: for every conv of the fused ResNet50 at batch 64 and for the edge
cases the chip smoke holds the kernels at, in both dtypes, the plan's
persistent schedule covers every output tile once, the partials buffer has
the rows the kernel writes, the block's shared memory fits, and the variant
follows the channel alignment. The constants the plan mirrors are read back
from the CUDA source."""

from __future__ import annotations

import re

import pytest
import torch

from deeplearning4j_tpu_torch.models import resnet50
from deeplearning4j_tpu_torch.ops import conv_stats as C

BATCH = 64


def resnet_geometries():
    """(kernel, stride, x shape, Cout) of every distinct conv-kernel call in
    the fused ResNet50 at batch 64, 224x224."""
    conf = resnet50(224, 224, n_classes=1000, fused=True)
    types = conf.vertex_types()
    calls = []
    for v in conf.vertices:
        if type(v.vertex).__name__ != "FusedConvBNVertex":
            continue
        it = types[v.inputs[0]]
        calls.append((tuple(v.vertex.kernel), tuple(v.vertex.stride),
                      (BATCH, it.height, it.width, it.channels), v.vertex.n_out))
    return calls


CALLS = resnet_geometries()
PATH = list(dict.fromkeys(CALLS))
EDGE = [((1, 1), (1, 1), (3, 7, 7, 48), 96),
        ((1, 1), (1, 1), (5, 7, 9, 20), 72),
        ((1, 1), (2, 2), (3, 7, 7, 48), 96),
        ((3, 3), (1, 1), (3, 7, 7, 48), 96),
        ((3, 3), (2, 2), (BATCH, 56, 56, 64), 64),
        ((3, 3), (2, 2), (2, 10, 12, 40), 70)]
CASES = [(g, on_path, dt) for g, on_path in [(g, True) for g in PATH] + [(g, False) for g in EDGE]
         for dt in ("float32", "bfloat16")]


def test_the_path_has_its_52_calls_in_19_geometries():
    assert len(CALLS) == 52 and len(PATH) == 19
    assert sum(k == (1, 1) for k, *_ in CALLS) == 36


@pytest.mark.parametrize("geom,on_path,dtype", CASES,
                         ids=[f"{g[0][0]}x{g[0][0]}s{g[1][0]}-{'x'.join(map(str, g[2]))}-{g[3]}-"
                              f"{dt}" for g, _, dt in CASES])
def test_plan(geom, on_path, dtype):
    (kernel, stride, shape, cout), dt = geom, getattr(torch, dtype)
    pl = C.plan(kernel[0], shape, cout, stride, dt)
    b, h, w, cin = shape
    m = b * -(-h // stride[0]) * -(-w // stride[1])

    # the tiles cover the output, and the persistent schedule takes each once
    assert pl.row_tiles == -(-m // pl.bm) and pl.col_tiles == -(-cout // pl.bn)
    assert (pl.row_tiles - 1) * pl.bm < m <= pl.row_tiles * pl.bm
    taken = sorted(t for block in C.schedule(pl) for t in block)
    assert taken == list(range(pl.tiles))
    assert 1 <= pl.grid <= pl.tiles
    if pl.blocks_per_sm:
        assert pl.grid == min(pl.tiles, C.H100_SMS * pl.blocks_per_sm)
    # the partials buffer [row_tiles, 2, Cout] has the row of every tile
    assert max(t // pl.col_tiles for t in taken) == pl.row_tiles - 1

    # the block's shared memory fits, and all blocks_per_sm of it fit an SM
    assert 0 < pl.smem_bytes <= C.SMEM_LIMIT
    assert pl.smem_bytes * max(pl.blocks_per_sm, 1) <= C.SMEM_LIMIT

    # the variant follows dtype and channel alignment
    if dt == torch.bfloat16:
        aligned = cin % 8 == 0 and cout % 8 == 0
        assert pl.variant == ("bf16_wgmma" if aligned else "bf16_unaligned")
    else:
        aligned = cin % 4 == 0 and cout % 4 == 0
        assert pl.variant == ("f32_pipelined" if aligned else "f32_unaligned")
    if on_path:
        assert pl.variant in ("bf16_wgmma", "f32_pipelined")
        assert pl.bn == (64 if cout <= 64 else 128)
        # every SM gets a tile, but for bf16_wgmma, whose 128-row tiles leave
        # SMs idle on the 7x7 stage (100 tiles) and still beat 64-row tiles
        # on every SM there on the H100
        assert pl.tiles >= C.H100_SMS or (pl.variant == "bf16_wgmma" and pl.tiles >= 96)
        assert pl.grid == min(pl.tiles, C.H100_SMS * pl.blocks_per_sm)
    # misaligned pointers take the unaligned variant too
    if pl.variant in ("bf16_wgmma", "f32_pipelined"):
        off = C.plan(kernel[0], shape, cout, stride, dt, aligned=False)
        assert off.variant == pl.variant.split("_")[0] + "_unaligned"


def test_plan_constants_mirror_the_cuda_source():
    src = C.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kStages"), const("kWBK")) == (C.WG_STAGES, C.WG_BK)
    assert "static constexpr int NWG = 2;" in src and C.WG_BM == 128
    assert (const("kFStages"), const("kFBK")) == (C.F32_STAGES, C.F32_BK)
    assert "constexpr int kFALd = kFBK + 4;" in src  # smem_bytes() counts the A row so
    assert (const("kUBM"), const("kUBN"), const("kUBK")) == (C.U_BM, C.U_BN, C.U_BK)
    assert C.VARIANTS == ("bf16_wgmma", "bf16_unaligned", "f32_pipelined", "f32_unaligned")
    assert re.search(r"enum Variant \{ kBf16Wgmma = 0, kBf16Unaligned = 1, kF32Pipelined = 2, "
                     r"kF32Unaligned = 3 \};", src)


def test_plan_tile_heights_and_refuses_other_dtypes():
    # the 7x7 stage: f32 takes 64-row tiles so that every SM has one;
    # bf16_wgmma keeps 128 rows (faster there, measured)
    assert C.plan(3, (BATCH, 7, 7, 512), 512, (1, 1), torch.float32).bm == 64
    assert C.plan(3, (BATCH, 7, 7, 512), 512, (1, 1), torch.bfloat16).bm == 128
    assert C.plan(3, (BATCH, 56, 56, 64), 64, (1, 1), torch.float32).bm == 128
    with pytest.raises(TypeError):
        C.plan(1, (1, 4, 4, 8), 8, (1, 1), torch.float64)


def test_cpu_tensors_count_no_launch_of_any_variant():
    before = dict(C.launches_by_variant)
    x = torch.randn(2, 5, 5, 8)
    C.conv3x3_stats(x, torch.randn(3, 3, 8, 16))
    C.conv_mm_stats(x, torch.randn(8, 16), (2, 2))
    assert C.launches_by_variant == before
    C.reset_launches()
    assert set(C.launches_by_variant) == set(C.VARIANTS)
    assert not any(C.launches_by_variant.values()) and not any(C.launches.values())
