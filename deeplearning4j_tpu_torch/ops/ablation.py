"""Where the time of the flash-attention and LSTM kernels goes, by ablation.

Each variant is a kernel source with one part switched off, so its results
are wrong and only its time is read:

- the f32 flash forward (``f32_3xtf32_wgmma``) at the LM path's shape (B=4,
  T=4096, H=8, D=64, causal, q, k, v views of one projection) without the
  per-tile TF32 split of K and V, without the softmax, or with one TF32
  product in place of three in both products; beside it the ``mma.sync``
  body on the same inputs (``f32_3xtf32_unaligned``, reached through a view
  4 bytes off alignment) and the bf16 forward;
- the persistent ``lstm_seq`` (f32, peepholes, T=128, H=512, B in 1, 8, 64)
  without its grid barrier, without its copy of h_prev, or without both.

The variants are built beside the real kernels into ``_build/ablation/``
and timed on the card (calls queued behind a sleep, median of 5 x 10).
Run on an H100: ``python -m deeplearning4j_tpu_torch.ops.ablation``. It
prints one JSON line a variant, then the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops import attention as A
from deeplearning4j_tpu_torch.ops import lstm_seq as L

TF32_KERNEL = "flash_tf32_wgmma_kernel(Params p) {"
SPLIT_KV = ("    split_rows<kTKeys>(ks, sb + L::k_hi, sb + L::k_lo, L::box_kv, tid);\n"
            "    split_vt(ks + kTKeys * L::LD, sb + L::vt_hi, sb + L::vt_lo, tid);\n")
SOFTMAX = ("softmax_tile<8, false>(s, m, l, alpha, p.scale, 0u, k0 + 2 * t4, row, 0);",
           "softmax_tile<8>(s, m, l, alpha, p.scale, keyok, k0 + 2 * t4, row, p.causal);")
S_LINES = ("          wgmma_tf32_ss(a, at(ql, L::box_q, kk), at(base + L::k_hi, L::box_kv, kk),\n",
           "          wgmma_tf32_ss(a, at(qh, L::box_q, kk), at(base + L::k_lo, L::box_kv, kk), 1);\n",
           "          wgmma_tf32_ss(a, at(qh, L::box_q, kk), at(base + L::k_hi, L::box_kv, kk), 1);\n")
PV_LINES = ("        wgmma_tf32_rs(part, pl[kk], at(base + L::vt_hi, L::box_kv, kk), kk > 0);\n",
            "        wgmma_tf32_rs(part, ph[kk], at(base + L::vt_lo, L::box_kv, kk), 1);\n",
            "        wgmma_tf32_rs(part, ph[kk], at(base + L::vt_hi, L::box_kv, kk), 1);\n")
# (old, new) replacements in the TF32 wgmma kernel's body
FLASH = {
    "base": [],
    "no_kv_split": [(SPLIT_KV, "")],
    "no_softmax": [(s, "alpha[0] = alpha[1] = 1.f;") for s in SOFTMAX],
    "one_tf32_product": [(S_LINES[0], S_LINES[0].replace("at(ql,", "at(qh,")),
                         (S_LINES[1], ""), (S_LINES[2], ""),
                         (PV_LINES[0], PV_LINES[0].replace("pl[kk]", "ph[kk]")),
                         (PV_LINES[1], ""), (PV_LINES[2], "")],
}
BARRIER = "if (t + 1 < p.T) grid_barrier(p.sync, blocks, target);"
COPY = "cp_async16(smem_u32(h_s + r * S + k)"
LSTM = {
    "base": [],
    "no_barrier": [(BARRIER, "if (t + 1 < p.T) __syncthreads();")],
    "no_h_copy": [(COPY, "if (0) " + COPY)],
    "neither": [(BARRIER, "if (t + 1 < p.T) __syncthreads();"), (COPY, "if (0) " + COPY)],
}


def variant_source(src, edits, after=None):
    """``src`` with each (old, new) edit made in the text after ``after``
    (all of it when None); every ``old`` must be there."""
    head, tail = ("", src) if after is None else src.split(after, 1)
    for old, new in edits:
        if old not in tail:
            raise ValueError(f"ablation edit not found: {old!r}")
        tail = tail.replace(old, new)
    return head + ("" if after is None else after) + tail


def write_variants(source, variants, after=None):
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in variants.items():
        path = out / f"{source.stem}_{name}.cu"
        path.write_text(variant_source(source.read_text(), edits, after))
        paths[name] = path
    return paths


def device_ms(fn, iters=10, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return statistics.median(out)


def timed_with(mod, lib, fn):
    """``fn``'s time with ``mod`` launching from ``lib`` in place of its own."""
    own = mod._LIB
    mod._LIB = lib
    try:
        return device_ms(fn)
    finally:
        mod._LIB = own


def main():
    flash = write_variants(A.SOURCE, FLASH, after=TF32_KERNEL)
    lstm = write_variants(L.SOURCE, LSTM)
    libs = {("flash", n): _build.Library(p, A._declare) for n, p in flash.items()}
    libs.update({("lstm", n): _build.Library(p, L._declare) for n, p in lstm.items()})
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.get(), libs.values()))

    rs = np.random.RandomState(0)
    b, t, h, d = 4, 4096, 8, 64
    base = torch.from_numpy(rs.randn(b * t * 3 * h * d + 1).astype(np.float32)).cuda()
    for offset, dtype in ((0, torch.float32), (1, torch.float32), (0, torch.bfloat16)):
        qkv = base[offset:offset + b * t * 3 * h * d].to(dtype).view(b, t, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        strides = tuple(tuple(x.stride()[:3]) for x in (q, k, v))
        pl = A.plan((b, t, h, d), dtype, strides, all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
        names = FLASH if pl.variant == "f32_3xtf32_wgmma" else {"base": []}
        with torch.no_grad():
            for name in names:
                ms = timed_with(A, libs["flash", name],
                                lambda: A.flash_attention_fwd(q, k, v, causal=True))
                print(json.dumps({"kernel": "flash_attn", "variant": pl.variant, "ablation": name,
                                  "B": b, "T": t, "H": h, "D": d, "device_ms": ms}), flush=True)
    for batch in (1, 8, 64):
        hsz = 512
        f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
        xz, wh = f(rs.randn(128, batch, 4 * hsz)), f(rs.randn(hsz, 4 * hsz) / np.sqrt(hsz))
        h0, c0, wp = f(0.1 * rs.randn(batch, hsz)), f(0.1 * rs.randn(batch, hsz)), \
            f(0.1 * rs.randn(3, hsz))
        for name in LSTM:
            ms = timed_with(L, libs["lstm", name], lambda: L.lstm_seq(xz, wh, h0, c0, wp=wp))
            print(json.dumps({"kernel": "lstm_seq", "variant": L.plan(batch, hsz, torch.float32)
                              .variant, "ablation": name, "T": 128, "B": batch, "H": hsz,
                              "device_ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
