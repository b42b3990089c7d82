#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure raises and exits
nonzero; nothing is caught):

1. env      torch/CUDA versions, the card's name and power limit.
2. build    nvcc builds of ``csrc/lstm_seq.cu`` and ``csrc/flash_attn.cu``,
            started together, with their ptxas reports.
3. kernels  ``lstm_seq`` held against ``lstm_seq_plain`` on the card, f32
            and bf16, with and without peepholes and mask, at the served
            shapes (T=128, H=512, B in {1, 8, 64}), at H=1024 and at a
            ragged H=100; with the kernel's time, the plain loop's time, the
            bound and cuDNN's ``torch.nn.LSTM`` as a yardstick.
4. flash    ``flash_attn`` held against ``flash_attention_plain`` on the
            card (out and lse), and the autograd.Function's dq/dk/dv
            against autograd through the plain version: B=4, H=8,
            T in {1000, 4096}, D in {64, 128}, f32 and bf16, causal or not,
            with and without a [B,T] key mask whose last row is fully
            masked; q, k, v are views of one [B,T,3,H,D] tensor, as the
            fused projection leaves them. Times at the training path's
            shape (T=4096, D=64, causal) beside the bound, the plain
            version and ``scaled_dot_product_attention`` as a yardstick;
            then the kernel against the port's naive attention, forward and
            backward, at T in {256, ..., 4096}: the length crossover.
5. train    ``transformer_lm`` at the width of the JAX package's long-context
            bench (vocab 8192, 6 x 512, 8 heads, seq 4096; 29,408,256
            params, random weights from the seed) trained by
            ``MultiLayerNetwork.fit`` at batch 4 on a learnable synthetic
            sequence, under the f32 policy and ``bf16_policy``: 2 warm-up
            steps then 10 timed ones, 6 flash launches a step, the last loss
            below the first; and one step from identical weights with the
            plain attention forward agreeing with the kernel's step.
            After each, one step under ``torch.profiler``: device time by
            family and the device's busy share.
6. serve    the GravesLSTM char-RNN at full width (vocab 96, 2 x 512,
            seq 128; weights from a numpy seed), round-tripped through
            ``save_model``/``load_model`` and served through
            ``ModelRegistry`` on (batch, seq) buckets: a few hundred
            requests of mixed lengths and batch sizes, every result checked
            against the plain functions on the card, and the kernel's
            launch count checked against the device forwards.
7. profile  one char-RNN forward at the largest bucket under
            ``torch.profiler``: device time by kernel family and busy share.
8. cli      ``python -m deeplearning4j_tpu_torch serve --smoke 64``.

Then a ``kernels`` line (every kernel of the two paths with its launches on
its path, error, times and bound), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.

Tolerances: lstm_seq f32 kernel vs plain, atol 1e-4 (the two sum the
recurrent product in different orders over 128 dependent steps); bf16
operands, atol 2e-2 + rtol 2e-2 (outputs are stored in bf16, whose ulp is
2^-8 relative, and a last-bit difference in h feeds every later step);
served softmax outputs vs the plain forward, atol 1e-4. flash_attn f32 out
atol 1e-5 (one softmax-weighted sum per row, in another order), lse atol
1e-5 + rtol 1e-6 (lse is ~10 at T=4096, where an f32 ulp is ~1e-6);
gradients atol 1e-5 + rtol 1e-4 (sums over up to 4096 rows); bf16 2e-2 +
2e-2·|x| (the kernel rounds p to bf16 against the running max, the plain
version against the final one; one bf16 ulp is 2^-8). Training: the
kernel step and the plain-attention step agree to loss rtol 1e-4, and
to updated parameters atol 1e-4 under the f32 policy; under bf16_policy,
where one-ulp operand flips move near-zero gradient elements by their own
size and Adam's first step amplifies that to up to 2·lr, each tensor's
gradient to a relative difference of 1e-2 (parameter difference
reported).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

F32_ATOL = 1e-4
BF16_ATOL = BF16_RTOL = 2e-2
SERVE_ATOL = 1e-4

VOCAB, HIDDEN, SEQ = 96, 512, 128
N_PARAMS = 3_398_752
SEED = 12345

FLASH_F32_ATOL = 1e-5
FLASH_LSE_ATOL, FLASH_LSE_RTOL = 1e-5, 1e-6
FLASH_GRAD_ATOL, FLASH_GRAD_RTOL = 1e-5, 1e-4
FLASH_BF16_TOL = 2e-2
STEP_LOSS_RTOL, STEP_PARAM_ATOL, STEP_BF16_GRAD_RTOL = 1e-4, 1e-4, 1e-2

# the JAX package's long-context bench: transformer_lm(8192, 6 layers,
# d_model 512, 8 heads, seq 4096) at batch 4
LM_VOCAB, LM_LAYERS, LM_WIDTH, LM_HEADS, LM_SEQ, LM_BATCH = 8192, 6, 512, 8, 4096, 4
LM_PARAMS = 29_408_256
WARMUP_STEPS, TIMED_STEPS = 2, 10
CROSSOVER_T = (256, 512, 1024, 2048, 4096)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, *, iters, reps):
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return statistics.median(out)


def bound(t, b, h, dtype, peephole, mask):
    """Least time (ms) for one lstm_seq call and what sets it: every input
    read once and every output written once over the memory rate, against
    the recurrent product's 2*T*B*H*4H operations over the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    n_in = t * b * 4 * h + h * 4 * h + 2 * b * h + (3 * h if peephole else 0)
    n_out = 2 * t * b * h + 2 * b * h
    nbytes = elt * (n_in + n_out) + (4 * t * b if mask else 0)
    ops = 2 * t * b * h * 4 * h
    by_bytes = 1e3 * nbytes / PEAK_BYTES_S
    by_ops = 1e3 * ops / PEAK_OPS_S[dtype]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def lstm_inputs(rs, t, b, h, dtype, peephole, mask):
    def cuda(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)
    xz = cuda(rs.randn(t, b, 4 * h))
    wh = cuda(rs.randn(h, 4 * h) / np.sqrt(h))
    h0 = cuda(0.1 * rs.randn(b, h))
    c0 = cuda(0.1 * rs.randn(b, h))
    wp = cuda(0.1 * rs.randn(3, h)) if peephole else None
    m = None
    if mask:
        lens = rs.randint(1, t + 1, size=b)
        m = cuda((np.arange(t)[:, None] < lens[None, :]).astype(np.float32), torch.float32)
    return xz, wh, h0, c0, wp, m


def cudnn_lstm(xz, wh, h0, c0):
    """torch.nn.LSTM computing the no-peephole, no-mask lstm_seq on the same
    xz: the input projection is the identity and W_hh = Wh^T (PyTorch's
    gate order i|f|g|o is the kernel's)."""
    h = wh.shape[0]
    mod = torch.nn.LSTM(4 * h, h, bias=False).to("cuda", xz.dtype)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(torch.eye(4 * h, device="cuda", dtype=xz.dtype))
        mod.weight_hh_l0.copy_(wh.t())
    state = (h0.to(xz.dtype)[None].contiguous(), c0.to(xz.dtype)[None].contiguous())
    return lambda: mod(xz, state)


def cudnn_recurrence(wh, h0, c0, t):
    """torch.nn.LSTM's recurrence alone with the same Wh, h0 and c0 (a
    1-wide zero input, so no input projection): a yardstick for the time
    cuDNN spends on the T dependent steps, not the same function."""
    h = wh.shape[0]
    mod = torch.nn.LSTM(1, h, bias=False).to("cuda", wh.dtype)
    with torch.no_grad():
        mod.weight_ih_l0.zero_()
        mod.weight_hh_l0.copy_(wh.t())
    x = torch.zeros(t, h0.shape[0], 1, device="cuda", dtype=wh.dtype)
    state = (h0[None].contiguous(), c0[None].contiguous())
    return lambda: mod(x, state)


def phase_kernels(L):
    rs = np.random.RandomState(SEED)
    cases, timings, max_err_path = [], [], 0.0
    shapes = [(SEQ, 1, HIDDEN), (SEQ, 8, HIDDEN), (SEQ, 64, HIDDEN), (SEQ, 8, 1024), (SEQ, 5, 100)]
    for t, b, h in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for peephole in (False, True):
                for mask in (False, True):
                    args = lstm_inputs(rs, t, b, h, dtype, peephole, mask)
                    got = L.lstm_seq(*args[:4], wp=args[4], mask=args[5])
                    want = L.lstm_seq_plain(*args[:4], wp=args[4], mask=args[5])
                    torch.cuda.synchronize()
                    err = 0.0
                    for name, g, w in zip(("hs", "cs", "hT", "cT"), got, want):
                        g, w = g.float(), w.float()
                        if not torch.isfinite(g).all():
                            raise AssertionError(f"lstm_seq {name} not finite at {(t, b, h, dtype)}")
                        err = max(err, (g - w).abs().max().item())
                        if dtype == torch.float32:
                            ok = torch.allclose(g, w, rtol=0.0, atol=F32_ATOL)
                        else:
                            ok = torch.allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)
                        if not ok:
                            raise AssertionError(
                                f"lstm_seq {name} disagrees with lstm_seq_plain at T={t} B={b} "
                                f"H={h} {dtype} peephole={peephole} mask={mask}: max|diff|={err}")
                    if dtype == torch.float32 and h == HIDDEN:
                        max_err_path = max(max_err_path, err)
                    cases.append({"T": t, "B": b, "H": h, "dtype": str(dtype).split(".")[-1],
                                  "peephole": peephole, "mask": mask, "max_abs_err": err})
        # timings in f32: the served variant (peepholes, no mask), and the
        # no-peephole variant beside cuDNN's nn.LSTM on the same inputs
        xz, wh, h0, c0, wp, _ = lstm_inputs(rs, t, b, h, torch.float32, True, False)
        iters = 10
        ms = time_ms(lambda: L.lstm_seq(xz, wh, h0, c0, wp=wp), iters=iters, reps=5)
        ms_nopeep = time_ms(lambda: L.lstm_seq(xz, wh, h0, c0), iters=iters, reps=5)
        plain_ms = time_ms(lambda: L.lstm_seq_plain(xz, wh, h0, c0, wp=wp), iters=2, reps=3)
        library_ms = time_ms(cudnn_lstm(xz, wh, h0, c0), iters=iters, reps=5)
        recurrence_ms = time_ms(cudnn_recurrence(wh, h0, c0, t), iters=iters, reps=5)
        bound_ms, bound_by = bound(t, b, h, torch.float32, True, False)
        row = {"T": t, "B": b, "H": h, "dtype": "float32", "cluster_split": L.cluster_split(b, h),
               "ms": ms, "ms_no_peephole": ms_nopeep,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_recurrence_ms": recurrence_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        timings.append(row)
        emit("kernels.timing", **row)
    emit("kernels", name="lstm_seq", cases=len(cases), f32_atol=F32_ATOL,
         bf16_atol=BF16_ATOL, bf16_rtol=BF16_RTOL,
         max_abs_err_f32=max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
         max_abs_err_bf16=max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"))
    return timings, max_err_path



# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def qkv_views(rs, b, t, h, d, dtype, grad=False):
    """q, k, v as views of one [B,T,3,H,D] tensor (the layout the fused QKV
    projection leaves), and that tensor."""
    qkv = torch.from_numpy(rs.randn(b, t, 3, h, d).astype(np.float32)).to("cuda", dtype)
    qkv.requires_grad_(grad)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], qkv


def key_mask(rs, b, t):
    """[B,T] key mask: ragged lengths, the last batch row fully masked."""
    lens = rs.randint(1, t + 1, size=b)
    lens[-1] = 0
    return torch.from_numpy((np.arange(t)[None, :] < lens[:, None]).astype(np.float32)).cuda()


def flash_bound(b, t, h, d, dtype, causal):
    """Least time (ms) for one flash forward and what sets it: q, k, v read
    and out, lse written once over the memory rate, against the two
    products' operations over the dtype's peak, counting only the query-key
    pairs the causal mask leaves."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * 4 * b * t * h * d + 4 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * b * h * d * pairs
    by_bytes = 1e3 * nbytes / PEAK_BYTES_S
    by_ops = 1e3 * ops / PEAK_OPS_S[dtype]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def check_close(what, got, want, atol, rtol):
    """Max |got - want|; raises unless every element is finite and within
    atol + rtol·|want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: not finite")
    err = (got - want).abs()
    if (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{what}: max|diff| {err.max().item()} beyond atol {atol} "
                             f"+ rtol {rtol}")
    return err.max().item()


def phase_flash(A):
    rs = np.random.RandomState(SEED + 1)
    b, h = LM_BATCH, LM_HEADS
    cases, path_err = [], None
    for t in (1000, LM_SEQ):
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                for causal in (False, True):
                    for masked in (False, True):
                        f32 = dtype == torch.float32
                        q, k, v, _ = qkv_views(rs, b, t, h, d, dtype, grad=True)
                        m = key_mask(rs, b, t) if masked else None
                        what = f"flash_attn T={t} D={d} {dtype} causal={causal} mask={masked}"
                        with torch.no_grad():
                            out_k, lse_k = A.flash_attention_fwd(q, k, v, mask=m, causal=causal)
                            out_p, lse_p = A.flash_attention_plain(q, k, v, mask=m,
                                                                   causal=causal)
                        torch.cuda.synchronize()
                        tol = (FLASH_F32_ATOL, 0.0) if f32 else (FLASH_BF16_TOL, FLASH_BF16_TOL)
                        errs = {"out": check_close(f"{what} out", out_k, out_p, *tol),
                                "lse": check_close(f"{what} lse", lse_k, lse_p,
                                                   FLASH_LSE_ATOL, FLASH_LSE_RTOL)}
                        g = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32)).to(
                            "cuda", dtype)
                        got = torch.autograd.grad(
                            A.flash_attention(q, k, v, mask=m, causal=causal), (q, k, v), g)
                        want = torch.autograd.grad(
                            A.flash_attention_plain(q, k, v, mask=m, causal=causal)[0],
                            (q, k, v), g)
                        gtol = (FLASH_GRAD_ATOL, FLASH_GRAD_RTOL) if f32 else \
                            (FLASH_BF16_TOL, FLASH_BF16_TOL)
                        for name, a, w in zip(("dq", "dk", "dv"), got, want):
                            errs[name] = check_close(f"{what} {name}", a, w, *gtol)
                        if masked and (out_k[-1].any() or (lse_k[-1] != A.NEG_INF).any()):
                            raise AssertionError(f"{what}: the fully masked row is not 0 "
                                                 "with the lse sentinel")
                        cases.append({"T": t, "D": d, "dtype": str(dtype).split(".")[-1],
                                      "causal": causal, "mask": masked, **errs})
                        if (t, d, f32, causal, masked) == (LM_SEQ, LM_WIDTH // LM_HEADS, True,
                                                           True, False):
                            path_err = max(errs.values())
                        del q, k, v, got, want, out_k, out_p, lse_k, lse_p
    torch.cuda.empty_cache()
    emit("flash", cases=len(cases), f32_atol=FLASH_F32_ATOL, lse_atol=FLASH_LSE_ATOL,
         lse_rtol=FLASH_LSE_RTOL, grad_atol=FLASH_GRAD_ATOL, grad_rtol=FLASH_GRAD_RTOL,
         bf16_tol=FLASH_BF16_TOL,
         max_abs_err_f32={k: max(c[k] for c in cases if c["dtype"] == "float32")
                          for k in ("out", "lse", "dq", "dk", "dv")},
         max_abs_err_bf16={k: max(c[k] for c in cases if c["dtype"] == "bfloat16")
                           for k in ("out", "lse", "dq", "dk", "dv")})

    timings = {}
    d = LM_WIDTH // LM_HEADS
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = qkv_views(rs, b, LM_SEQ, h, d, dtype)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        with torch.no_grad():
            ms = time_ms(lambda: A.flash_attention_fwd(q, k, v, causal=True), iters=10, reps=5)
            plain_ms = time_ms(lambda: A.flash_attention_plain(q, k, v, causal=True),
                               iters=10, reps=5)
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), iters=10, reps=5)
        bound_ms, bound_by = flash_bound(b, LM_SEQ, h, d, dtype, True)
        row = {"B": b, "T": LM_SEQ, "H": h, "D": d, "causal": True,
               "dtype": str(dtype).split(".")[-1], "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "card": card_line()}
        timings[dtype] = row
        emit("flash.timing", **row)
        del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return timings, path_err


def phase_crossover(TA):
    """The kernel against the port's naive attention, forward + backward,
    B=4, H=8, D=64, causal, f32: the length from which the kernel wins."""
    rs = np.random.RandomState(SEED + 2)
    b, h, d = LM_BATCH, LM_HEADS, LM_WIDTH // LM_HEADS
    rows = []
    for t in CROSSOVER_T:
        q, k, v, qkv = qkv_views(rs, b, t, h, d, torch.float32, grad=True)
        g = torch.randn(b, t, h, d, device="cuda")

        def run(min_seq):
            out = TA.dot_product_attention(q, k, v, causal=True, min_seq=min_seq)
            torch.autograd.grad(out, qkv, g)
        flash_ms = time_ms(lambda: run(0), iters=3, reps=5)
        naive_ms = time_ms(lambda: run(1 << 30), iters=3, reps=5)
        rows.append({"T": t, "flash_ms": flash_ms, "naive_ms": naive_ms,
                     "speedup": naive_ms / flash_ms})
        del q, k, v, qkv, g
        torch.cuda.empty_cache()
    crossover = None
    for i, r in enumerate(rows):
        if all(x["speedup"] > 1.0 for x in rows[i:]):
            crossover = r["T"]
            break
    emit("flash.crossover", B=b, H=h, D=d, causal=True, dtype="float32", rows=rows,
         crossover_T=crossover, min_seq_in_port=TA.MIN_SEQ, card=card_line())
    return crossover


# ---------------------------------------------------------------------------
# training the transformer LM
# ---------------------------------------------------------------------------

def lm_data(rs, n):
    """n sequences of a rule a model can learn, ids[t+1] = (5 ids[t] + 3)
    mod V from random starts: x [n,T,1] f32 ids and y [n,T,V] one-hot next
    ids, as the JAX package's bench builds them, on the card."""
    ids = np.zeros((n, LM_SEQ + 1), np.int64)
    ids[:, 0] = rs.randint(0, LM_VOCAB, size=n)
    for t in range(LM_SEQ):
        ids[:, t + 1] = (5 * ids[:, t] + 3) % LM_VOCAB
    x = torch.from_numpy(ids[:, :LM_SEQ, None].astype(np.float32)).cuda()
    y = torch.nn.functional.one_hot(torch.from_numpy(ids[:, 1:]).cuda(), LM_VOCAB).float()
    return x, y


def make_lm(seed):
    from deeplearning4j_tpu_torch.models.misc import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(transformer_lm(LM_VOCAB, n_layers=LM_LAYERS, d_model=LM_WIDTH,
                                           n_heads=LM_HEADS, seq_len=LM_SEQ), device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != LM_PARAMS:
        raise AssertionError(f"transformer_lm has {net.num_params()} params, "
                             f"expected {LM_PARAMS}")
    return net


@contextlib.contextmanager
def plain_attention_forward(A):
    """Within this block the flash autograd.Function computes its forward
    with ``flash_attention_plain`` on the card instead of the kernel (the
    blockwise backward is the same)."""
    saved = A.flash_attention_fwd
    A.flash_attention_fwd = lambda q, k, v, **kw: A.flash_attention_plain(q, k, v, **kw)
    try:
        yield
    finally:
        A.flash_attention_fwd = saved


def one_step(net, x, y):
    """The first step of ``fit``: gradients, then the updater from fresh
    state. Returns the loss and the gradient leaves."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    loss, _, grads = net.compute_gradients(net.params, net.state, x, y)
    net.opt_state = net.conf.updater.init(net.params)
    net.apply_update(net.params, net.opt_state, grads, 0)
    return float(loss), list(tree_leaves(grads))


def step_check(A, x, y, seed, policy):
    """One training step from identical weights through the kernel and
    through the plain attention forward; the losses must agree to rtol
    1e-4. Under the f32 policy the updated parameters must agree to atol
    1e-4. Under bf16_policy the matmul operands are rounded to bf16, so the
    ~1e-7 difference between the two attention outputs moves operands that
    sit on a rounding boundary by one bf16 ulp, and a near-zero gradient
    element can differ by its own size between the runs; Adam's first step,
    about lr·g/(|g| + 3e-7), turns that into up to 2·lr. There each
    tensor's gradient is held to a relative difference of 1e-2 instead, and
    the parameter difference is reported."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    kern = make_lm(seed)
    lk, gk = one_step(kern, x, y)
    with plain_attention_forward(A):
        plain = make_lm(seed)
        lp, gp = one_step(plain, x, y)
    if not abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp):
        raise AssertionError(f"kernel step loss {lk} vs plain-attention step loss {lp}")
    err, beyond, grad_rel = 0.0, 0, 0.0
    for a, b, ga, gb in zip(tree_leaves(kern.params), tree_leaves(plain.params), gk, gp):
        grad_rel = max(grad_rel, ((ga - gb).norm() / gb.norm().clamp_min(1e-30)).item())
        diff = (a - b).abs()
        err = max(err, diff.max().item())
        beyond += int((diff > STEP_PARAM_ATOL).sum())
    if policy == "f32" and not err <= STEP_PARAM_ATOL:
        raise AssertionError(f"updated parameters differ by {err} between the kernel step "
                             "and the plain-attention step")
    if policy == "bf16" and not grad_rel <= STEP_BF16_GRAD_RTOL:
        raise AssertionError(f"gradients differ by {grad_rel} relative between the kernel "
                             "step and the plain-attention step")
    n = sum(g.numel() for g in gp)
    del kern, plain, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernel": lk, "loss_plain": lp, "max_grad_rel_diff": grad_rel,
            "max_abs_param_diff": err, "params_beyond_atol": beyond, "params": n}


def device_families(prof, wall_ms):
    """Device time by family from a profile, each kernel counted once:
    kernels launched inside the attention backward or the updater by their
    range, the rest by kernel name; and the device's busy share of
    ``wall_ms`` (union of kernel intervals)."""
    tags = {"flash_attn.backward": "attention_backward", "updater.step": "optimizer"}
    by_family = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        tag, a = None, e
        while a is not None and tag is None:
            tag = tags.get(a.name)
            a = a.cpu_parent
        for kern in e.kernels:
            name = kern.name.lower()
            fam = tag or ("flash_fwd" if "flash_fwd" in name else
                          "gemm" if any(s in name for s in ("gemm", "cutlass", "xmma", "sm90"))
                          else "elementwise_other")
            by_family[fam] = by_family.get(fam, 0.0) + kern.duration / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return by_family, busy_us / 1e3, (busy_us / 1e3 / wall_ms) if spans else None


def phase_train(A, policy, seed):
    """Warm-up, then TIMED_STEPS timed fit steps at full width under the
    named dtype policy; the step check; one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils import dtypes

    (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
    try:
        rs = np.random.RandomState(seed)
        n = LM_BATCH * (WARMUP_STEPS + TIMED_STEPS)
        x, y = lm_data(rs, n)
        check = step_check(A, x[:LM_BATCH], y[:LM_BATCH], seed, policy)
        net = make_lm(seed)
        warm = LM_BATCH * WARMUP_STEPS
        net.fit((x[:warm], y[:warm]), batch_size=LM_BATCH)
        first_loss = net.score_history[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.launches = 0
        t0 = time.perf_counter()
        net.fit((x[warm:], y[warm:]), batch_size=LM_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = A.launches
        peak = torch.cuda.max_memory_allocated()
        losses = net.score_history
        if launches != LM_LAYERS * TIMED_STEPS:
            raise AssertionError(f"flash_attn launched {launches} times in {TIMED_STEPS} steps "
                                 f"of a {LM_LAYERS}-layer model (expected {LM_LAYERS} a step)")
        if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
            raise AssertionError(f"loss did not fall: first {first_loss}, timed steps {losses}")
        tokens = TIMED_STEPS * LM_BATCH * LM_SEQ
        row = {"policy": policy, "params": net.num_params(), "batch": LM_BATCH,
               "seq": LM_SEQ, "steps": TIMED_STEPS, "step_ms": 1e3 * wall / TIMED_STEPS,
               "tokens_per_s": tokens / wall, "peak_mem_gb": peak / 1e9,
               "loss_first": first_loss, "loss_last": losses[-1], "losses": losses,
               "flash_launches": launches, "step_check": check, "card": card_line()}
        emit("train", **row)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit((x[:LM_BATCH], y[:LM_BATCH]))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_family, busy_ms, share = device_families(prof, wall_ms)
        emit("train.profile", policy=policy, wall_ms=wall_ms,
             wall_unprofiled_ms=row["step_ms"], device_ms_by_family=by_family,
             device_busy_ms=busy_ms, device_busy_share=share,
             device_busy_share_unprofiled=busy_ms / row["step_ms"], card=card_line())
        del net, x, y
        torch.cuda.empty_cache()
        return row
    finally:
        dtypes.f32_policy()


def seeded_params(net, rs):
    """The char-RNN's weights from a numpy seed, in the JAX package's
    layout (a list of per-layer dicts)."""
    params = []
    for p in net.params:
        d = {}
        for name, t in p.items():
            shape = tuple(t.shape)
            if name == "b":
                a = np.zeros(shape, np.float32)
                if "Wh" in p:  # LSTM: forget-gate bias 1
                    h = shape[0] // 4
                    a[h:2 * h] = 1.0
            elif name == "Wp":
                a = 0.1 * rs.randn(*shape)
            else:
                a = rs.randn(*shape) * np.sqrt(2.0 / sum(shape))
            d[name] = a.astype(np.float32)
        params.append(d)
    return params


def plain_forward(L, params, x):
    """The char-RNN forward from the plain functions: x.Wx + b, the plain
    LSTM loop with peepholes, then the softmax head."""
    h = x
    for p in params[:2]:
        b, t, _ = h.shape
        hsz = p["Wh"].shape[0]
        xz = (h.reshape(b * t, -1) @ p["Wx"] + p["b"]).reshape(b, t, 4 * hsz).transpose(0, 1)
        zero = torch.zeros(b, hsz, device=x.device)
        hs = L.lstm_seq_plain(xz.contiguous(), p["Wh"], zero, zero, wp=p["Wp"])[0]
        h = hs.transpose(0, 1)
    out = params[2]
    b, t, f = h.shape
    return torch.softmax((h.reshape(b * t, f) @ out["W"] + out["b"]).reshape(b, t, -1), dim=-1)


def phase_serve(L, zip_path):
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ServingOverloaded, get_model_registry
    from deeplearning4j_tpu_torch.utils.serialization import (load_model, params_from_numpy,
                                                             save_model)

    rs = np.random.RandomState(SEED)
    net = MultiLayerNetwork(text_generation_lstm(VOCAB, hidden=HIDDEN, seq_len=SEQ), device="cuda")
    net.init(torch.Generator().manual_seed(SEED))
    params_np = seeded_params(net, rs)
    params_from_numpy(net, params_np)
    if net.num_params() != N_PARAMS:
        raise AssertionError(f"char-RNN has {net.num_params()} params, expected {N_PARAMS}")
    save_model(net, zip_path)
    net = load_model(zip_path, device="cuda")
    for mine, theirs in zip(net.params, params_np):
        for k, v in theirs.items():
            if not np.array_equal(mine[k].cpu().numpy(), v):
                raise AssertionError(f"save/load round trip changed {k}")
    params = [{k: v.detach() for k, v in p.items()} for p in net.params]

    # requests: one-hot characters, lengths 1..128, single and batched
    reqs = []
    for i in range(320):
        rows = None if i % 5 else int(rs.randint(2, 17))
        steps = int(rs.randint(1, SEQ + 1))
        ids = rs.randint(0, VOCAB, size=(rows or 1, steps))
        x = np.eye(VOCAB, dtype=np.float32)[ids]
        reqs.append((x if rows else x[0], rows is not None))

    # the main path, from registration (its warmup runs every bucket) to
    # the last result
    L.launches = 0
    registry = get_model_registry()
    t_reg = time.perf_counter()
    engine = registry.register("charnn", net, input_spec=(SEQ, VOCAB), max_batch_size=64,
                               seq_buckets=(32, 64, 128), device="cuda")
    warm_s = time.perf_counter() - t_reg
    futs, shed = [], 0
    t0 = time.perf_counter()
    try:
        for x, batched in reqs:
            while True:
                try:
                    futs.append(engine.submit(x, batched=batched))
                    break
                except ServingOverloaded:
                    shed += 1  # queue full: back off and resubmit
                    time.sleep(0.001)
        outs = [f.get(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        registry.stop()
    launches = L.launches
    forwards = stats["forward"]["forwards"]
    if launches == 0 or launches != 2 * forwards:
        raise AssertionError(f"lstm_seq launched {launches} times for {forwards} device "
                             "forwards of a 2-layer LSTM (expected exactly 2 per forward)")

    max_err = 0.0
    tokens = 0
    for (x, batched), y in zip(reqs, outs):
        xb = x if batched else x[None]
        yb = y if batched else y[None]
        if yb.shape != xb.shape[:2] + (VOCAB,):
            raise AssertionError(f"served output shape {y.shape} for input {x.shape}")
        if not np.isfinite(yb).all():
            raise AssertionError("served output not finite")
        if not np.allclose(yb.sum(-1), 1.0, atol=1e-4):
            raise AssertionError("served softmax rows do not sum to 1")
        want = plain_forward(L, params, torch.from_numpy(xb).cuda()).cpu().numpy()
        err = float(np.abs(yb - want).max())
        max_err = max(max_err, err)
        if err > SERVE_ATOL:
            raise AssertionError(f"served output differs from the plain forward by {err}")
        tokens += xb.shape[0] * xb.shape[1]
    lats = sorted(f.latency_s for f in futs)
    result = {
        "params": net.num_params(), "requests": len(reqs), "rows": stats["requests"]["served"],
        "tokens": tokens, "resubmits_after_queue_full": shed, "device_forwards": forwards,
        "warmup_forwards": stats["forward"]["warmed"], "lstm_seq_launches": launches,
        "register_s": warm_s, "wall_s": wall, "tokens_per_s": tokens / wall,
        "p50_ms": 1e3 * float(np.percentile(lats, 50)),
        "p99_ms": 1e3 * float(np.percentile(lats, 99)),
        "max_abs_err_vs_plain": max_err, "atol": SERVE_ATOL, "card": card_line()}
    emit("serve", **result)
    return launches, net


def phase_profile(net):
    """Where one forward at the largest bucket (64 x 128) spends device
    time, from a torch.profiler trace: device time by kernel family and
    the share of the forward's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(64, SEQ, VOCAB, device="cuda")
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        net.apply_fn(net.params, net.state, x)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_unprofiled_ms = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.apply_fn(net.params, net.state, x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_family = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        family = ("lstm_seq" if "lstm_step_kernel" in name else
                  "gemm" if any(k in name for k in ("gemm", "cutlass", "matmul", "xmma")) else
                  "copy" if "memcpy" in name or "copy" in name else "other")
        spans.append((e.time_range.start, e.time_range.end))
        by_family[family] = by_family.get(family, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_us, end = 0.0, None
    for a, b in sorted(spans):  # union of device intervals
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    # the profiler slows the host's launches, so the busy share is given
    # against both the profiled and the unprofiled wall time
    emit("profile", bucket=[64, SEQ], wall_ms=wall_ms, wall_unprofiled_ms=wall_unprofiled_ms,
         device_events=len(spans), device_ms_by_family=by_family, device_busy_ms=busy_us / 1e3,
         device_busy_share=(busy_us / 1e3 / wall_ms) if spans else None,
         device_busy_share_unprofiled=(busy_us / 1e3 / wall_unprofiled_ms) if spans else None,
         card=card_line())


def phase_cli(zip_path):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path", str(zip_path),
         "--max-batch", "64", "--smoke", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    stats = json.loads(proc.stdout[proc.stdout.index("{"):])
    if stats["requests"]["served"] != 64:
        raise AssertionError(f"serve CLI served {stats['requests']['served']} of 64")
    emit("cli", rc=proc.returncode, served=stats["requests"]["served"],
         device=stats["device"], seconds=time.perf_counter() - t0)


def build_all(libs):
    """Build every kernel library at once (one nvcc each, started together)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(mod):
        t0 = time.perf_counter()
        so = mod.build()
        return so, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(one, libs))
    emit("build", seconds=time.perf_counter() - t0, libraries=[{
        "library": str(so.relative_to(ROOT)), "seconds": secs,
        "ptxas": [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
                  if "Used" in ln or "spill" in ln]} for so, secs in built])


PHASES = ("kernels", "flash", "train", "serve")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the training data and weights")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (a partial run prints no "
                         f"result lines); default all of {PHASES}")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phases {sorted(only - set(PHASES))}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.nn.layers import attention as TA
    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import lstm_seq as L

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), card=card)
    build_all([L, A])

    if "kernels" in only:
        timings, max_err_path = phase_kernels(L)
    if "flash" in only:
        flash_timings, flash_err = phase_flash(A)
        phase_crossover(TA)
    if "train" in only:
        train_rows = [phase_train(A, policy, args.seed) for policy in ("f32", "bf16")]
    if "serve" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            zip_path = WORK / "charnn.zip"
            launches, net = phase_serve(L, zip_path)
            phase_profile(net)
            phase_cli(zip_path)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    if only != set(PHASES):
        return

    path = next(r for r in timings if (r["B"], r["H"]) == (64, HIDDEN))
    fpath = flash_timings[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "lstm_seq", "route": "cuda", "source": "deeplearning4j_tpu_torch/csrc/lstm_seq.cu",
        "replaces": "deeplearning4j_tpu/ops/lstm_pallas.py:91; deeplearning4j_tpu/ops/lstm_pallas.py:132",
        "launches": launches, "max_abs_err": max_err_path, "ms": path["ms"],
        "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"]}, {
        "name": "flash_attn", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn.cu",
        "replaces": "deeplearning4j_tpu/ops/attention_pallas.py:175",
        "launches": train_rows[0]["flash_launches"], "max_abs_err": flash_err,
        "ms": fpath["ms"], "plain_ms": fpath["plain_ms"], "bound_ms": fpath["bound_ms"],
        "bound_by": fpath["bound_by"], "library_ms": fpath["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
