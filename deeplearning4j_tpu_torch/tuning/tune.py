"""Per-kernel tuning drivers: enumerate → prune → measure → persist.

The port of ``deeplearning4j_tpu/tuning/tune.py``: one driver per kernel
id (attention, conv_matmul, conv3x3, lstm). Each enumerates its config
space (``tuning/space.py``), prunes the configs that cannot launch (each
counted by reason, never run), gates the survivors against the kernel's
plain version and times them (``tuning/measure.py``), and records the
winner into the TuningDB (``tuning/db.py``), keyed by the device the
candidates ran on. Each candidate runs through the kernel's own wrapper,
with its config pinned as the plan of the call (``ops/_plans.py
PlanCache.pinned``). The default ``plan()``'s config is always a
candidate (it must validate: nothing that can fault reaches a launch), so
its time is reported beside the winner's, and it stays the winner unless
the fastest candidate beats it by more than the spread of either one's
timing windows and by ``MIN_GAIN`` of its time (the JAX package records
the fastest whatever the gap).

The attention driver also times the naive path (``{"backend": "plain"}``,
the port's ``dot_product_attention`` below its length crossover), so the
DB entry records whether the kernel should run at all for the bucket: the
measured replacement of ``nn/layers/attention.MIN_SEQ`` for that bucket.

Each driver's default shape is one the port's main paths launch: the
transformer LM's attention (B=4, T=4096, H=8, D=64, causal), the fused
ResNet50's 1x1 and 3x3 convs at batch 64, the char-RNN's LSTM (T=128,
B=64, H=512). ``device="cpu"`` runs the plain versions (every candidate
computes the same function there): the search, the gate and the DB are
exercised, the kernels are not, and the times say nothing of the card.
"""

from __future__ import annotations

import json

import torch

from deeplearning4j_tpu_torch.tuning import space as _space
from deeplearning4j_tpu_torch.tuning.measure import _leaves, parity_diff, search
from deeplearning4j_tpu_torch.utils.device import resolve_device

#: the gates' tolerances: chip_smoke.py's kernel phases'
LSTM_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}
FLASH_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}
CONV_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}
#: a conv statistic's tolerance: this share of the sum of its terms'
#: magnitudes, plus an absolute floor
CONV_STATS_REL, CONV_STATS_ATOL = 1e-5, 1e-3
#: the least share of the default plan's time a candidate must save to
#: replace it: a drift of the card's clocks between two candidates'
#: windows shows in neither one's spread
MIN_GAIN = 0.01


def close_gate(atol, rtol=0.0):
    """A gate holding every leaf within ``atol + rtol * |ref|`` (NaN
    fails); returns the reason or None."""
    def gate(out, ref):
        if parity_diff(out, ref) == float("inf"):
            return "parity: structure, shape or non-finite values differ"
        for a, b in zip(_leaves(out), _leaves(ref)):
            a, b = a.detach().float(), b.detach().float()
            err = (a - b).abs()
            if not bool((err <= atol + rtol * b.abs()).all()):
                return f"parity {float(err.max()):.3g} beyond atol {atol:g} + rtol {rtol:g}"
        return None
    return gate


def conv_gate(dtype):
    """z within the dtype's tolerance; each statistic within
    ``CONV_STATS_REL`` of the sum of its terms' magnitudes (sum |z|, sum
    z^2 from the reference z) plus ``CONV_STATS_ATOL``."""
    z_gate = close_gate(*CONV_TOL[dtype])

    def gate(out, ref):
        reason = z_gate(out[0], ref[0])
        if reason is not None:
            return f"z {reason}"
        zr = ref[0].detach().float().reshape(-1, ref[0].shape[-1])
        mag = torch.stack((zr.abs().sum(0), (zr * zr).sum(0)))
        err = (out[1].detach().float() - ref[1].detach().float()).abs()
        if not bool((err <= CONV_STATS_REL * mag + CONV_STATS_ATOL).all()):
            return f"stats parity {float(err.max()):.3g} beyond their terms' tolerance"
        return None
    return gate


def _cfg_key(config):
    return json.dumps(config, sort_keys=True)


def _summary(kernel, shape, dtype, device, enumerated, valid, rejected_static, winner,
             results, default_config, fastest, margin):
    by_reason = {}
    for _, reason in rejected_static:
        head = reason.split(":", 1)[0]
        by_reason[head] = by_reason.get(head, 0) + 1
    timings = {_cfg_key(m.config): 1e3 * m.seconds_per_iter for m in results if m.ok}
    return {
        "kernel": kernel,
        "shape": [int(d) for d in shape],
        "dtype": str(dtype).removeprefix("torch."),
        "device": str(device),
        "enumerated": enumerated,
        "candidates": len(valid),
        "pruned_static": len(rejected_static),
        "pruned_reasons": by_reason,
        "rejected_parity": sum(1 for m in results if not m.ok and not m.raised),
        "raised": [{"config": m.config, "error": m.rejected} for m in results if m.raised],
        "timed": len(timings),
        "winner": None if winner is None else winner.config,
        "winner_ms": None if winner is None else 1e3 * winner.seconds_per_iter,
        "fastest": None if fastest is None else fastest.config,
        "fastest_ms": None if fastest is None else 1e3 * fastest.seconds_per_iter,
        "margin_ms": None if margin is None else 1e3 * margin,
        "default_config": default_config,
        "default_valid": default_config in valid,
        "default_ms": timings.get(_cfg_key(default_config)),
        "timings_ms": timings,
    }


def _sms(device):
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def _chosen(fastest, base):
    """(the measurement to record, the margin it was held to): the fastest
    where it beats the default's ``base`` by more than either one's spread
    and ``MIN_GAIN`` of the default's time, else the default's."""
    if fastest is None or base is None or fastest is base:
        return fastest, None
    margin = max(fastest.spread or 0.0, base.spread or 0.0, MIN_GAIN * base.seconds_per_iter)
    return (fastest if base.seconds_per_iter - fastest.seconds_per_iter > margin else base), margin


def _tune(kernel, dbase, shape, dtype, device, candidates, build, args, ref_fn, gate, *,
          call=None, build_check=None, iters, warmup, reps, log, meta=None):
    call = dict(call or {})
    if candidates is None:
        candidates = _space.enumerate_space(kernel)
    default = _space.default_config(
        kernel, shape, dtype, **{k: v for k, v in call.items() if k != "occupancy"})
    valid, rejected = _space.prune(kernel, candidates, shape, dtype, keep=default, **call)
    # the plain versions in full f32: the gate's reference is not TF32-rounded
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            fastest, results = search(kernel, valid, build, args, ref_fn,
                                      build_check=build_check, gate=gate, iters=iters,
                                      warmup=warmup, reps=reps, log=log)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    base = next((m for m in results if m.ok and m.config == default), None)
    winner, margin = _chosen(fastest, base)
    if winner is not None and dbase is not None:
        dbase.record(kernel, shape, dtype, winner.config,
                     score_ms=1e3 * winner.seconds_per_iter, meta=meta, device=device)
    return _summary(kernel, shape, dtype, device, len(candidates), valid, rejected, winner,
                    results, default, fastest, margin)


def _pinned(plans, key, fn):
    """``build(config)`` for a kernel wrapper ``fn``: a callable running
    ``fn`` with ``config`` pinned as the plan of the call at ``key``."""
    def build(cfg):
        def run(*args):
            with plans.pinned(key, cfg):
                return fn(*args)
        return run
    return build


def _randn(gen, shape, device, dtype, scale):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# attention (+ the length crossover: the naive path as a candidate)
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, causal=True):
    """The naive path ``{"backend": "plain"}`` names: the port's
    ``dot_product_attention`` below its crossover ([B,H,T,T] scores)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import dot_product_attention
    return dot_product_attention(q, k, v, causal=causal, min_seq=q.shape[1] + 1)


def tune_attention(dbase, *, b=4, t=4096, h=8, d=64, dtype=torch.float32, causal=True,
                   device="cuda", iters=5, warmup=1, reps=3, candidates=None,
                   include_plain=True, log=None):
    """Search the flash variant (and the naive path) at [b, t, h, d], q, k
    and v the views of one [b, t, 3, h, d] tensor the fused projection
    leaves, and record the winner. ``include_plain=False`` drops the naive
    candidate."""
    from deeplearning4j_tpu_torch.ops import attention as _at
    dev = resolve_device(device)
    dtype = _space.as_torch_dtype(dtype)
    shape = (b, t, h, d)
    gen = torch.Generator(dev).manual_seed(0)
    qkv = _randn(gen, (b, t, 3, h, d), dev, dtype, 0.5)
    q, k, v = qkv.unbind(2)
    if candidates is None:
        candidates = [c for c in _space.enumerate_space("attention")
                      if include_plain or c.get("backend") != "plain"]
    strides = tuple(tuple(x.stride()[:3]) for x in (q, k, v))
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v))
    key = _at.plan_key(shape, dtype, strides, aligned)

    def build(cfg):
        if cfg.get("backend") == "plain":
            return lambda q, k, v: naive_attention(q, k, v, causal)

        def run(q, k, v):
            with _at.PLANS.pinned(key, cfg):
                return _at.flash_attention_fwd(q, k, v, causal=causal)[0]
        return run

    def ref(q, k, v):
        return _at.flash_attention_plain(q, k, v, causal=causal)[0]

    return _tune("attention", dbase, shape, dtype, dev, candidates, build, (q, k, v), ref,
                 close_gate(*FLASH_TOL[dtype]), call={"aligned": aligned, "strides": strides},
                 iters=iters, warmup=warmup, reps=reps, log=log, meta={"causal": bool(causal)})


# ---------------------------------------------------------------------------
# conv: the 1x1 GEMM-with-stats kernel and the SAME 3x3 kernel
# ---------------------------------------------------------------------------

def tune_conv_matmul(dbase, *, n=64 * 56 * 56, cin=64, cout=256, dtype=torch.float32,
                     device="cuda", iters=5, warmup=1, reps=3, candidates=None, log=None):
    """Search the 1x1 conv's tile and grid at ``n`` output pixels (one
    [n, 1, 1, cin] input: the GEMM the kernel runs)."""
    from deeplearning4j_tpu_torch.ops import conv_stats as _cs
    dev = resolve_device(device)
    dtype = _space.as_torch_dtype(dtype)
    gen = torch.Generator(dev).manual_seed(1)
    x = _randn(gen, (n, 1, 1, cin), dev, dtype, 1.0)
    w = _randn(gen, (cin, cout), dev, dtype, cin ** -0.5)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    key = _cs.plan_key(1, tuple(x.shape), cout, (1, 1), dtype, _sms(dev) or _cs.H100_SMS,
                       aligned)
    return _tune("conv_matmul", dbase, (n, cin, cout), dtype, dev, candidates,
                 _pinned(_cs.PLANS, key, _cs.conv_mm_stats), (x, w),
                 _cs.conv_mm_stats_plain, conv_gate(dtype),
                 call={"aligned": aligned, "sms": _sms(dev)}, iters=iters, warmup=warmup,
                 reps=reps, log=log)


def tune_conv3x3(dbase, *, b=64, hw=56, cin=64, cout=64, stride=1, dtype=torch.float32,
                 device="cuda", iters=5, warmup=1, reps=3, candidates=None, log=None):
    """Search the SAME 3x3 conv's tile and grid at [b, hw, hw, cin] ->
    cout, ``stride`` 1 or 2; the DB key is the output's (b, ho, wo, cin,
    cout)."""
    from deeplearning4j_tpu_torch.ops import conv_stats as _cs
    dev = resolve_device(device)
    dtype = _space.as_torch_dtype(dtype)
    gen = torch.Generator(dev).manual_seed(2)
    x = _randn(gen, (b, hw, hw, cin), dev, dtype, 1.0)
    w = _randn(gen, (3, 3, cin, cout), dev, dtype, (9 * cin) ** -0.5)
    ho = -(-hw // stride)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    st = (stride, stride)
    key = _cs.plan_key(3, tuple(x.shape), cout, st, dtype, _sms(dev) or _cs.H100_SMS, aligned)
    return _tune("conv3x3", dbase, (b, ho, ho, cin, cout), dtype, dev, candidates,
                 _pinned(_cs.PLANS, key, lambda x, w: _cs.conv3x3_stats(x, w, st)), (x, w),
                 lambda x, w: _cs.conv3x3_stats_plain(x, w, st), conv_gate(dtype),
                 call={"aligned": aligned, "sms": _sms(dev)}, iters=iters, warmup=warmup,
                 reps=reps, log=log, meta={"stride": stride})


# ---------------------------------------------------------------------------
# lstm: persistent rows per lane against step_cluster's split
# ---------------------------------------------------------------------------

def tune_lstm(dbase, *, t=128, b=64, hidden=512, dtype=torch.float32, peephole=True,
              device="cuda", iters=5, warmup=1, reps=3, candidates=None, log=None):
    """Search the LSTM variant and its size at [t, b, hidden] (peepholes,
    as the GravesLSTM char-RNN has them)."""
    from deeplearning4j_tpu_torch.ops import lstm_seq as _ls
    dev = resolve_device(device)
    dtype = _space.as_torch_dtype(dtype)
    gen = torch.Generator(dev).manual_seed(3)
    h = hidden
    xz = _randn(gen, (t, b, 4 * h), dev, dtype, 1.0)
    wh = _randn(gen, (h, 4 * h), dev, dtype, h ** -0.5)
    h0 = _randn(gen, (b, h), dev, torch.float32, 0.1)
    c0 = _randn(gen, (b, h), dev, torch.float32, 0.1)
    wp = _randn(gen, (3, h), dev, dtype, 0.1) if peephole else None
    call = {"sms": _sms(dev)}
    if dev.type == "cuda":
        lib, idx = _ls._LIB.get(), dev.index if dev.index is not None else 0
        call["occupancy"] = lambda rt: _ls._occupancy(lib, rt, h, xz, idx)
    key = _ls.plan_key(t, b, h, dtype, call["sms"] or _ls.H100_SMS)
    build = _pinned(_ls.PLANS, key, lambda *a: tuple(_ls.lstm_seq_fwd(*a)[:4]))

    def ref(xz, wh, h0, c0, wp):
        return tuple(_ls.lstm_seq_plain(xz, wh, h0, c0, wp=wp)[:4])

    return _tune("lstm", dbase, (t, b, h), dtype, dev, candidates, build,
                 (xz, wh, h0, c0, wp), ref, close_gate(*LSTM_TOL[dtype]), call=call,
                 iters=iters, warmup=warmup, reps=reps, log=log)


KERNELS = {"attention": tune_attention, "conv_matmul": tune_conv_matmul,
           "conv3x3": tune_conv3x3, "lstm": tune_lstm}

#: trimmed shapes + candidate sets for the mechanics smoke (the CPU's
#: plain versions: the point is the enumerate→prune→measure→persist→lookup
#: pipeline, not the timings)
SMOKE_PRESETS = {
    "attention": dict(b=1, t=64, h=2, d=16, iters=2, reps=1, include_plain=False,
                      candidates=[{"backend": "flash", "variant": "f32_3xtf32_wgmma"},
                                  {"backend": "flash", "variant": "f32_3xtf32"}]),
    "conv_matmul": dict(n=256, cin=32, cout=64, iters=2, reps=1,
                        candidates=[{"bm": 128, "bn": 64, "blocks_per_sm": 2},
                                    {"bm": 64, "bn": 128, "blocks_per_sm": 2}]),
    "conv3x3": dict(b=2, hw=8, cin=8, cout=16, iters=2, reps=1,
                    candidates=[{"bm": 128, "bn": 64, "blocks_per_sm": 2},
                                {"bm": 64, "bn": 128, "blocks_per_sm": 2}]),
    "lstm": dict(t=4, b=2, hidden=16, iters=2, reps=1,
                 candidates=[{"variant": "persistent", "rt": 1},
                             {"variant": "step_cluster", "split": 1}]),
}


def tune_kernels(dbase, kernels=None, *, smoke=False, device="cuda", log=None, **overrides):
    """Run the drivers for ``kernels`` (default: all) against ``dbase``.
    ``smoke=True`` applies the trimmed presets; ``overrides`` are per-call
    kwargs forwarded to every driver (iters/reps/...). Returns {kernel:
    summary}."""
    out = {}
    for name in (kernels or sorted(KERNELS)):
        if name not in KERNELS:
            raise ValueError(f"unknown kernel {name!r}; known: {sorted(KERNELS)}")
        kw = dict(SMOKE_PRESETS[name]) if smoke else {}
        kw.update(overrides)
        kw.setdefault("device", device)
        if log:
            log(f"tuning {name} ...")
        out[name] = KERNELS[name](dbase, log=log, **kw)
    return out
