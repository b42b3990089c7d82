"""Measurement harness: candidate timing + parity gate.

The port of ``deeplearning4j_tpu/tuning/measure.py``. On a card each
candidate's ``iters`` calls (after ``warmup`` eager calls) are captured
into one CUDA graph, and each of ``reps`` windows times one replay of it
between two CUDA events: the window holds the kernels' device time and no
host launch cost, so a kernel shorter than its launch still ranks on its
own time. On the CPU (where the candidates are the kernels' plain
versions) the window is ``time.perf_counter`` around the same calls. A
candidate's time is its best window, and its ``spread`` the gap between
its slowest and best windows. Every candidate is
**parity-gated against the reference before it may win**: by default its
output's largest absolute difference from the reference's
(``parity_diff``, NaN-poisoned) must be at most ``tol``; a ``gate``
callable states a kernel's own tolerance (the drivers pass the ones
``chip_smoke.py``'s kernel phases hold). A candidate that fails parity,
or raises, counts a ``tuning_db_total{event=reject}`` and can never be
persisted — a fast wrong kernel is not a winner.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.tuning import db as _db


@dataclasses.dataclass
class Measurement:
    """One candidate's outcome: parity diff, per-iteration seconds (None
    when rejected), and the rejection reason when it never ran."""
    config: dict
    seconds_per_iter: float | None = None
    spread: float | None = None
    parity: float | None = None
    rejected: str | None = None
    raised: bool = False

    @property
    def ok(self):
        return self.rejected is None


def _leaves(tree):
    """The leaves of nested tuples/lists/dicts (dicts in key order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return ("seq", tuple(_structure(v) for v in tree))
    return "leaf"


def _f32(a, device):
    if torch.is_tensor(a):
        return a.detach().to(device, torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def parity_diff(out, ref):
    """Max abs elementwise difference across the two trees' leaves in f32,
    or inf on structure/shape mismatch. NaN anywhere returns inf (a
    NaN-emitting candidate must fail, not slide through a ``<=`` that is
    False-but-passing). Computed where the reference leaf lies (on the
    card for the kernels: no copy of the outputs to the host)."""
    if _structure(out) != _structure(ref):
        return float("inf")
    worst = 0.0
    for a, b in zip(_leaves(out), _leaves(ref)):
        dev = b.device if torch.is_tensor(b) else "cpu"
        a, b = _f32(a, dev), _f32(b, dev)
        if a.shape != b.shape:
            return float("inf")
        d = float((a - b).abs().max()) if a.numel() else 0.0
        if not np.isfinite(d):
            return float("inf")
        worst = max(worst, d)
    return worst


def _on_card(args):
    return any(torch.is_tensor(a) and a.is_cuda for a in _leaves(args))


def _graph_windows(fn, args, iters, warmup, reps):
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        for _ in range(max(1, warmup)):
            fn(*args)
        stream.synchronize()
        graph.capture_begin()
        try:
            for _ in range(iters):
                fn(*args)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture the failed call broke: its own error is the one raised
            raise
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()  # the first replay uploads the graph
    windows = []
    for _ in range(max(1, reps)):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        windows.append(e0.elapsed_time(e1) / 1e3 / iters)
    return windows


def time_windows(fn, args, *, iters=4, warmup=1, reps=2):
    """Seconds per call of ``fn(*args)`` in each of ``reps`` windows of
    ``iters`` calls: one replay of a CUDA graph of the calls on a card, the
    calls themselves inside ``perf_counter`` reads on the CPU, after
    ``warmup`` calls."""
    if _on_card(args):
        return _graph_windows(fn, args, iters, warmup, reps)
    for _ in range(max(1, warmup)):
        fn(*args)
    windows = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        windows.append((time.perf_counter() - t0) / iters)
    return windows


def time_callable(fn, args, *, iters=4, warmup=1, reps=2):
    """Best-of-``reps`` seconds per call of ``fn(*args)`` (``time_windows``)."""
    return min(time_windows(fn, args, iters=iters, warmup=warmup, reps=reps))


def search(kernel, candidates, build, args, ref_fn, *, build_check=None, tol=1e-6, gate=None,
           iters=4, warmup=1, reps=2, log=None):
    """Measure ``candidates`` and return ``(winner, results)``.

    ``build(config)`` -> the timed callable; ``build_check(config)`` (or
    ``build`` itself) -> the callable whose output is held against
    ``ref_fn(*args)``: by ``gate(out, ref)`` (a rejection reason or None)
    where given, else ``parity_diff <= tol``. A candidate that fails the
    gate, or whose build/run raises, is REJECTED — counted, never timed,
    never a winner (``raised`` marks the second kind). ``winner`` is the
    fastest surviving Measurement, or None when everything rejected."""
    ref_out = ref_fn(*args)
    results, winner = [], None
    for cfg in candidates:
        m = Measurement(dict(cfg))
        try:
            check_fn = (build_check or build)(cfg)
            out = check_fn(*args)
        except Exception as e:  # noqa: BLE001 — a candidate that raises is rejected
            m.rejected, m.raised = f"raised {type(e).__name__}: {e}", True
        else:
            m.parity = parity_diff(out, ref_out)
            reason = gate(out, ref_out) if gate is not None else (
                None if m.parity <= tol else f"parity {m.parity:.3g} exceeds tol {tol:.3g}")
            if reason is not None:
                m.rejected = reason
            else:
                timed = build(cfg) if build_check is not None else check_fn
                try:
                    windows = time_windows(timed, args, iters=iters, warmup=warmup,
                                           reps=reps)
                    m.seconds_per_iter, m.spread = min(windows), max(windows) - min(windows)
                except Exception as e:  # noqa: BLE001
                    m.rejected, m.raised = f"raised {type(e).__name__}: {e}", True
        results.append(m)
        if not m.ok:
            _db.count_event("reject")
            if log:
                log(f"  {kernel} {cfg}: REJECTED ({m.rejected})")
            continue
        if winner is None or m.seconds_per_iter < winner.seconds_per_iter:
            winner = m
        if log:
            log(f"  {kernel} {cfg}: {1e3 * m.seconds_per_iter:.4f} ms/iter "
                f"(parity {m.parity:.2g})")
    return winner, results
