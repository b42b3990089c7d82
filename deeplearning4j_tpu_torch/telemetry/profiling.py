"""Windowed ``torch.profiler`` capture: one round, one trace.

The port of ``deeplearning4j_tpu/telemetry/profiling.py``. Device profiles
of EXACTLY one training round, captured programmatically: an always-on
profiler would perturb the steady state it is measuring, and the spans'
``record_function`` ranges (``telemetry/tracing.py``) only cost anything
while a profiler session is active, so the capture window is also the only
window that pays for them. :func:`profile_window` runs a block under a
``torch.profiler.profile`` session (CPU and, on a card, CUDA activity) and
writes its Chrome trace to ``<logdir>/trace.json``; ``utils/profiling.py``
ranks its kernels. Off a card it is a guarded NO-OP (CPU test runs never
start a session); force it with ``DL4J_TPU_PROFILE_FORCE=1`` or
``force=True`` (the CPU profiler works, it is just not the default).

Drivers expose this as ``profile_round(n)`` (StepDriver /
ParallelTrainer): arm once, the n-th round from now runs inside the
window, the trace lands under the logdir.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["profile_window", "profiling_available", "ProfileSchedule", "TRACE_NAME"]

#: escape hatch for CPU tests of the capture plumbing itself
FORCE_ENV = "DL4J_TPU_PROFILE_FORCE"
#: the Chrome trace a window writes under its logdir
TRACE_NAME = "trace.json"


def profiling_available(force=None):
    """Whether :func:`profile_window` would actually capture: with a CUDA
    card, or forced (env/flag) on the CPU."""
    if force is None:
        force = os.environ.get(FORCE_ENV, "") == "1"
    return bool(force) or torch.cuda.is_available()


@contextlib.contextmanager
def profile_window(logdir, force=None):
    """Run the block under a ``torch.profiler`` session whose Chrome trace
    goes to ``<logdir>/trace.json``. Yields True when a session is
    actually active, False for the off-card no-op — zero cost, no
    directory created."""
    if not profiling_available(force):
        yield False
        return
    from torch.profiler import ProfilerActivity, profile, schedule
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # one warm-up cycle before the recorded one: the tracer starts in it
    # (its first events can be lost while it does)
    prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(os.path.join(logdir,
                                                                               TRACE_NAME)))
    prof.__enter__()
    if cuda:
        torch.cuda.synchronize()
    prof.step()
    try:
        yield True
    finally:
        if cuda:
            torch.cuda.synchronize()  # the window's kernels end inside it
        prof.step()  # ends the recorded cycle: the trace is written
        prof.__exit__(None, None, None)


class ProfileSchedule:
    """Arm-once capture schedule: ``arm(n, logdir)`` marks the n-th
    future round; the driver brackets each round in ``window(round)``
    and exactly the armed one runs inside a profiler session. Keeps the
    driver's round loop branch-cheap (one attribute check when idle)."""

    __slots__ = ("_at", "_logdir", "_force", "captured")

    def __init__(self):
        self._at = None
        self._logdir = None
        self._force = None
        #: logdirs of completed captures
        self.captured = []

    def arm(self, rounds_from_now, logdir, force=None):
        if rounds_from_now < 1:
            raise ValueError("profile_round arms a FUTURE round "
                             f"(got {rounds_from_now})")
        self._at = int(rounds_from_now)
        self._logdir = str(logdir)
        self._force = force

    @property
    def armed(self):
        return self._at is not None

    @contextlib.contextmanager
    def window(self, *, tag=None):
        """Bracket ONE round; counts down the armed schedule and opens
        the profiler window on the round it reaches zero."""
        if self._at is None:
            yield False
            return
        self._at -= 1
        if self._at > 0:
            yield False
            return
        logdir, force = self._logdir, self._force
        if tag:
            logdir = os.path.join(logdir, str(tag))
        self._at, self._logdir, self._force = None, None, None
        with profile_window(logdir, force=force) as active:
            yield active
        if active:
            self.captured.append(logdir)
