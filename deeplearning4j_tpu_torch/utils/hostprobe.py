"""Whether a ``torch.profiler`` session slows the host's later launches.

Host-bound training steps (Inception-ResNet v1 issues ~17.6k PyTorch ops a
step) ran twice as long at the end of a full ``chip_smoke.py`` run as in a
run of its ``zoo`` phase alone, with the same device time. Every phase
before the zoo profiles one of its steps. This probe times, in one fresh
process on the card: the host's cost of a launch (a small in-place add,
back to back, then one synchronize) and an Inception-ResNet v1 training
step (batch 64, 160x160, f32), first fresh, then after one profiled step
(CPU and CUDA activities, as ``chip_smoke.py`` profiles), then after a
full garbage collection.

Run on an H100: ``python -m deeplearning4j_tpu_torch.utils.hostprobe``. It
prints one JSON line a measurement, then the card's name and power limit.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import time

import numpy as np
import torch

LAUNCHES, STEPS, BATCH, HW = 5000, 5, 64, 160


def launch_us():
    """Host microseconds a launch: LAUNCHES in-place adds on one element."""
    a = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        a.add_(1.0)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / LAUNCHES


def step_ms(net, x, y):
    """Median host-clock ms of STEPS single-batch fit steps."""
    out = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def main():
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models import get_model

    if not torch.cuda.is_available():
        raise SystemExit("hostprobe: torch sees no CUDA device")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(BATCH, HW, HW, 3).astype(np.float32)).cuda()
    y = torch.nn.functional.one_hot(torch.from_numpy(rs.randint(0, 10, BATCH)).cuda(),
                                    1001).float()
    net = get_model("inceptionresnetv1").build(device="cuda")
    net.fit(x, y)
    net.fit(x, y)
    rows = {"fresh": (launch_us(), step_ms(net, x, y))}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        net.fit(x, y)
        torch.cuda.synchronize()
    rows["after_profile"] = (launch_us(), step_ms(net, x, y))
    gc.collect()
    rows["after_gc"] = (launch_us(), step_ms(net, x, y))
    for when, (us, ms) in rows.items():
        print(json.dumps({"when": when, "launch_us": us, "irv1_step_ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
