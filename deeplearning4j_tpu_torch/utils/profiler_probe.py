"""How a profile window's device events line up with their launches as a
process ages.

Each window (``telemetry/profiling.py profile_window``) launches
``--kernels`` one-element kernels ``--gap-ms`` apart on an otherwise idle
card, and ``utils/profiling.py launch_check`` reads its trace: how many
launches kept their device event and which did not (by their place in the
window), and the lag of each device event's start behind its launch on
the trace's clock (a few microseconds when the
device's and the host's clocks agree). Between windows the card multiplies
matrices for ``--every`` seconds. With ``--lone`` the process opens one
window only, after ``--seconds``: set beside a run with a window every
``--every`` seconds, it tells an offset that grows with the process's age
from one that grows from the process's first window.

Run on a card: ``python -m deeplearning4j_tpu_torch.utils.profiler_probe
[--seconds 180] [--every 20] [--lone] [--out DIR]``. It prints one JSON
line a window, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from deeplearning4j_tpu_torch.telemetry import profiling as TPR
from deeplearning4j_tpu_torch.utils import profiling as UP


def window(logdir, x, kernels, gap_s):
    """One profile window of ``kernels`` launches ``gap_s`` apart; the
    trace's ``launch_check`` and the share of launches kept."""
    with TPR.profile_window(logdir, force=True):
        for _ in range(kernels):
            x.add_(1.0)
            time.sleep(gap_s)
    with open(os.path.join(logdir, TPR.TRACE_NAME)) as f:
        doc = json.load(f)
    check = UP.launch_check(doc)
    starts = sorted(float(ev["ts"]) for ev in doc["traceEvents"]
                    if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "Launch" in ev.get("name", ""))
    missing = set(check.pop("missing_ts"))
    kept = sum(1 for ev in doc["traceEvents"]
               if ev.get("cat") == "kernel" and "elementwise" in ev.get("name", ""))
    return {**check, "kernels_launched": kernels, "kernels_kept": kept,
            "missing_places": [i for i, t in enumerate(starts) if t in missing]}


def busy(seconds, a):
    """Matrix products on the card for ``seconds`` of the host's clock."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(8):
            a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    return a


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--kernels", type=int, default=100)
    ap.add_argument("--gap-ms", type=float, default=10.0)
    ap.add_argument("--lone", action="store_true")
    ap.add_argument("--out", default="profiler_probe")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    x = torch.zeros(1, device="cuda")
    a = torch.rand(4096, 4096, device="cuda") / 4096
    torch.cuda.synchronize()
    n = 0
    while True:
        age = time.perf_counter() - t0
        if not args.lone or age >= args.seconds:
            row = window(os.path.join(args.out, f"w{n}"), x, args.kernels, args.gap_ms / 1e3)
            print(json.dumps({"age_s": age, "lone": args.lone,
                              "env": {k: v for k, v in os.environ.items()
                                      if k.startswith(("KINETO", "TEARDOWN", "CUPTI"))},
                              **row}), flush=True)
            n += 1
        if age >= args.seconds:
            break
        a = busy(min(args.every, args.seconds - age + 1e-3), a)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip())


if __name__ == "__main__":
    main()
