"""How often GoogLeNet's first training steps collapse, by dropout stream.

GoogLeNet (the zoo's default: Adam 1e-3, no batch norm, fc1's input
dropout 0.4) trained 12 steps at batch 64 on 224x224 images of 10 class
templates plus noise can drive every true-class probability under
mcxent's 1e-8 clip, where the gradient is 0: the loss then stays at ~16.
Whether it does depends on the weights, the images and the dropout masks.
This probe trains it once for each of ``--streams`` dropout streams (the
step seeds offset by 1000 x the stream) at each ``--seeds`` (weights and
images), with the port's counter-based masks and, with ``--generator``,
also with masks drawn from a ``torch.Generator`` seeded with the same
integer (the port's masks before they had to be drawn inside a CUDA
graph), and counts the runs whose last 5 losses average below the first.

Run on an H100: ``python -m deeplearning4j_tpu_torch.utils.collapseprobe
--seeds 12345 12346 --generator``. It prints one JSON line a run and a
summary line a seed and mask kind, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from deeplearning4j_tpu_torch.continuous import driver
from deeplearning4j_tpu_torch.models import get_model
from deeplearning4j_tpu_torch.nn.layers import base

BATCH, HW, STEPS, CLASSES, TEMPLATES = 64, 224, 12, 1000, 10


def images(seed, n):
    """n images of TEMPLATES class templates plus half-amplitude noise and
    their one-hot labels, on the card."""
    rs = np.random.RandomState(seed)
    templates = torch.from_numpy(rs.rand(TEMPLATES, HW, HW, 3).astype(np.float32)).cuda()
    labels = torch.from_numpy(rs.randint(0, TEMPLATES, size=n)).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = templates[labels] + 0.5 * torch.rand(n, HW, HW, 3, device="cuda", generator=g)
    return x, torch.nn.functional.one_hot(labels, CLASSES).float()


def generator_mask(seed, x, rate):
    """Inverted dropout from a ``torch.Generator`` seeded with ``seed``."""
    keep = 1.0 - rate
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    u = torch.rand(x.shape, generator=g, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[12345])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--generator", action="store_true")
    args = ap.parse_args(argv)
    counter_mask, step_seed = base.dropout_mask, driver.step_seed
    kinds = ("counter", "generator") if args.generator else ("counter",)
    try:
        for seed in args.seeds:
            x, y = images(seed, BATCH * STEPS)
            for kind in kinds:
                base.dropout_mask = counter_mask if kind == "counter" else generator_mask
                recovered = 0
                for stream in range(args.streams):
                    driver.step_seed = lambda s, it, o=1000 * stream: step_seed(s + o, it)
                    net = get_model("googlenet").build(device="cuda", seed=seed)
                    net.fit(x, y, batch_size=BATCH)
                    losses = net.score_history
                    ok = bool(np.mean(losses[-5:]) < losses[0])
                    recovered += ok
                    print(json.dumps({"seed": seed, "masks": kind, "stream": stream,
                                      "recovered": ok, "losses": losses}), flush=True)
                print(json.dumps({"seed": seed, "masks": kind, "streams": args.streams,
                                  "recovered": recovered}), flush=True)
    finally:
        base.dropout_mask, driver.step_seed = counter_mask, step_seed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
