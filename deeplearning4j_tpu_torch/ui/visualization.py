"""Convolutional activation visualization.

The port of ``deeplearning4j_tpu/ui/visualization.py``. Reference analog:
deeplearning4j-ui's ConvolutionalIterationListener
(``org/deeplearning4j/ui/weights/ConvolutionalIterationListener.java``):
every N iterations it renders the activations of each conv layer for the
first example of the current minibatch into a tiled grayscale image and
ships it to the UI.

Here the listener renders the same tiled grid (``activations_to_grid``, a
numpy copy of the JAX function) into an in-memory history and, where PIL
is installed, to PNG files. The grid layout matches the reference: one
tile per channel, row-major, with a 1px separator. Activations are NHWC,
the layout of both packages; the forward runs on the model's device and
only the 4-D activations of the first example cross to the host.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.listeners import TrainingListener


def activations_to_grid(act, pad=1, per_row=None):
    """Tile [H, W, C] (or [N, H, W, C]: first example) activations into one
    [rows*(H+pad), cols*(W+pad)] uint8 grayscale image, each channel
    min-max normalized (the reference's per-channel scaling)."""
    a = np.asarray(act, np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.ndim != 3:
        raise ValueError(f"Expected HWC activations, got shape {a.shape}")
    h, w, c = a.shape
    cols = per_row or int(math.ceil(math.sqrt(c)))
    rows = int(math.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad), np.uint8)
    for i in range(c):
        ch = a[..., i]
        lo, hi = float(ch.min()), float(ch.max())
        img = np.zeros_like(ch) if hi - lo < 1e-12 else (ch - lo) / (hi - lo)
        r, col = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = (img * 255).astype(np.uint8)
    return grid


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


class ConvolutionalIterationListener(TrainingListener):
    """Every ``frequency`` iterations, render each conv layer's activations
    for the first example of the last minibatch."""

    def __init__(self, frequency=10, output_dir=None, keep_history=True):
        self.frequency = frequency
        self.output_dir = output_dir
        self.keep_history = keep_history
        self.history = []  # [(iteration, layer_index, grid array)]
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        if iteration % self.frequency != 0:
            return
        x = getattr(model, "last_input", None)
        if x is None:
            return
        x = x[:1]
        try:
            grids = self._conv_activations(model, x)
        except Exception:  # noqa: BLE001 -- a visualization never stops training
            return
        for li, grid in grids:
            if self.keep_history:
                self.history.append((iteration, li, grid))
        if self.output_dir:
            try:
                from PIL import Image
            except ImportError:
                return  # in-memory history still collected above
            for li, grid in grids:
                Image.fromarray(grid).save(os.path.join(
                    self.output_dir, f"iter{iteration:06d}_layer{li}.png"))

    @staticmethod
    def _conv_activations(model, x):
        # one forward pass captures every layer's activation
        acts = model.feed_forward(x)
        grids = []
        for li, out in enumerate(acts):
            if out.ndim == 4:  # NHWC conv-family activation
                grids.append((li, activations_to_grid(_host(out))))
        return grids
