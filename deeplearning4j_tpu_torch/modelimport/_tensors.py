"""Copying imported arrays into a network's initialised tensors."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def install(dst: torch.Tensor, arr) -> None:
    """Copy ``arr`` (numpy, same shape) into ``dst`` in place: on ``dst``'s
    device and in its dtype."""
    dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
