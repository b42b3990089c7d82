"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and no
    card is present. The port never drops to the CPU on its own: a caller
    that wants the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev


def as_device(a, device):
    """``a`` (numpy or tensor) on ``device``, through pinned memory without
    a host wait on a card."""
    t = a if torch.is_tensor(a) else torch.from_numpy(a)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
