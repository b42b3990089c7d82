"""Host-side synchronization helpers.

Training loops keep their per-step losses on the device and fetch them in
one transfer at the end: a ``float(loss)`` a step waits for the device
each time and serializes the host's batch preparation against the steps.
"""

from __future__ import annotations

import torch


def fetch_losses(losses):
    """One host fetch of a list of device scalars -> list[float].

    The scalars are stacked on their device and copied once
    (``torch.stack(...).tolist()``), against one wait and one copy per
    element for ``float()`` on each.
    """
    if not losses:
        return []
    return torch.stack([torch.as_tensor(v) for v in losses]).tolist()
