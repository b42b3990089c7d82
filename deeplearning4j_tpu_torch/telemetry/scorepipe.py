"""One-dispatch-late score fetching for the training loops.

The port of ``deeplearning4j_tpu/telemetry/scorepipe.py``'s
``ScorePipeline``: ``float(loss)`` right after a step blocks the host on
the step it just issued, so a loop pushes dispatch *i*'s device losses
and gets dispatch *i - 1*'s back resolved, a fetch the dispatch just
issued overlaps. A K-step dispatch (``nn/fused.py``) pushes a ``[K]``
tensor and resolves it in one host transfer: one fetch per K steps. Every
fit loop of the port resolves its scores here (``continuous/driver.py``);
the JAX package's ``StepRecordEmitter`` waits for the telemetry registry.
"""

from __future__ import annotations

import torch

__all__ = ["ScorePipeline"]


class ScorePipeline:
    """One-late ``(score, meta)`` resolution for one training loop."""

    __slots__ = ("_pending",)

    def __init__(self):
        self._pending = None

    def push(self, loss, meta=None):
        """Queue this dispatch's device loss; resolve and return the
        previous one's ``(score, meta)``, or None on the first push."""
        prev, self._pending = self._pending, (loss, meta)
        if prev is None:
            return None
        return self._resolve(prev)

    def flush(self):
        """Resolve the pending entry (the epoch's or loop's end), or None."""
        prev, self._pending = self._pending, None
        if prev is None:
            return None
        return self._resolve(prev)

    @property
    def pending(self):
        return self._pending is not None

    def abandon(self):
        """Drop the pending entry without resolving it (the exception path:
        a fetch would add a device wait to a failing loop)."""
        self._pending = None

    @staticmethod
    def _resolve(item):
        loss, meta = item
        if torch.is_tensor(loss) and loss.dim():
            # stacked [K] losses of a K-step dispatch: one transfer
            return [float(v) for v in loss.tolist()], meta
        if isinstance(meta, dict) and meta.get("chunks"):
            # a graph's TBPTT batch: its chunks' losses, fetched together
            values = torch.stack([c for _, c in meta["chunks"]]).tolist()
            return float(loss), dict(meta, chunk_scores=values)
        return float(loss), meta
