"""One-dispatch-late score fetching for the training loops.

The port of ``deeplearning4j_tpu/telemetry/scorepipe.py``'s
``ScorePipeline``: ``float(loss)`` right after a step blocks the host on
the step it just issued, so a loop pushes dispatch *i*'s device losses
and gets dispatch *i - 1*'s back resolved, a fetch the dispatch just
issued overlaps. A K-step dispatch (``nn/fused.py``) pushes a ``[K]``
tensor and resolves it in one host transfer: one fetch per K steps. Every
fit loop of the port resolves its scores here (``continuous/driver.py``).

``StepRecordEmitter`` (JAX ``scorepipe.py:137``, ``:164``) fans one
resolved dispatch into its step records: ``score_history``, the listeners'
``iteration_done``, and with telemetry on the per-iteration instruments
(``train_step_seconds``, ``train_etl_seconds``, ``train_iterations_total``,
``train_score``), the HBM gauges and a flight-recorder record a step (also
with the watchdog armed), and the dispatch's trace closed.
"""

from __future__ import annotations

import torch

__all__ = ["ScorePipeline", "StepRecordEmitter"]


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


class StepRecordEmitter:
    """Turns a resolved ``(score, meta)`` into the per-step record of one
    fit loop: ``net.score_history``, listener callbacks, and (``meta['rec']``:
    telemetry was on at the dispatch) the registry instruments, the memory
    gauges and the flight ring. A list ``score`` is a K-step dispatch: one
    record a real step, the dispatch's times split evenly (the captured
    graph exposes no per-step boundary)."""

    def __init__(self, net, step_hist, etl_hist, iters, score_gauge, recorder):
        self.net = net
        self.step_hist, self.etl_hist = step_hist, etl_hist
        self.iters, self.score_gauge = iters, score_gauge
        self.recorder = recorder

    def _record(self, meta, step, score, step_t, etl_t, mem, **extra):
        fr = {"step": step, "step_time_s": step_t, "etl_time_s": etl_t, "score": score,
              **extra}
        if meta.get("trace_id"):
            # StepRecords are traceable: the flight-recorder ring (and any
            # dump built from it) links each step to its causal timeline
            fr["trace_id"] = meta["trace_id"]
        if meta.get("rec"):
            self.step_hist.observe(step_t)
            self.etl_hist.observe(etl_t)
            self.iters.inc()
            self.score_gauge.set(score)
            if mem:
                fr.update(mem)
        if meta.get("rec") or meta.get("health"):
            self.recorder.note(**fr)

    def emit(self, score, meta):
        from deeplearning4j_tpu_torch.telemetry import devices as _devices
        net = self.net
        mem = _devices.poll_memory() if meta.get("rec") else None
        if isinstance(score, list):
            k = max(int(meta.get("k") or 1), 1)
            scores = score[:k]
            it0 = meta["iteration"] - len(scores)
            step_t = meta.get("step_time_s", 0.0) / max(len(scores), 1)
            etl_t = meta["etl_time_s"] / max(len(scores), 1)
            for j, s in enumerate(scores):
                net.score_history.append(s)
                self._record(meta, meta["step"] + j, s, step_t, etl_t, mem, fused_k=k)
                for lst in net.listeners:
                    lst.iteration_done(net, it0 + j + 1, s, etl_t)
        else:
            net.score_history.append(score)
            self._record(meta, meta["step"], score, meta.get("step_time_s", 0.0),
                         meta["etl_time_s"], mem)
            if meta.get("chunks"):
                # a graph's TBPTT batch: one callback a chunk
                for (it, _), v in zip(meta["chunks"], meta["chunk_scores"]):
                    for lst in net.listeners:
                        lst.iteration_done(net, it, v)
            else:
                for lst in net.listeners:
                    lst.iteration_done(net, meta["iteration"], score, meta["etl_time_s"])
        tctx = meta.get("trace")
        if tctx is not None:
            # the dispatch's causal story ends when its score resolved (one
            # dispatch late) and its records and callbacks landed
            tctx.finish()
