"""Training listeners (reference: optimize/api/TrainingListener.java and
optimize/listeners/: ScoreIterationListener, PerformanceListener,
CollectScoresIterationListener, TimeIterationListener,
EvaluativeListener).

The port of ``deeplearning4j_tpu/nn/listeners.py``, the same classes and
callbacks. Both network kinds call them from every fit loop
(``continuous.StepDriver``: ``fit`` at K=1 and K > 1, its truncated-BPTT
branch and the graph's). The contract:

* ``iteration_done(model, iteration, score, etl_time)`` for step *i* fires
  once step *i*'s loss has been fetched, which the driver does one
  dispatch late (``telemetry.ScorePipeline``, while the next dispatch
  runs on the card; a K-step dispatch's K losses in one fetch): a
  listener never makes the host wait on the dispatch it just issued.
  ``iteration`` counts steps from 1 (the network's iteration counter
  after the step); a TBPTT batch of a
  MultiLayerNetwork reports once with the mean of its chunks' losses, a
  graph's TBPTT batch once a chunk, as in the JAX package.
* ``on_epoch_start`` / ``on_epoch_end`` bracket each epoch; the last
  step's callback lands before ``on_epoch_end``.
* ``on_fit_end`` runs from the fit loops' ``finally`` block, whether fit
  returned or raised; a hook that raises is logged and does not starve
  the others (``run_fit_end_hooks``).

``PerformanceListener`` reports samples and batches a second and the ETL
time (the host-to-device transfer of the batch); on a CUDA device it adds
``device_mb_in_use`` (``torch.cuda.memory_allocated``), and on the CPU
nothing in its place. ``ProfilerListener`` brackets a window of
iterations in ``torch.profiler`` and writes a Chrome trace into
``log_dir``; ``memory_profile=True`` records the CUDA caching allocator's
history over the window and writes its snapshot there.
"""

from __future__ import annotations

import logging
import os
import time

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


def run_fit_end_hooks(model):
    """Invoke every listener's ``on_fit_end`` from the fit loops' finally
    blocks. Each hook is isolated: a raising cleanup must neither mask the
    training exception nor starve later listeners of their cleanup."""
    for l in getattr(model, "listeners", ()):
        hook = getattr(l, "on_fit_end", None)
        if callable(hook):
            try:
                hook(model)
            except Exception:
                logger.warning("on_fit_end failed for %s", type(l).__name__, exc_info=True)


class TrainingListener:
    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        pass

    def on_fit_end(self, model):
        """Invoked by the fit loops in a ``finally`` block: fires whether
        fit() completed or raised. Listeners holding open resources (a
        profiler window, a file) release them here."""


class ScoreIterationListener(TrainingListener):
    def __init__(self, frequency=10, print_fn=None):
        self.frequency = frequency
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self.scores = []

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        if iteration % self.frequency == 0:
            self.print_fn(f"Score at iteration {iteration} is {score}")
        self.scores.append((iteration, score))


class PerformanceListener(TrainingListener):
    """Samples/sec + batches/sec + ETL time per iteration (reference:
    PerformanceListener.java:109)."""

    def __init__(self, frequency=10, report_batch_size=None, print_fn=None):
        self.frequency = frequency
        self.batch_size = report_batch_size
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self._last = None
        self.records = []

    @staticmethod
    def _infer_batch_size(model):
        """Leading dim of the batch the fit loop just consumed (both fit
        loops keep it as ``last_input``)."""
        x = getattr(model, "last_input", None)
        shape = getattr(x, "shape", None)
        return shape[0] if shape else None

    @staticmethod
    def _device_fields(model):
        """The caching allocator's bytes in use on the model's CUDA device
        (a host-side counter: no sync); nothing on the CPU."""
        dev = getattr(model, "device", None)
        if dev is None or dev.type != "cuda":
            return {}
        return {"device_mb_in_use": torch.cuda.memory_allocated(dev) / 2**20}

    @staticmethod
    def _telemetry_fields():
        """The gauges the instrumented fit loop just refreshed (JAX
        ``listeners.py:91-98``), read back from the shared registry (no
        device sync, no recompute) when telemetry is on; {} otherwise."""
        from deeplearning4j_tpu_torch import telemetry
        reg = telemetry.get_registry()
        if not reg.enabled:
            return {}
        out = {}
        # grad_norm only while the watchdog refreshes it: a stale gauge of
        # an earlier watchdog-on fit must not misreport this run
        if telemetry.health.get_monitor().active:
            g = reg.get("train_grad_norm")
            if g is not None and g.labelsets():
                out["grad_norm"] = g.value()
        g = reg.get("device_bytes_in_use")
        if g is not None:
            vals = [g.value(**ls) for ls in g.labelsets()]
            if vals:
                out["device_mb_in_use"] = max(vals) / 2**20
        g = reg.get("live_array_bytes")
        if g is not None and g.labelsets():
            out["live_array_mb"] = g.value() / 2**20
        return out

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        now = time.perf_counter()  # the only clock read per iteration
        if self._last is not None:
            dt = now - self._last
            bs = self.batch_size or self._infer_batch_size(model)
            rec = {"iteration": iteration, "iter_time_s": dt, "etl_time_s": etl_time,
                   "batches_per_sec": 1.0 / dt if dt > 0 else 0.0}
            if bs:
                rec["samples_per_sec"] = bs / dt if dt > 0 else 0.0
            rec.update(self._device_fields(model))
            rec.update(self._telemetry_fields())
            self.records.append(rec)
            if iteration % self.frequency == 0:
                parts = [f"iteration {iteration}: {dt * 1e3:.2f} ms/iter"]
                if bs:
                    parts.append(f"{rec.get('samples_per_sec', 0):.1f} samples/sec")
                parts.append(f"etl {etl_time * 1e3:.2f} ms")
                if "device_mb_in_use" in rec:
                    parts.append(f"device {rec['device_mb_in_use']:.1f} MB")
                self.print_fn(", ".join(parts))
        self._last = now


class CollectScoresListener(TrainingListener):
    def __init__(self):
        self.iterations = []
        self.scores = []

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        self.iterations.append(iteration)
        self.scores.append(score)


class TimeIterationListener(TrainingListener):
    """ETA logger (reference: TimeIterationListener)."""

    def __init__(self, total_iterations, frequency=50, print_fn=None):
        self.total = total_iterations
        self.frequency = frequency
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        if iteration and iteration % self.frequency == 0:
            elapsed = time.perf_counter() - self.start
            per_iter = elapsed / iteration
            remaining = max(self.total - iteration, 0) * per_iter
            self.print_fn(f"iteration {iteration}/{self.total}, ETA {remaining:.1f}s")


class EvaluativeListener(TrainingListener):
    """Periodic evaluation during training (reference: EvaluativeListener)."""

    def __init__(self, data, labels, frequency=100, evaluator=None):
        self.data = data
        self.labels = labels
        self.frequency = frequency
        self.evaluator = evaluator
        self.results = []

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        if iteration % self.frequency != 0:
            return
        preds = model.output(self.data)
        if self.evaluator is not None:
            self.results.append((iteration, self.evaluator(preds, self.labels)))
        else:
            self.results.append((iteration, preds))


class ProfilerListener(TrainingListener):
    """A ``torch.profiler`` trace of a window of training iterations:
    [start_iteration, start_iteration + n_iterations), written as a Chrome
    trace (``trace.json``) into ``log_dir``; open it in Perfetto or
    ``chrome://tracing``. The window records the card's kernels where the
    model lives on one. With ``memory_profile=True`` on a CUDA device the
    allocator's history over the window goes to ``memory_snapshot.pickle``
    (``torch.cuda.memory._dump_snapshot``; the PyTorch memory viz reads
    it). ``close_on_fit_end=False`` lets one window span several fit()
    calls; the caller then calls ``close()``."""

    def __init__(self, log_dir, *, start_iteration=10, n_iterations=5, memory_profile=False,
                 print_fn=None, close_on_fit_end=True):
        self.log_dir = str(log_dir)
        self.start_iteration = start_iteration
        self.n_iterations = n_iterations
        self.memory_profile = memory_profile
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self.close_on_fit_end = close_on_fit_end
        self._prof = None
        self._cuda = False
        self.completed = False
        self.traced_iterations = 0

    def _open(self, model):
        dev = getattr(model, "device", None)
        self._cuda = dev is not None and dev.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if self._cuda and self.memory_profile:
            torch.cuda.memory._record_memory_history()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def on_epoch_start(self, model):
        # start_iteration <= 1: from the very first step; iteration_done
        # fires after a step, so only epoch start runs before step 1
        if self._prof is None and not self.completed and self.start_iteration <= 1:
            self._open(model)

    def iteration_done(self, model, iteration, score, etl_time=0.0):
        # iteration_done(i) fires after step i: open once start-1 is done so
        # step ``start`` is the first one captured
        if self._prof is None and not self.completed \
                and iteration >= self.start_iteration - 1:
            self._open(model)
            return
        if self._prof is not None:
            self.traced_iterations += 1
            if self.traced_iterations >= self.n_iterations:
                if self._cuda:
                    torch.cuda.synchronize()  # the window's device work lands in it
                self.close()

    def on_fit_end(self, model):
        # fit returned (or raised) before the window completed: an open
        # profiler would leak into the next fit
        if self.close_on_fit_end:
            self.close()

    def close(self):
        """Stop the trace and write it. Called when the window completes;
        call it explicitly if training can end before the window does."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        self.completed = True
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        if self._cuda and self.memory_profile:
            torch.cuda.memory._dump_snapshot(os.path.join(self.log_dir, "memory_snapshot.pickle"))
            torch.cuda.memory._record_memory_history(enabled=None)
        truncated = ("" if self.traced_iterations >= self.n_iterations
                     else f" (window truncated: {self.n_iterations} requested; pass "
                          "close_on_fit_end=False to span multiple fit() calls)")
        self.print_fn(f"profiler trace: {self.traced_iterations} iterations in "
                      f"{time.perf_counter() - self._t0:.2f}s -> {self.log_dir}" + truncated)
