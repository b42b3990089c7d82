"""Continuous learning: the resumable step driver and the streaming
trainer, the port of ``deeplearning4j_tpu/continuous/``.

* :mod:`driver`: ``StepDriver``, the resumable dispatch loop every fit
  path runs (``run_round``, ``checkpoint``, ``restore``).
* :mod:`trainer`: ``ContinuousTrainer``, streaming ingest with bounded
  staleness, the numerics watchdog policing every round, rollback to the
  last good bundle on ``NumericsError`` (counted, bit-exact), and
  periodic healthy snapshots handed to serving
  (``registry_updater`` / ``fleet_updater``).
* :mod:`chaos`: the fault-injection harness (poisoned batches, producer
  death, delayed ingest) and the deterministic batch and digest plumbing
  the parity checks are built on; also the publisher subprocess.
* :mod:`runner`: the subprocess entry point
  (``python -m deeplearning4j_tpu_torch.continuous.runner``, or the
  ``continuous`` CLI verb).
"""

__all__ = ["ContinuousTrainer", "RoundResult", "StepDriver",
           "StreamingTrainSource", "fleet_updater", "registry_updater"]

_HOMES = {"RoundResult": "driver", "StepDriver": "driver"}


def __getattr__(name):
    # lazy: the chaos publisher subprocess imports this package on its way
    # to chaos.py and never needs the driver's import graph
    if name in __all__:
        import importlib
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.continuous.{_HOMES.get(name, 'trainer')}")
        return getattr(mod, name)
    raise AttributeError(name)
