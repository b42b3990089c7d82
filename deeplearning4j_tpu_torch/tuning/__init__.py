"""Kernel tuner over the Hopper kernels' launch plans, with a persistent DB.

The port of ``deeplearning4j_tpu/tuning/``, retargeted from Pallas block
sizes to the ``plan()``s of the CUDA kernels (``ops/conv_stats.py``,
``ops/lstm_seq.py``, ``ops/attention.py``): a config is the set of plan
fields a compiled library takes at run time, so tuning never rebuilds a
library.

* :mod:`tuning.space` — per-kernel config spaces with static pruning
  (compiled tiles and sizes, shared memory, co-residency of a cooperative
  grid, alignment and stride rules, configs that launch alike);
* :mod:`tuning.measure` — CUDA-event candidate timing with a parity gate
  (every winner held against the kernel's plain version at the kernel
  checks' tolerances);
* :mod:`tuning.db` — the persistent :class:`TuningDB`, keyed kernel id x
  shape bucket x dtype x backend fingerprint, consulted by the dispatch
  seams once per distinct plan (env ``DL4J_TPU_TUNING_DB``), every
  interaction counted into ``tuning_db_total{event=}``;
* :mod:`tuning.tune` — the per-kernel search drivers behind the ``tune``
  CLI verb.

A populated DB composes with the warm manifests (``utils/compile_cache``):
its fingerprint folds into every manifest signature, so a warm restart
seeds the tuned plans with no lookup while a re-tuned DB misses the stale
entries.
"""

from deeplearning4j_tpu_torch.tuning.db import (ENV_DB, TuningDB, active_db,
                                                active_fingerprint, bucket_shape,
                                                event_counts, plan_binding, set_db,
                                                tuned_config)
from deeplearning4j_tpu_torch.tuning.measure import (Measurement, parity_diff, search,
                                                     time_callable)
from deeplearning4j_tpu_torch.tuning.space import (SMEM_LIMIT, SPACES, default_config,
                                                   enumerate_space, prune, validate)
from deeplearning4j_tpu_torch.tuning.tune import KERNELS, SMOKE_PRESETS, tune_kernels

__all__ = ["ENV_DB", "KERNELS", "Measurement", "SMEM_LIMIT", "SMOKE_PRESETS", "SPACES",
           "TuningDB", "active_db", "active_fingerprint", "bucket_shape", "default_config",
           "enumerate_space", "event_counts", "parity_diff", "plan_binding", "prune", "search",
           "set_db", "time_callable", "tune_kernels", "tuned_config", "validate"]
