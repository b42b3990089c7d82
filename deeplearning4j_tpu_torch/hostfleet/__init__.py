"""Elastic multi-host TRAINING: the port of
``deeplearning4j_tpu/hostfleet/``, the training half of the scale-out
tier the fleet package serves.

One :class:`~deeplearning4j_tpu_torch.hostfleet.supervisor.TrainingFleetSupervisor`
spawns N training processes (one per host), each running a
``ParallelTrainer`` (the zero1/fsdp sharded update) through
``StepDriver.run_round`` boundaries, with a cross-host exchange at every
round edge and a layout-free ``save_bundle`` checkpoint between rounds. A
host that dies mid-round becomes a **rollback + reshard**, not a job
restart: the watchdog detects the wedged round, the supervisor tears the
generation down, re-forms the ``torch.distributed`` group at the new
world size, and every process restores the last good bundle resharded
into the new topology: digest-equal to a fault-free run on that same
final topology.
"""

from deeplearning4j_tpu_torch.hostfleet.exchange import (ExchangeClient, ExchangeError,
                                                         ExchangeServer)
from deeplearning4j_tpu_torch.hostfleet.supervisor import TrainingFleetSupervisor

__all__ = ["ExchangeClient", "ExchangeError", "ExchangeServer", "TrainingFleetSupervisor"]
