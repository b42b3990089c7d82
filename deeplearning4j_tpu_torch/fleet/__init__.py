"""Fleet serving tier: a multi-process engine pool behind one front.

The port of ``deeplearning4j_tpu/fleet/``, host code over the port's
serving engine:

* :class:`FleetWorker` (``fleet/worker.py``): one process serving one
  :class:`~deeplearning4j_tpu_torch.serving.ServingEngine` on its device
  behind a local HTTP wire protocol (``/submit``, ``/health``, ``/stats``,
  ``/swap``). Started from a checkpoint and a warm manifest, a worker
  warms with the manifest's kernel libraries and launch plans: no nvcc
  run and no tuning lookup, which is what makes an elastic replacement a
  seconds-long blip.
* :class:`FleetRouter` (``fleet/router.py``): the single admission and
  routing front: load-aware dispatch (least outstanding rows, bounded
  per-worker in-flight window), deadline-aware shedding with the serving
  tier's shed semantics (``serving_shed_total`` and ``fleet_*``
  counters), cross-worker ``/health`` aggregation, and idempotent
  retry-on-dead-worker: a request is answered, retried onto a live
  worker, or counted-shed; never silently dropped.
* :class:`FleetSupervisor` (``fleet/supervisor.py``): spawns N workers
  as subprocesses, probes liveness, and replaces a dead worker from the
  same bundle and manifest (the replacement's warm start judged from its
  ready line), fanning hot swaps out to every worker warm-then-atomic.
* :class:`FleetProber` (``fleet/prober.py``): known-answer canaries
  through the whole submit path, ``origin=probe``.

Quickstart::

    from deeplearning4j_tpu_torch import fleet
    sup = fleet.FleetSupervisor(2, model_path="ckpt.zip",
                                warm_manifest="wm.zip", buckets=[1, 8])
    router = fleet.FleetRouter(max_queue=256, default_deadline_s=0.25)
    sup.attach(router)      # endpoints follow respawns automatically
    sup.start()
    y = router.submit(example).get(timeout=1.0)

:func:`set_default_front` registers the process-default front, which
:func:`fleet_status` reports on and which plugs the workers into the
federated metrics and the cluster timeline.
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.fleet.prober import (FleetProber,
                                                   seq_sweep_canaries)
from deeplearning4j_tpu_torch.fleet.router import FleetRouter
from deeplearning4j_tpu_torch.fleet.supervisor import (FleetSupervisor,
                                                       default_worker_env)
from deeplearning4j_tpu_torch.fleet.worker import FleetWorker

__all__ = ["FleetProber", "FleetRouter", "FleetSupervisor", "FleetWorker",
           "default_worker_env", "fleet_status", "get_default_front",
           "reset", "seq_sweep_canaries", "set_default_front"]

_front_lock = threading.Lock()
_front = {"router": None, "supervisor": None}


def set_default_front(router=None, supervisor=None):
    """Register the process-default fleet front: the router/supervisor
    pair :func:`fleet_status` reports on. Registering a router also plugs
    the fleet into the cluster observability plane: its workers become
    federation targets (``telemetry/federate.py``) and cluster-timeline
    sources (``telemetry/timeline.py``)."""
    from deeplearning4j_tpu_torch.telemetry import federate as _federate
    from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
    with _front_lock:
        if router is not None:
            _front["router"] = router
        if supervisor is not None:
            _front["supervisor"] = supervisor
    if router is not None:
        _federate.register_target_provider(_front_metric_targets)
        _timeline.register_source_provider(_front_timeline_sources)


def _front_metric_targets():
    """Federation targets of the default front's workers."""
    router, _sup = get_default_front()
    if router is None:
        return []
    return [(wid, addr + "/metrics") for wid, addr in router.endpoints()]


def _front_timeline_sources():
    """Cluster-timeline sources of the default front (the router's own
    ring is the UIServer process's 'local' source already)."""
    router, _sup = get_default_front()
    if router is None:
        return []
    return router.timeline_sources(include_local=False)


def get_default_front():
    """(router, supervisor) of the process-default front (either may be
    None when nothing registered them)."""
    with _front_lock:
        return _front["router"], _front["supervisor"]


def reset():
    """Drop the process-default front (tests). Does NOT stop the router
    or supervisor — ownership stays with whoever built them."""
    from deeplearning4j_tpu_torch.telemetry import federate as _federate
    from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
    with _front_lock:
        _front["router"] = None
        _front["supervisor"] = None
    _federate.unregister_target_provider(_front_metric_targets)
    _timeline.unregister_source_provider(_front_timeline_sources)


def fleet_status(probe=False):
    """The ``/fleet`` payload: router counters + per-worker dispatch
    state, the supervisor's worker table + respawn ledger and its CACHED
    last health probe per worker (the cross-worker aggregation, served
    without re-probing). ``probe=True`` re-probes
    every worker's ``/health`` live through the router instead."""
    router, supervisor = get_default_front()
    if router is None and supervisor is None:
        return {"active": False,
                "note": "no fleet front registered in this process "
                        "(register one with fleet.set_default_front)"}
    out = {"active": True}
    if router is not None:
        out["router"] = router.stats()
        if probe:
            out["health"] = router.health()
    if supervisor is not None:
        out["workers"] = supervisor.status()
    from deeplearning4j_tpu_torch.fleet import prober as _prober
    probe_status = _prober.status()
    if probe_status is not None:
        # the synthetic-monitoring verdicts ride /fleet so one read
        # answers "is the fleet up AND answering correctly"
        out["prober"] = probe_status
    return out
