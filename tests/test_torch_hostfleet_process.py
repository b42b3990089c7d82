"""The port's elastic training fleet over REAL host processes on the CPU,
with real faults: a SIGKILLed host becomes a rollback + reshard whose
digest equals a fault-free run on the final topology from the same
bundle; a SIGSTOPped host (alive but silent) is caught by the round
watchdog; and, in the slow tier, a respawn re-forms at full size with a
clean run's digest. The port of ``tests/test_hostfleet_process.py``."""

import os
import shutil
import signal

import pytest

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.fleet.supervisor import default_worker_env
from deeplearning4j_tpu_torch.hostfleet import TrainingFleetSupervisor

#: one intra-op thread a host: the hosts share the test machine's cores
#: with the other test workers
HOST_ENV = dict(default_worker_env(), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


@pytest.fixture(autouse=True)
def _isolate():
    telemetry.reset()
    telemetry.disable()
    yield
    telemetry.reset()
    telemetry.disable()


def _run(workdir, *, world=2, rounds=3, respawn=False, kill_sig=None, kill_after=0,
         round_timeout_s=60.0, round_sleep_s=0.0, seed_bundle=None):
    os.makedirs(workdir, exist_ok=True)
    if seed_bundle is not None:
        shutil.copyfile(seed_bundle, os.path.join(workdir, "bundle.zip"))
    sup = TrainingFleetSupervisor(world, workdir=workdir, total_rounds=rounds,
                                  dispatches_per_round=1, respawn=respawn,
                                  round_timeout_s=round_timeout_s, round_sleep_s=round_sleep_s,
                                  device="cpu", env=HOST_ENV)
    sup.start()
    try:
        if kill_sig is not None:
            # host 0's round line comes after it wrote the round's bundle,
            # so the rollback target exists before the fault lands
            sup.wait_for_round(kill_after, timeout=150, host=0)
            sup.kill_host(world - 1, sig=kill_sig)
        return sup.wait(timeout=280)
    finally:
        sup.stop()


def test_sigkill_becomes_rollback_reshard_digest_exact(tmp_path):
    """Kill one of two hosts mid-round: the job finishes at world 1 from the
    rollback bundle, digest-exact with a fault-free one-host job resuming
    from that same bundle."""
    telemetry.enable()
    res = _run(str(tmp_path / "chaos"), kill_sig=signal.SIGKILL, round_sleep_s=0.3)
    assert res["final_world"] == 1
    assert res["tally"]["host_death"] == 1 and res["tally"]["clean"] == 1
    assert res["tally"]["rollback_rounds"] >= 1
    assert res["iterations"] == [3]
    gen0 = res["generations"][0]
    assert gen0["reason"] == "host_death" and gen0["resumable"] is True
    assert os.path.isdir(gen0["postmortem"])

    ref = _run(str(tmp_path / "ref"), world=1, seed_bundle=gen0["rollback_bundle"])
    assert ref["tally"]["host_death"] == 0
    assert res["digests"][0] == ref["digests"][0], \
        "recovery was not bit-exact with the fault-free reference"
    reg = telemetry.get_registry()
    assert reg.get("hostfleet_generations_total").value(reason="host_death") == 1
    assert sum(s["value"] for s in reg.get(
        "hostfleet_rollback_rounds_total").snapshot()["series"]) >= 1


def test_sigstop_wedge_is_caught_by_the_round_watchdog(tmp_path):
    """SIGSTOP leaves the host alive but silent: no exit to poll, the
    survivor wedged in the round exchange. The watchdog (heartbeats +
    exchange progress + the line clock) bounds it: teardown (the stopped
    host SIGKILLed), re-form, finish."""
    telemetry.enable()
    res = _run(str(tmp_path / "stall"), kill_sig=signal.SIGSTOP, round_timeout_s=6.0,
               round_sleep_s=0.2)
    assert res["final_world"] == 1
    assert res["tally"]["host_death"] == 1 and res["tally"]["clean"] == 1
    assert res["iterations"] == [3]
    detail = res["generations"][0]["detail"]
    assert ("watchdog_stall" in detail) or ("host_exit" in detail)


@pytest.mark.slow  # the JAX test's tier: a clean run and a chaos run
def test_respawn_reform_at_full_size_matches_clean_run(tmp_path):
    telemetry.enable()
    clean = _run(str(tmp_path / "clean"))
    res = _run(str(tmp_path / "resp"), respawn=True, kill_sig=signal.SIGKILL,
               round_sleep_s=0.3)
    assert res["final_world"] == 2 and res["tally"]["respawn"] == 1
    assert len(set(res["digests"])) == 1
    assert res["digests"][0] == clean["digests"][0], \
        "kill->respawn->restore->resume diverged from the clean run"
