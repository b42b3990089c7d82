"""The port's continuous-learning chaos legs over real subprocesses, after
``tests/test_continuous_process.py``: the port's runner
(``python -m deeplearning4j_tpu_torch.continuous.runner --device cpu``)
and chaos publisher (``... .continuous.chaos --device cpu``), which import
neither JAX nor its package. A SIGTERM dumps the flight ring and the
process dies by the default disposition; a NaN batch in a live stream
rolls back and ends bit-exact with an offline run that never saw it; a
SIGTERM mid-run, then ``--resume`` from the on-disk bundle, ends bit-exact
with an uninterrupted run."""

import json
import os
import signal
import sys
import time

import pytest

import procutil

RUNNER = [sys.executable, "-m", "deeplearning4j_tpu_torch.continuous.runner", "--device", "cpu"]
PUBLISHER = [sys.executable, "-m", "deeplearning4j_tpu_torch.continuous.chaos",
             "--device", "cpu"]


def _env(tmp_path):
    return procutil.scrubbed_env(DL4J_TPU_FLIGHT_DIR=str(tmp_path))


def _read_ready(proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        line = line.strip()
        if line.startswith("{"):
            doc = json.loads(line)
            if doc.get("continuous_ready"):
                return doc
    proc.kill()
    pytest.fail("runner never printed its ready line")


def _await_rounds(proc, n, timeout=120):
    seen = 0
    deadline = time.time() + timeout
    while seen < n and time.time() < deadline:
        line = proc.stdout.readline().strip()
        if line.startswith("{") and "round" in line:
            seen = json.loads(line)["round"]
        elif not line:
            break
    return seen


def _dumps(tmp_path):
    return sorted(f for f in os.listdir(tmp_path) if f.startswith("dl4j_tpu_flight_"))


def test_runner_sigterm_dumps_the_ring_then_dies_default(tmp_path):
    runner = procutil.spawn(
        RUNNER + ["--snapshot", str(tmp_path / "s.zip"), "--offline-n", "6",
                  "--install-sigterm", "--round-lines", "--round-sleep-s", "30"],
        env=_env(tmp_path))
    _read_ready(runner)
    assert _await_rounds(runner, 1) >= 1
    os.kill(runner.pid, signal.SIGTERM)
    runner.wait(timeout=30)
    runner.stdout.close()
    runner.stderr.close()
    assert runner.returncode == -signal.SIGTERM  # the default action ran
    (dump,) = _dumps(tmp_path)
    with open(tmp_path / dump) as f:
        doc = json.load(f)
    assert doc["reason"] == "signal:SIGTERM"
    assert doc["n_records"] >= 1 and doc["records"][0]["step"] == 0


def test_nan_rollback_parity_real_subprocess(tmp_path):
    """A streaming run with one poisoned batch rolls back and resumes; its
    final digest equals an offline run that never saw the poison."""
    from deeplearning4j_tpu_torch.streaming.pubsub import StreamingBroker
    n, poison, seed = 6, 2, 77
    env = _env(tmp_path)
    broker = StreamingBroker().start()
    try:
        runner = procutil.spawn(
            RUNNER + ["--snapshot", str(tmp_path / "chaos.zip"),
                      "--broker-port", str(broker.port), "--gen-seed", str(seed),
                      "--quiet-timeout-s", "1.0", "--ingest-retries", "8",
                      "--until-steps", str(n - 1)], env=env)
        # the reference leg runs beside the streaming one
        ref = procutil.spawn(
            RUNNER + ["--snapshot", str(tmp_path / "ref.zip"), "--offline-n", str(n),
                      "--gen-seed", str(seed), "--offline-skip", str(poison)], env=env)
        _read_ready(runner)
        pub = procutil.spawn(
            PUBLISHER + ["--port", str(broker.port), "--n", str(n), "--gen-seed", str(seed),
                         "--poison", str(poison), "--interval-s", "0.05"], env=env)
        (out, _err), (pout, _perr), (rout, _rerr) = procutil.communicate_all(
            [runner, pub, ref], timeout=240, fail=pytest.fail)
    finally:
        broker.close()
    assert json.loads(pout.strip().splitlines()[-1]) == {"published": n}
    done = procutil.last_json_line(out)
    assert done["continuous_done"]
    assert done["summary"]["rollbacks"] == 1
    assert done["iteration"] == n - 1
    assert done["flight_dumps"]  # the rollback wrote a postmortem
    # no uncounted loss: the one rolled-back step is on the books
    rolled = done["counters"]["continuous_rolled_back_steps_total"]
    assert sum(rolled.values()) == 1
    assert done["digest"] == procutil.last_json_line(rout)["digest"]  # bit-exact


def test_sigterm_midrun_resume_bit_exact(tmp_path):
    n, seed = 8, 55
    env = _env(tmp_path)
    runner = procutil.spawn(
        RUNNER + ["--snapshot", str(tmp_path / "term.zip"), "--offline-n", str(n),
                  "--gen-seed", str(seed), "--install-sigterm", "--round-lines",
                  "--round-sleep-s", "0.4"], env=env)
    _read_ready(runner)
    assert _await_rounds(runner, 2) >= 2
    os.kill(runner.pid, signal.SIGTERM)
    runner.wait(timeout=30)
    assert runner.returncode == -signal.SIGTERM
    runner.stdout.close()
    runner.stderr.close()
    assert _dumps(tmp_path)  # the preemption left a postmortem
    # resume from the bundle; --offline-start -1 = the bundle's iteration
    resumed = procutil.spawn(
        RUNNER + ["--snapshot", str(tmp_path / "term.zip"), "--resume", "--offline-n", str(n),
                  "--gen-seed", str(seed), "--offline-start", "-1"], env=env)
    ref = procutil.spawn(
        RUNNER + ["--snapshot", str(tmp_path / "ref2.zip"), "--offline-n", str(n),
                  "--gen-seed", str(seed)], env=env)
    (out, _e1), (rout, _e2) = procutil.communicate_all([resumed, ref], timeout=240,
                                                       fail=pytest.fail)
    done, rdone = procutil.last_json_line(out), procutil.last_json_line(rout)
    assert done["iteration"] == rdone["iteration"] == n
    assert done["digest"] == rdone["digest"]  # resume is bit-exact
