"""The port's elastic training fleet (``deeplearning4j_tpu_torch/
hostfleet/``) held against the JAX package's on the CPU: the exchange's
mean bit for bit, its bounded failures, the group join's no-op and
counted failure, one worker run in process against the JAX worker on the
same bundle, a clean two-host job over real subprocesses, and the
``/health`` gauge."""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import procutil
from deeplearning4j_tpu import telemetry as jtelemetry
from deeplearning4j_tpu.continuous import chaos as jchaos
from deeplearning4j_tpu.hostfleet import exchange as jexchange
from deeplearning4j_tpu.hostfleet import worker as jworker
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.hostfleet import (ExchangeClient, ExchangeError, ExchangeServer,
                                                TrainingFleetSupervisor)
from deeplearning4j_tpu_torch.hostfleet import exchange as texchange
from deeplearning4j_tpu_torch.hostfleet import worker as tworker
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import tree_leaves


@pytest.fixture(autouse=True)
def _isolate():
    telemetry.reset()
    telemetry.disable()
    yield
    telemetry.reset()
    telemetry.disable()


# ----------------------------------------------------------------------
# the exchange
# ----------------------------------------------------------------------

def _contribs(world, seed=0):
    rs = np.random.RandomState(seed)
    return {pid: [rs.randn(5, 3).astype(np.float32), rs.randn(7),
                  np.array([pid + 10], np.int64), np.float32(rs.randn())]
            for pid in range(world)}


@pytest.mark.parametrize("world", [2, 3, 4])
def test_mean_is_bit_equal_to_jax(world):
    c = _contribs(world, seed=world)
    got = texchange._mean_in_pid_order(c, world)
    want = jexchange._mean_in_pid_order(c, world)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], np.array([10]))  # lowest pid's non-float leaf


def test_server_replies_the_pid_ordered_mean_whatever_the_arrival_order():
    srv = ExchangeServer(2, round_timeout_s=20)
    c = _contribs(2, seed=5)
    out = {}
    try:
        def run(pid):
            cl = ExchangeClient(srv.port, pid, timeout_s=20)
            try:
                out[pid] = cl.allreduce_mean(0, c[pid])
            finally:
                cl.close()

        t1 = threading.Thread(target=run, args=(1,))
        t1.start()  # pid 1 arrives first
        time.sleep(0.1)
        run(0)
        t1.join(timeout=20)
        want = jexchange._mean_in_pid_order(c, 2)
        for pid in (0, 1):
            for g, w in zip(out[pid], want):
                np.testing.assert_array_equal(g, w)
        assert srv.rounds_completed == 1 and srv.last_round == 0
    finally:
        srv.close()


def test_missing_contributor_is_bounded_not_a_hang():
    srv = ExchangeServer(2, round_timeout_s=0.5)
    try:
        c = ExchangeClient(srv.port, 0, timeout_s=0.5)
        t0 = time.monotonic()
        with pytest.raises(ExchangeError, match="incomplete|reply"):
            c.allreduce_mean(0, [np.zeros(2, np.float32)])
        assert time.monotonic() - t0 < 10
        c.close()
    finally:
        srv.close()


def test_server_close_releases_waiters():
    srv = ExchangeServer(2, round_timeout_s=30)
    c = ExchangeClient(srv.port, 0, timeout_s=30)
    errs = []

    def waiter():
        try:
            c.allreduce_mean(0, [np.zeros(1, np.float32)])
        except ExchangeError as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.3)
    srv.close()  # generation teardown mid-round
    t.join(timeout=10)
    assert not t.is_alive() and errs
    c.close()


def test_client_without_a_server_raises():
    with pytest.raises(ExchangeError, match="cannot reach"):
        ExchangeClient(procutil.free_port(), 0, timeout_s=1)


# ----------------------------------------------------------------------
# the group join
# ----------------------------------------------------------------------

def test_single_process_join_is_a_noop():
    from deeplearning4j_tpu_torch.parallel.distributed import (initialize_distributed,
                                                               shutdown_distributed)
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1) is False
    assert shutdown_distributed() is False


def test_unreachable_coordinator_fails_counted():
    from deeplearning4j_tpu_torch.parallel.distributed import initialize_distributed
    telemetry.enable()
    port = procutil.free_port()  # nothing listens here
    t0 = time.monotonic()
    with pytest.raises(Exception):
        initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                               process_id=1, backend="gloo", initialization_timeout=1,
                               connect_retries=1, retry_backoff_s=0.1)
    assert time.monotonic() - t0 < 60
    c = telemetry.get_registry().get("distributed_init_total")
    series = {ls["outcome"]: c.value(**ls) for ls in c.labelsets()}
    assert series.get("retried") == 1 and series.get("failed") == 1


# ----------------------------------------------------------------------
# one worker in process against the JAX worker
# ----------------------------------------------------------------------

def _jax_bundle(path):
    """A JAX-written bundle of the smoke net one step into training."""
    net = jchaos.smoke_net(seed=0)
    net.init()
    x, y = jchaos.gen_batches(11, 1)[0]
    net.fit(x, y)
    jser.save_bundle(net, path)


def _argv(work):
    return ["--process-id", "0", "--num-processes", "1", "--bundle", str(work / "bundle.zip"),
            "--resume", "--total-rounds", "4", "--heartbeat-dir", str(work / "hb")]


def test_worker_resumes_a_jax_bundle_like_the_jax_worker(tmp_path, capsys):
    src = tmp_path / "src.zip"
    _jax_bundle(str(src))
    jw, tw = tmp_path / "jax", tmp_path / "torch"
    for d in (jw, tw):
        d.mkdir()
        shutil.copyfile(src, d / "bundle.zip")
    jtelemetry.reset()
    try:
        assert jworker.main(_argv(jw)) == 0
    finally:
        jtelemetry.reset()
        jtelemetry.disable()
    assert tworker.main(_argv(tw) + ["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    import json
    docs = [json.loads(ln) for ln in lines]
    dones = [d for d in docs if d.get("hostfleet_done")]
    assert [d["start_round"] for d in dones] == [1, 1] and [d["rounds"] for d in dones] == [3, 3]
    assert dones[1]["step_recompiles"] == 0
    assert dones[1]["mode"] == "gspmd"
    a = tser.load_bundle(str(tw / "bundle.zip"), device="cpu").net
    b = tser.load_bundle(str(jw / "bundle.zip"), device="cpu").net
    assert a.iteration == b.iteration == 4
    for what in ("params", "opt_state"):
        la = list(tree_leaves(getattr(a, what)))
        lb = list(tree_leaves(getattr(b, what)))
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            np.testing.assert_allclose(torch.as_tensor(x).double().numpy(),
                                       torch.as_tensor(y).double().numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_worker_without_its_card_fails_init(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = tworker.main(["--process-id", "0", "--num-processes", "1", "--bundle",
                       str(tmp_path / "b.zip"), "--total-rounds", "1", "--heartbeat-dir",
                       str(tmp_path / "hb")])
    assert rc == tworker.RC_INIT_FAILED == 13
    out = capsys.readouterr().out
    assert '"stage": "device"' in out and "hostfleet_ready" not in out


# ----------------------------------------------------------------------
# the supervisor
# ----------------------------------------------------------------------

def test_supervisor_refuses_what_the_port_cannot_run(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="local_devices"):
        TrainingFleetSupervisor(2, workdir=str(tmp_path), total_rounds=1, local_devices=4,
                                device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingFleetSupervisor(2, workdir=str(tmp_path), total_rounds=1)


def test_rendezvous_port_is_held_for_host_0_alone():
    """The supervisor holds a generation's rendezvous port bound: no other
    bind to port 0 and no plain listener takes it, and host 0's store
    listens on it all the same."""
    import datetime
    import socket

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.hostfleet.supervisor import _reserve_port

    held = _reserve_port()
    others = []
    try:
        port = held.getsockname()[1]
        for _ in range(200):
            others.append(socket.socket())
            others[-1].bind(("127.0.0.1", 0))
            assert others[-1].getsockname()[1] != port
        plain = socket.socket()
        others.append(plain)
        with pytest.raises(OSError):
            plain.bind(("0.0.0.0", port))
            plain.listen()
        store = dist.TCPStore("127.0.0.1", port, 1, True,
                              timeout=datetime.timedelta(seconds=10))
        store.set("k", "v")
        assert store.get("k") == b"v"
        del store
    finally:
        for s in others:
            s.close()
        held.close()


def test_clean_two_host_run_agrees_counts_and_fans_snapshots(tmp_path):
    telemetry.enable()
    got, boom = [], [True]

    def hook(path):
        got.append(path)
        if boom[0]:
            boom[0] = False
            raise RuntimeError("serving lag")

    from deeplearning4j_tpu_torch.fleet.supervisor import default_worker_env
    sup = TrainingFleetSupervisor(2, workdir=str(tmp_path / "job"), total_rounds=2,
                                  round_timeout_s=60, serve_update=hook, serve_registry=True,
                                  device="cpu", env=dict(default_worker_env(),
                                                         OMP_NUM_THREADS="1"))
    sup.start()
    try:
        res = sup.wait(timeout=180)
    finally:
        sup.stop()
    assert res["final_world"] == 2 and res["mode"] == "hostavg"
    assert len(set(res["digests"])) == 1  # hosts agree bit for bit
    assert res["iterations"] == [2, 2]
    assert res["tally"]["clean"] == 1 and res["tally"]["host_death"] == 0
    assert res["tally"]["rollback_rounds"] == 0
    assert res["step_recompiles"] == [0, 0]
    assert res["serving_probe_diff"] is not None and res["serving_probe_diff"] <= 1e-6
    assert len(got) == 2  # one handoff a round snapshot
    assert res["tally"]["serve_updates_error"] == 1 and res["tally"]["serve_updates_ok"] == 1
    for counters in res["worker_counters"].values():
        assert counters["distributed_init_total"].get("outcome=ok", 0) >= 1
    reg = telemetry.get_registry()
    assert reg.get("hostfleet_generations_total").value(reason="clean") == 1
    assert reg.get("distributed_hosts_alive").value() == 0
    assert os.path.exists(res["bundle"])


def test_gspmd_two_host_run_agrees_over_gloo(tmp_path):
    """exchange="gspmd" across two processes: one ParallelTrainer over a
    gloo group of both hosts (the group a shared card takes), the hosts'
    digests equal."""
    from deeplearning4j_tpu_torch.fleet.supervisor import default_worker_env
    sup = TrainingFleetSupervisor(2, workdir=str(tmp_path / "job"), total_rounds=2,
                                  round_timeout_s=60, exchange="gspmd", device="cpu",
                                  env=dict(default_worker_env(), OMP_NUM_THREADS="1"))
    sup.start()
    try:
        res = sup.wait(timeout=180)
    finally:
        sup.stop()
    assert res["mode"] == "gspmd" and res["final_world"] == 2
    assert len(set(res["digests"])) == 1 and res["iterations"] == [2, 2]


# ----------------------------------------------------------------------
# /health carries the fleet gauge
# ----------------------------------------------------------------------

def test_health_payload_carries_hosts_alive():
    from deeplearning4j_tpu_torch.ui.server import _health_payload
    payload = _health_payload()
    assert payload["distributed"]["hosts_alive"] in (None, 0.0)
    telemetry.enable()
    g = telemetry.get_registry().gauge("distributed_hosts_alive", "test")
    g.set(3)
    assert _health_payload()["distributed"] == {"hosts_alive": 3.0}
