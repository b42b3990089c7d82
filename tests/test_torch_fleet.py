"""The port's fleet tier (``deeplearning4j_tpu_torch/fleet/``), in-process
half, after ``tests/test_fleet.py``: the worker wire protocol over the
port's ServingEngine (its answers held against the engine's own and the
JAX net's), router semantics against scriptable stub workers
(least-outstanding dispatch, bounded windows, queue-full and deadline
sheds, idempotent retry on a dead worker, counted no-worker sheds, prompt
stop), supervisor lifecycle over ``tests/torch_fake_fleet_worker.py``
(which imports neither torch nor jax: spawn, probe, SIGKILL, elastic
respawn, hot-swap fan-out, crash-loop backoff), ``fleet_status`` and the
prober. Every count, order and failover outcome the JAX test pins is
pinned the same here. The subprocess tests with real port workers are in
``tests/test_torch_fleet_process.py``."""

import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest

import procutil
from deeplearning4j_tpu_torch import fleet as fleet_pkg
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.fleet import (FleetProber, FleetRouter, FleetSupervisor,
                                            FleetWorker)
from deeplearning4j_tpu_torch.nn import layers as L, updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (ServingEngine, ServingOverloaded,
                                              ServingShutdown)

FAKE_WORKER = os.path.join(procutil.HERE, "torch_fake_fleet_worker.py")


@pytest.fixture(autouse=True)
def _isolate():
    telemetry.reset()
    telemetry.disable()
    fleet_pkg.reset()
    yield
    fleet_pkg.reset()
    telemetry.reset()
    telemetry.disable()


@pytest.fixture
def fresh(_isolate):
    telemetry.enable()
    yield telemetry.get_registry()


def _jax_mlp(n_in=5, n_out=3, hidden=8, seed=4):
    from deeplearning4j_tpu.nn import layers as JL, updaters as JU
    from deeplearning4j_tpu.nn.conf import inputs as JI
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    net = JNet(JConf(seed=seed, updater=JU.Sgd(learning_rate=0.1)).list(
        JL.DenseLayer(n_out=hidden, activation="tanh"),
        JL.OutputLayer(n_out=n_out, loss="mcxent"),
        input_type=JI.FeedForwardType(n_in)))
    net.init()
    return net


def _mlp(n_in=5, n_out=3, hidden=8, seed=4, jnet=None):
    """The port's MLP; with ``jnet``, carrying that JAX net's parameters."""
    from deeplearning4j_tpu_torch.utils.serialization import params_from_numpy
    net = MultiLayerNetwork(
        NeuralNetConfig(seed=seed, updater=U.Sgd(learning_rate=0.1)).list(
            L.DenseLayer(n_out=hidden, activation="tanh"),
            L.OutputLayer(n_out=n_out, loss="mcxent"),
            input_type=I.FeedForwardType(n_in)), device="cpu")
    net.init()
    if jnet is not None:
        params_from_numpy(net, jax.tree_util.tree_map(np.asarray, jnet.params))
    return net


def _x(n, n_in=5, seed=0):
    return np.random.RandomState(seed).rand(n, n_in).astype(np.float32)


def _get_json(url, payload=None, timeout=10):
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


# ---------------------------------------------------------------------------
# Stub worker: a scriptable wire-protocol endpoint for router tests
# (behavior flips at runtime: ok / sleep / shed / dead)
# ---------------------------------------------------------------------------

class _StubWorker:
    def __init__(self, scale=2.0):
        self.scale = scale
        self.sleep_s = 0.0
        self.mode = "ok"        # ok | shed_queue_full | shed_deadline
        self.submits = 0
        self.rows_seen = 0
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            daemon_threads = True

            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._json({"ok": True, "stub": True})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(length) or b"{}")
                rows = doc.get("rows", [])
                with stub._lock:
                    stub.submits += 1
                    stub.rows_seen += len(rows)
                if stub.sleep_s:
                    time.sleep(stub.sleep_s)
                if stub.mode == "shed_queue_full":
                    self._json({"error": "shed", "reason": "queue_full"},
                               code=429)
                    return
                if stub.mode == "shed_deadline":
                    self._json({"error": "shed", "reason": "deadline"},
                               code=429)
                    return
                self._json({"outputs": [[stub.scale * v for v in row]
                                        for row in rows]})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self.address = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def kill(self):
        """Die like a SIGKILLed process: socket closed, connections
        refused."""
        self._httpd.shutdown()
        self._httpd.server_close()

    def stop(self):
        self.kill()


@pytest.fixture
def stubs():
    made = []

    def make(**kw):
        s = _StubWorker(**kw)
        made.append(s)
        return s
    yield make
    for s in made:
        s.stop()


@pytest.fixture
def router_factory():
    routers = []

    def make(endpoints, **kw):
        kw.setdefault("name", "fleet-test")
        r = FleetRouter(endpoints, **kw)
        routers.append(r)
        return r
    yield make
    for r in routers:
        r.stop()


# ---------------------------------------------------------------------------
# FleetWorker wire protocol (real engine, in-process HTTP)
# ---------------------------------------------------------------------------

class TestFleetWorker:
    @pytest.fixture
    def worker(self):
        jnet = _jax_mlp()
        engine = ServingEngine(_mlp(jnet=jnet), name="wire", input_spec=(5,),
                               buckets=[1, 4], batch_window_s=0.0, device="cpu")
        w = FleetWorker(engine, worker_id="wtest", port=0).start()
        w.jnet = jnet
        yield w
        w.stop()

    def test_port_zero_binds_ephemeral(self, worker):
        assert worker.port != 0
        assert worker.address.endswith(str(worker.port))

    def test_health_and_stats(self, worker):
        code, doc = _get_json(worker.address + "/health")
        assert code == 200 and doc["ok"] and doc["worker_id"] == "wtest"
        # the engine export hook rides the payload: stats + counters, and
        # the port's kernel launches and nvcc builds
        assert doc["stats"]["buckets"] == [1, 4]
        assert "compile_cache_events" in doc and "recompiles" in doc
        assert set(doc["kernel_launches"]) == {"lstm_seq", "flash_attn", "conv_mm_stats",
                                               "conv3x3_stats"}
        assert doc["kernel_builds"] == {}
        code, st = _get_json(worker.address + "/stats")
        assert code == 200 and st["buckets"] == [1, 4]
        ready = worker.describe()
        assert ready["fleet_worker_ready"] and ready["port"] == worker.port
        assert ready["aot"]["warmed"] == 2 and ready["kernel_builds"] == {}

    def test_submit_parity_single_and_batch(self, worker):
        x = _x(4)
        ref = np.asarray(worker.engine.output(x))
        code, doc = _get_json(worker.address + "/submit",
                              {"rows": x.tolist()})
        assert code == 200
        got = np.asarray(doc["outputs"], dtype=np.float32)
        # float32 -> JSON -> float32 is exact: the wire costs nothing
        np.testing.assert_allclose(got, ref, rtol=0, atol=0)
        # and the answers are the JAX net's at f32 tolerance
        np.testing.assert_allclose(got, np.asarray(worker.jnet.output(x)), atol=1e-6)

    def test_submit_deadline_shed_is_429(self, worker):
        # a microscopic deadline is stale by the time the engine drains
        code, doc = _get_json(worker.address + "/submit",
                              {"rows": _x(1).tolist(),
                               "deadline_ms": 1e-4})
        assert code == 429
        assert doc["error"] == "shed" and doc["reason"] == "deadline"

    def test_submit_bad_body_is_400_and_unknown_404(self, worker):
        code, doc = _get_json(worker.address + "/submit", {"rows": []})
        assert code == 400
        code, _doc = _get_json(worker.address + "/nope")
        assert code == 404

    def test_shutdown_stops_engine(self):
        engine = ServingEngine(_mlp(), name="shut", input_spec=(5,),
                               buckets=[1], device="cpu")
        w = FleetWorker(engine, worker_id="wshut").start()
        code, doc = _get_json(w.address + "/shutdown", {})
        assert code == 200 and doc["ok"]
        deadline = time.time() + 5
        while engine.running and time.time() < deadline:
            time.sleep(0.02)
        assert not engine.running
        with pytest.raises(ServingShutdown):
            engine.submit(_x(1)[0])

    def test_swap_serves_new_model(self, worker, tmp_path):
        from deeplearning4j_tpu_torch.utils.serialization import save_model
        other = _mlp(seed=99)
        path = str(tmp_path / "other.zip")
        save_model(other, path)
        x = _x(3)
        before = np.asarray(worker.engine.output(x))
        code, doc = _get_json(worker.address + "/swap",
                              {"model_path": path}, timeout=60)
        assert code == 200 and doc["ok"] and doc["swaps"] == 1
        assert doc["kernel_builds"] == {}
        after = np.asarray(worker.engine.output(x))
        assert np.abs(after - before).max() > 1e-6  # new params serve
        np.testing.assert_array_equal(after, other.output(x).detach().numpy())
        code, doc = _get_json(worker.address + "/swap",
                              {"model_path": str(tmp_path / "nope.zip")})
        assert code in (400, 500)  # missing artifact is an error answer


# ---------------------------------------------------------------------------
# FleetRouter semantics over stub workers
# ---------------------------------------------------------------------------

class TestFleetRouter:
    def test_round_trip_and_batched(self, stubs, router_factory):
        s = stubs(scale=3.0)
        router = router_factory([("w0", s.address)])
        x = _x(2)
        y = router.submit(x[0]).get(timeout=10)
        np.testing.assert_allclose(np.asarray(y), 3.0 * x[0], rtol=1e-6)
        yb = router.submit(x, batched=True).get(timeout=10)
        assert np.asarray(yb).shape == x.shape
        np.testing.assert_allclose(np.asarray(yb), 3.0 * x, rtol=1e-6)
        counts = router.stats()["requests"]
        # accounting is in REQUESTS (so batched submits balance the
        # submitted == served + shed ledger); rows ride separately
        assert counts["served"] == 2 and counts["submitted"] == 2
        assert counts["served_rows"] == 3

    def test_batched_validation(self, stubs, router_factory):
        router = router_factory([("w0", stubs().address)], max_queue=8)
        with pytest.raises(ValueError):
            router.submit(np.zeros((0, 5), np.float32), batched=True)
        with pytest.raises(ValueError):
            router.submit(_x(9), batched=True)  # > max_queue: sizing error

    def test_least_outstanding_spreads_load(self, stubs, router_factory):
        slow, fast = stubs(), stubs()
        slow.sleep_s = 0.25
        router = router_factory([("slow", slow.address),
                                 ("fast", fast.address)],
                                max_dispatch_rows=1, concurrency=4)
        x = _x(1)[0]
        futs = [router.submit(x) for _ in range(8)]
        for f in futs:
            f.get(timeout=15)
        # while `slow` holds a dispatch outstanding, least-outstanding
        # must route new work to `fast` — both see traffic, fast more
        assert slow.submits >= 1
        assert fast.submits >= slow.submits

    def test_queue_full_counted_shed(self, stubs, router_factory, fresh):
        s = stubs()
        s.sleep_s = 0.3
        router = router_factory([("w0", s.address)], max_queue=2,
                                max_inflight_rows=1, concurrency=1)
        futs, shed = [], 0
        for i in range(12):
            try:
                futs.append(router.submit(_x(1)[0]))
            except ServingOverloaded:
                shed += 1
        assert shed > 0
        for f in futs:
            f.get(timeout=20)
        counts = router.stats()["requests"]
        assert counts["shed_queue_full"] == shed
        assert counts["served"] == len(futs)
        # accounting closes: nothing silently dropped
        assert counts["submitted"] == counts["served"] + shed
        series = fresh.snapshot()["serving_shed_total"]["series"]
        assert any(row["labels"].get("reason") == "queue_full"
                   and row["value"] >= shed for row in series)

    def test_deadline_shed_front(self, stubs, router_factory):
        s = stubs()
        s.sleep_s = 0.2
        router = router_factory([("w0", s.address)], max_inflight_rows=1,
                                concurrency=1)
        # first request occupies the worker; the second's deadline burns
        # out while it waits for the in-flight window
        f1 = router.submit(_x(1)[0])
        f2 = router.submit(_x(1)[0], deadline_s=0.05)
        f1.get(timeout=10)
        with pytest.raises(ServingOverloaded):
            f2.get(timeout=10)
        assert router.stats()["requests"]["shed_deadline"] == 1

    def test_retry_on_dead_worker_is_idempotent(self, stubs,
                                                router_factory, fresh):
        dead, live = stubs(scale=2.0), stubs(scale=2.0)
        dead.kill()  # refused connections, like a SIGKILLed process
        router = router_factory([("w0", dead.address),
                                 ("w1", live.address)])
        x = _x(4)
        futs = [router.submit(x[i]) for i in range(4)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(np.asarray(f.get(timeout=15)),
                                       2.0 * x[i], rtol=1e-6)
        s = router.stats()
        assert s["requests"]["served"] == 4
        assert s["requests"]["failovers"] == 1
        assert s["requests"]["retries"] >= 1
        by_id = {w["worker_id"]: w for w in s["workers"]}
        assert by_id["w0"]["alive"] is False
        assert by_id["w1"]["alive"] is True
        snap = fresh.snapshot()
        assert any(row["value"] >= 1
                   for row in snap["fleet_failover_total"]["series"])

    def test_worker_shed_retries_then_counts(self, stubs, router_factory):
        shedding, ok = stubs(), stubs(scale=2.0)
        shedding.mode = "shed_queue_full"
        router = router_factory([("w0", shedding.address),
                                 ("w1", ok.address)])
        x = _x(1)[0]
        y = router.submit(x).get(timeout=10)   # retried onto w1
        np.testing.assert_allclose(np.asarray(y), 2.0 * x, rtol=1e-6)
        ok.mode = "shed_queue_full"            # now EVERY worker sheds
        with pytest.raises(ServingOverloaded):
            router.submit(x).get(timeout=10)
        counts = router.stats()["requests"]
        assert counts["shed_worker"] + counts["shed_no_worker"] >= 1

    def test_all_dead_counted_shed_never_hangs(self, stubs,
                                               router_factory):
        s = stubs()
        s.kill()
        router = router_factory([("w0", s.address)],
                                no_worker_grace_s=0.5)
        with pytest.raises(ServingOverloaded):
            router.submit(_x(1)[0]).get(timeout=10)
        counts = router.stats()["requests"]
        assert counts["shed_no_worker"] + counts["shed_worker"] == 1

    def test_stop_fails_pending_promptly(self, stubs, router_factory):
        s = stubs()
        s.sleep_s = 0.5
        router = router_factory([("w0", s.address)], max_inflight_rows=1,
                                concurrency=1)
        futs = [router.submit(_x(1)[0]) for _ in range(4)]
        router.stop()
        t0 = time.perf_counter()
        outcomes = []
        for f in futs:
            try:
                f.get(timeout=10)
                outcomes.append("served")
            except (ServingShutdown, ServingOverloaded):
                outcomes.append("failed")
        assert time.perf_counter() - t0 < 5
        assert "failed" in outcomes  # stragglers failed, not hung
        with pytest.raises(ServingShutdown):
            router.submit(_x(1)[0])

    def test_set_endpoints_keeps_state_and_revives(self, stubs,
                                                   router_factory):
        a, b = stubs(), stubs()
        router = router_factory([("w0", a.address)])
        router.submit(_x(1)[0]).get(timeout=10)
        router.mark_dead("w0", error="probe said so")
        # same wid, fresh address (a respawn): arrives alive again
        router.set_endpoints([("w0", b.address), ("w1", a.address)])
        by_id = {w["worker_id"]: w for w in router.stats()["workers"]}
        assert by_id["w0"]["alive"] is True
        assert by_id["w0"]["address"] == b.address
        # unchanged endpoint keeps its dispatch history
        assert by_id["w1"]["dispatched"] == 0
        y = router.submit(_x(1)[0]).get(timeout=10)
        assert np.asarray(y).shape == (5,)

    def test_health_aggregation(self, stubs, router_factory):
        a, b = stubs(), stubs()
        b.kill()
        router = router_factory([("w0", a.address), ("w1", b.address)])
        h = router.health()
        assert h["total"] == 2 and h["alive"] == 1
        assert h["workers"]["w0"]["ok"] is True
        assert h["workers"]["w1"]["ok"] is False
        # the probe failure marked it dead for routing too
        by_id = {w["worker_id"]: w for w in router.stats()["workers"]}
        assert by_id["w1"]["alive"] is False

    def test_false_positive_mark_dead_is_revived(self, stubs,
                                                 router_factory):
        # a transient stall must not shrink the pool forever: a healthy
        # /health answer (router probe or supervisor loop) revives it
        s = stubs()
        router = router_factory([("w0", s.address)])
        router.mark_dead("w0", error="transient timeout")
        by_id = {w["worker_id"]: w for w in router.stats()["workers"]}
        assert by_id["w0"]["alive"] is False
        h = router.health()
        assert h["alive"] == 1
        by_id = {w["worker_id"]: w for w in router.stats()["workers"]}
        assert by_id["w0"]["alive"] is True
        y = router.submit(_x(1)[0]).get(timeout=10)
        assert np.asarray(y).shape == (5,)


# ---------------------------------------------------------------------------
# FleetSupervisor over the jax-free fake worker (lifecycle mechanics)
# ---------------------------------------------------------------------------

def _fake_supervisor(n, **kw):
    def cmd(wid):
        return [sys.executable, FAKE_WORKER, "--worker-id", wid]
    kw.setdefault("probe_interval_s", 0.1)
    kw.setdefault("probe_timeout_s", 1.0)
    kw.setdefault("max_missed_probes", 2)
    kw.setdefault("spawn_timeout_s", 30.0)
    return FleetSupervisor(n, worker_command=kw.pop("worker_command", cmd),
                           env=procutil.scrubbed_env(), **kw)


class TestFleetSupervisor:
    def test_spawn_probe_status_stop(self):
        sup = _fake_supervisor(2)
        try:
            sup.start()
            addrs = sup.addresses()
            assert len(addrs) == 2
            assert len({a for _w, a in addrs}) == 2  # port=0: no collision
            time.sleep(0.4)  # a few probe ticks
            st = sup.status()
            assert all(w["alive"] for w in st["workers"])
            assert all(w["last_health"]["ok"] for w in st["workers"])
            assert st["respawns"] == []
        finally:
            sup.stop()
        assert all(w.proc.poll() is not None
                   for w in sup._workers.values())

    def test_sigkill_respawns_and_repushes_endpoints(self):
        sup = _fake_supervisor(2)
        router = FleetRouter(name="fake")
        sup.attach(router)
        try:
            sup.start()
            old = dict(sup.addresses())
            sup.kill_worker("w0", sig=signal.SIGKILL)
            deadline = time.time() + 20
            while time.time() < deadline:
                evs = sup.status()["respawns"]
                if evs and evs[-1].get("spawn_s") is not None:
                    break
                time.sleep(0.1)
            evs = sup.status()["respawns"]
            assert evs and evs[0]["worker_id"] == "w0"
            assert evs[0]["generation"] == 1
            assert evs[0]["warm"] is True  # fake ready line says warm
            fresh_addrs = dict(sup.addresses())
            assert fresh_addrs["w0"] != old["w0"]   # new port
            assert fresh_addrs["w1"] == old["w1"]   # survivor untouched
            # the router received the replacement endpoint
            by_id = {w["worker_id"]: w
                     for w in router.stats()["workers"]}
            assert by_id["w0"]["address"] == fresh_addrs["w0"]
            assert by_id["w0"]["alive"] is True
        finally:
            router.stop()
            sup.stop()

    def test_probe_loop_revives_router_false_positive(self):
        sup = _fake_supervisor(1)
        router = FleetRouter(name="fake-revive")
        sup.attach(router)
        try:
            sup.start()
            router.mark_dead("w0", error="router-side timeout")
            deadline = time.time() + 10
            while time.time() < deadline:
                by_id = {w["worker_id"]: w
                         for w in router.stats()["workers"]}
                if by_id["w0"]["alive"]:
                    break
                time.sleep(0.05)
            assert by_id["w0"]["alive"] is True  # probe loop revived it
            assert sup.status()["respawns"] == []  # no pointless respawn
        finally:
            router.stop()
            sup.stop()

    def test_update_model_fans_out(self):
        sup = _fake_supervisor(2)
        try:
            sup.start()
            out = sup.update_model("/tmp/new_model.zip")
            assert set(out) == {"w0", "w1"}
            assert all(doc["ok"] and doc["swaps"] == 1
                       for doc in out.values())
        finally:
            sup.stop()

    def test_respawn_backoff_on_crash_loop(self, fresh):
        """A worker that dies instantly on every
        respawn must NOT spin the supervisor hot — attempts space out
        under the capped exponential backoff, each deferral counted."""
        sup = _fake_supervisor(1, probe_interval_s=0.05,
                               respawn_backoff_base_s=0.2,
                               respawn_backoff_cap_s=1.0,
                               crashloop_window_s=10.0)
        try:
            sup.start()
            # every replacement from now on exits before its ready line
            sup._worker_command = lambda wid: [
                sys.executable, "-c", "raise SystemExit(1)"]
            sup.kill_worker("w0", sig=signal.SIGKILL)
            time.sleep(2.5)
            st = sup.status()
            bo = st["backoff"]["w0"]
            assert bo["level"] >= 2  # the loop kept escalating
            # without backoff the 0.05s probe tick would attempt ~50
            # respawns in 2.5s; the 0.2/0.4/0.8/1.0... schedule allows
            # only a handful (each also pays ~0.2s of await_ready)
            assert 1 <= len(st["respawns"]) <= 8
            # every crash-loop attempt recorded its failure, never silent
            assert all(e.get("error") for e in st["respawns"])
            c = fresh.get("fleet_respawn_backoff_total")
            assert c is not None and c.value(worker="w0") >= 2
        finally:
            sup.stop()

    def test_long_lived_death_respawns_immediately(self, fresh):
        """The backoff is for crash LOOPS: a worker that lived past the
        window respawns on the next tick with level reset to zero."""
        sup = _fake_supervisor(1, probe_interval_s=0.05,
                               respawn_backoff_base_s=5.0,
                               crashloop_window_s=0.0)
        try:
            sup.start()
            sup.kill_worker("w0", sig=signal.SIGKILL)
            deadline = time.time() + 20
            while time.time() < deadline:
                evs = sup.status()["respawns"]
                if evs and evs[-1].get("spawn_s") is not None:
                    break
                time.sleep(0.05)
            st = sup.status()
            assert st["respawns"] and \
                st["respawns"][-1]["spawn_s"] is not None
            assert st["backoff"]["w0"]["level"] == 0
            c = fresh.get("fleet_respawn_backoff_total")
            assert c is None or c.value(worker="w0") == 0
        finally:
            sup.stop()



# ---------------------------------------------------------------------------
# fleet_status, the federation hooks and the prober
# ---------------------------------------------------------------------------

class TestFleetStatus:
    def test_fleet_status_inactive_then_active(self, stubs):
        assert fleet_pkg.fleet_status()["active"] is False
        s = stubs()
        router = FleetRouter([("w0", s.address)], name="epfleet")
        try:
            router.submit(_x(1)[0]).get(timeout=10)
            fleet_pkg.set_default_front(router=router)
            doc = fleet_pkg.fleet_status()
            assert doc["active"] is True
            assert doc["router"]["requests"]["served"] == 1
            assert doc["router"]["name"] == "epfleet"
            # probe=True: live cross-worker /health aggregation
            assert fleet_pkg.fleet_status(probe=True)["health"]["alive"] == 1
        finally:
            router.stop()

    def test_default_front_feeds_federation_and_the_timeline(self, stubs):
        from deeplearning4j_tpu_torch.telemetry import federate, timeline
        s = stubs()
        router = FleetRouter([("w0", s.address)], name="fedfleet")
        try:
            fleet_pkg.set_default_front(router=router)
            assert ("w0", s.address + "/metrics") in federate.default_targets(
                include_local=False)
            assert fleet_pkg.get_default_front() == (router, None)
            fleet_pkg.reset()
            assert fleet_pkg.get_default_front() == (None, None)
            assert federate.default_targets(include_local=False) == []
            assert timeline.cluster_snapshot(include_local=False) is not None
        finally:
            router.stop()

    def test_prober_verdicts_and_isolation(self, stubs, router_factory, fresh):
        """Canaries through the router: ok while the answer holds, a
        counted wrong_answer when it does not, unreachable once the pool is
        dead, never a hang; probe traffic lands in origin=probe series
        only."""
        s = stubs(scale=2.0)
        router = router_factory([("w0", s.address)], no_worker_grace_s=0.3)
        x = _x(1)[0]
        prober = FleetProber(router, [{"x": x, "expect": 2.0 * x, "name": "c0"}],
                             timeout_s=5.0, tol=1e-6)
        assert [r["verdict"] for r in prober.probe_once()] == ["ok"]
        s.scale = 3.0
        assert [r["verdict"] for r in prober.probe_once()] == ["wrong_answer"]
        s.kill()
        assert [r["verdict"] for r in prober.probe_once()] == ["unreachable"]
        total = telemetry.series_map("probe_total")
        assert total["model=fleet-test|verdict=ok"] == 1
        assert total["model=fleet-test|verdict=wrong_answer"] == 1
        assert total["model=fleet-test|verdict=unreachable"] == 1
        assert telemetry.series_map("probe_bad_total") == {"model=fleet-test": 2}
        requests = telemetry.series_map("fleet_requests_total")
        assert requests["origin=probe|outcome=submitted"] == 3
        assert requests["outcome=submitted"] == 0  # organic series untouched
        assert prober.status()["rounds"] == 3 and prober.status()["ok"] is False
