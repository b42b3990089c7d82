"""The port's fleet with real worker processes, after
``tests/test_fleet_process.py``: port workers
(``python -m deeplearning4j_tpu_torch.fleet.worker --device cpu``, which
import neither JAX nor its package) serve a tiny char-RNN
(``text_generation_lstm(11, hidden=32, seq_len=8)``) from a zip the JAX
package's ``save_model`` wrote, and their answers equal the JAX net's
``output`` at the f32 tolerance of ``tests/test_torch_rnn.py`` (atol 1e-5).

One two-worker fleet, warm-started from the engine's warm manifest with
telemetry on, is shared by the tests in file order: cross-process trace
parenting, then a SIGKILL mid-sweep (no request lost, the replacement
warm: every grid entry from the manifest, no nvcc build), then a failover
replayed on the same trace. The ready line is read through
``tests/procutil.py`` from a worker of its own."""

import json
import signal
import sys
import time
import urllib.request

import numpy as np
import pytest

import procutil
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.fleet import FleetRouter, FleetSupervisor
from deeplearning4j_tpu_torch.serving import ServingEngine, ServingOverloaded

VOCAB, HIDDEN, SEQ = 11, 32, 8
ATOL = 1e-5


def _jax_charnn_zip(path):
    from deeplearning4j_tpu.models.misc import text_generation_lstm
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.utils.serialization import save_model
    jnet = MultiLayerNetwork(text_generation_lstm(VOCAB, hidden=HIDDEN, seq_len=SEQ))
    jnet.init()
    save_model(jnet, path)
    return jnet


def _examples(n, seed=0):
    ids = np.random.RandomState(seed).randint(0, VOCAB, size=(n, SEQ))
    return np.eye(VOCAB, dtype=np.float32)[ids]


def _ring_doc(trace_id):
    for docs in telemetry.tracectx.get_ring().snapshot().values():
        for doc in docs:
            if doc.get("trace_id") == trace_id:
                return doc
    raise AssertionError(f"trace {trace_id} not in the local ring")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint
    tmp = tmp_path_factory.mktemp("fleet")
    ckpt = str(tmp / "charnn.zip")
    jnet = _jax_charnn_zip(ckpt)
    x = _examples(8)
    ref = np.asarray(jnet.output(x))
    engine = ServingEngine(restore_checkpoint(ckpt, device="cpu"), input_spec=(SEQ, VOCAB),
                           buckets=[1, 4], device="cpu")
    wm = engine.save_warm_manifest(str(tmp / "wm.zip"))
    engine.stop()
    telemetry.reset()
    telemetry.enable()
    sup = FleetSupervisor(2, model_path=ckpt, buckets=[1, 4], warm_manifest=wm, device="cpu",
                          env=procutil.scrubbed_env(DL4J_TPU_TELEMETRY="1"),
                          probe_interval_s=0.25, max_missed_probes=2)
    router = FleetRouter(name="default", request_timeout_s=30.0)
    sup.attach(router)
    try:
        sup.start()
        yield sup, router, x, ref
    finally:
        router.stop()
        sup.stop()
        telemetry.disable()
        telemetry.reset()


def test_cross_process_trace_parenting(fleet):
    """One trace spans admission, dispatch, the worker's queue and forward,
    and resolve: the router's ring doc holds the worker process's spans,
    grafted under the dispatching attempt with resolvable parent links."""
    sup, router, x, ref = fleet
    for w in sup._workers.values():  # both warm-started from the manifest
        assert FleetSupervisor.replacement_is_warm(w.ready_doc), w.ready_doc
        assert w.ready_doc["aot"]["manifest_hits"] == w.ready_doc["aot"]["warmed"] == 2
    fut = router.submit(x[0])
    np.testing.assert_allclose(np.asarray(fut.get(timeout=30)), ref[0], atol=ATOL)
    doc = _ring_doc(fut.trace_id)
    names = [s["name"] for s in doc["spans"]]
    for name in ("fleet.queue_wait", "fleet.attempt", "fleet.resolve",
                 "fleet.worker_submit", "serving.queue_wait", "serving.forward"):
        assert name in names, names
    wroot = next(s for s in doc["spans"] if s["name"] == "fleet.worker_submit")
    assert wroot["args"]["instance"] in ("w0", "w1"), wroot
    by_id = {s["span_id"]: s for s in doc["spans"]}
    assert all(s["parent_id"] in by_id for s in doc["spans"]
               if s.get("parent_id") is not None)
    s = next(s for s in doc["spans"] if s["name"] == "serving.forward")
    chain = []
    while s is not None:
        chain.append(s["name"])
        s = by_id.get(s.get("parent_id"))
    assert "fleet.attempt" in chain, chain


def test_chaos_sigkill_worker_midsweep(fleet):
    sup, router, x, ref = fleet
    ys = np.stack([np.asarray(router.submit(x[i]).get(timeout=30)) for i in range(8)])
    np.testing.assert_allclose(ys, ref, atol=ATOL, rtol=0)
    before = router.stats()["requests"]

    sup.kill_worker("w0", sig=signal.SIGKILL)
    futs = [router.submit(x[i % 8]) for i in range(24)]
    served, shed = 0, 0
    for i, f in enumerate(futs):
        try:
            np.testing.assert_allclose(np.asarray(f.get(timeout=30)), ref[i % 8], atol=ATOL,
                                       rtol=0)
            served += 1
        except ServingOverloaded:
            shed += 1  # counted, never silent
    assert served + shed == 24
    assert served >= 1  # the survivor kept answering
    counts = router.stats()["requests"]
    losses = (counts["submitted"] - counts["served"] - counts["shed_queue_full"]
              - counts["shed_deadline"] - counts["shed_no_worker"] - counts["shed_worker"]
              - counts["errors"])
    assert losses == 0, f"uncounted request losses: {counts}"
    assert counts["errors"] == before["errors"] == 0, counts

    deadline = time.time() + 60
    while time.time() < deadline:
        evs = sup.status()["respawns"]
        if evs and evs[-1].get("spawn_s") is not None:
            break
        time.sleep(0.2)
    evs = sup.status()["respawns"]
    assert evs, "supervisor never respawned the killed worker"
    ev = evs[-1]
    assert ev["worker_id"] == "w0" and ev["generation"] == 1
    assert ev["warm"] is True, ev  # every entry from the manifest, no nvcc build
    assert ev["aot"]["manifest_hits"] == ev["aot"]["warmed"] == 2
    assert ev["kernel_builds"] == {}

    ys2 = np.stack([np.asarray(router.submit(x[i]).get(timeout=30)) for i in range(8)])
    np.testing.assert_allclose(ys2, ref, atol=ATOL, rtol=0)
    h = router.health()
    assert h["alive"] == 2, h
    w0h = h["workers"]["w0"]
    assert w0h["compile_cache_events"].get("hit", 0) >= 2
    assert not w0h["compile_cache_events"].get("miss")
    assert not w0h["recompiles"], w0h["recompiles"]


def test_failover_replays_on_the_same_trace(fleet):
    """A failover is a second numbered attempt on the same trace: with the
    supervisor's probe loop parked, w0 is killed and a request submitted;
    attempt 1 errors against the dead process, a later one succeeds on
    w1, and one ring doc tells the whole story."""
    sup, router, x, ref = fleet
    telemetry.tracectx.get_ring().clear()  # the ring keeps the slowest traces
    sup.probe_interval_s = 60.0
    time.sleep(0.5)  # the loop's current wait ends; the next is the long one
    sup.kill_worker("w0", sig=signal.SIGKILL)
    time.sleep(0.2)  # let the SIGKILL land before the dispatch
    fut = router.submit(x[1])
    np.testing.assert_allclose(np.asarray(fut.get(timeout=30)), ref[1], atol=ATOL)
    doc = _ring_doc(fut.trace_id)
    attempts = {s["args"]["attempt"]: s["args"]
                for s in doc["spans"] if s["name"] == "fleet.attempt"}
    assert len(attempts) >= 2, attempts
    last = max(attempts)
    assert attempts[1]["outcome"] == "error", attempts
    assert attempts[last]["outcome"] == "ok", attempts
    assert attempts[1]["worker"] != attempts[last]["worker"]
    assert "serving.forward" in [s["name"] for s in doc["spans"]]


def test_worker_ready_line_via_procutil(tmp_path):
    """The bare worker wire contract, driven through procutil's spawn."""
    ckpt = str(tmp_path / "charnn.zip")
    jnet = _jax_charnn_zip(ckpt)
    proc = procutil.spawn(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.fleet.worker", "--model-path", ckpt,
         "--buckets", "1", "--worker-id", "wx", "--port", "0", "--device", "cpu"])
    try:
        doc = procutil.last_json_line(proc.stdout.readline())
        assert doc["fleet_worker_ready"] and doc["worker_id"] == "wx"
        assert doc["port"] > 0 and doc["device"] == "cpu"
        assert doc["kernel_builds"] == {}
        clk = procutil.ready_clock(doc)
        assert clk is not None and clk["unix"] > 0 and "mono" in clk
        addr = f"http://127.0.0.1:{doc['port']}"
        with urllib.request.urlopen(addr + "/health", timeout=10) as r:
            health = json.loads(r.read().decode())
        assert health["ok"] and health["port"] == doc["port"]
        x = _examples(2, seed=3)
        req = urllib.request.Request(addr + "/submit", data=json.dumps(
            {"rows": x.tolist()}).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = np.asarray(json.loads(r.read().decode())["outputs"], np.float32)
        np.testing.assert_allclose(out, np.asarray(jnet.output(x)), atol=ATOL)
    finally:
        proc.kill()
        proc.communicate(timeout=30)
