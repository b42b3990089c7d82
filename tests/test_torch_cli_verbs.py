"""The port's ``train``, ``ui``, ``serve --port``, ``fleet`` and reader
verbs (``deeplearning4j_tpu_torch/cli.py``) on the CPU, held against the
JAX package's ``cli.py``: training from the same JAX-written zip ends at
the same loss and saved parameters, and the reader verbs print what the
JAX verbs print over the same files. After ``tests/test_cli.py``."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import procutil
from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.serialization import save_model as jsave
from deeplearning4j_tpu_torch import cli as tcli
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.telemetry import flight as TF
from deeplearning4j_tpu_torch.telemetry import history as TH
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _isolate():
    """The serving verbs switch the port's telemetry on in this process."""
    telemetry.reset()
    telemetry.disable()
    yield
    telemetry.reset()
    telemetry.disable()


def _stage(tmp_path, n=96):
    """x.npy, y.npy and a JAX-written model zip of a tiny MLP."""
    rs = np.random.RandomState(0)
    x = rs.randn(n, 6).astype(np.float32)
    y = np.eye(3)[rs.randint(0, 3, n)].astype(np.float32)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, x)
    np.save(yp, y)
    net = JNet(JConf(seed=1, updater=JU.Adam(learning_rate=0.01)).list(
        JL.DenseLayer(n_out=8, activation="tanh"),
        JL.OutputLayer(n_out=3, loss="mcxent"),
        input_type=JI.FeedForwardType(6)))
    net.init()
    mp = str(tmp_path / "model.zip")
    jsave(net, mp)
    return xp, yp, mp, x, y


def _final_loss(out):
    return float(next(ln for ln in out.splitlines()
                      if ln.startswith("final loss:")).split(":")[1])


def _assert_same_params(a_path, b_path):
    a = tser.load_model(a_path, device="cpu")
    b = tser.load_model(b_path, device="cpu")
    for what in ("params", "opt_state"):
        la, lb = list(tree_leaves(getattr(a, what))), list(tree_leaves(getattr(b, what)))
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            np.testing.assert_allclose(torch.as_tensor(x).double().numpy(),
                                       torch.as_tensor(y).double().numpy(),
                                       rtol=1e-5, atol=1e-5)


def _both_train(tmp_path, capsys, extra_j, extra_t, data_args):
    outs = {}
    for name, main, extra in (("jax", jcli.main, extra_j), ("torch", tcli.main, extra_t)):
        out = str(tmp_path / f"{name}.zip")
        assert main(["train", *data_args, "--model-output-path", out,
                     "--report-score", *extra]) == 0
        outs[name] = (_final_loss(capsys.readouterr().out), out)
    assert outs["torch"][0] == pytest.approx(outs["jax"][0], rel=LOSS_RTOL)
    _assert_same_params(outs["torch"][1], outs["jax"][1])
    return outs


def test_train_resume_and_save_like_jax(tmp_path, capsys):
    xp, yp, mp, _, _ = _stage(tmp_path)
    args = ["--model-path", mp, "--data", xp, "--labels", yp, "--epochs", "2",
            "--batch-size-per-worker", "8", "--workers", "1"]
    outs = _both_train(tmp_path, capsys, [], ["--device", "cpu"], args)
    resumed = tser.load_model(outs["torch"][1], device="cpu")
    assert resumed.opt_state is not None and resumed.iteration == 24


def test_train_parameter_averaging_mode_like_jax(tmp_path, capsys, eight_devices,
                                                monkeypatch):
    """Four workers, local SGD averaged every 3 steps: the JAX package's
    four devices against four spawned gloo ranks (one intra-op thread
    each: they share the machine with the other test workers)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    xp, yp, mp, _, _ = _stage(tmp_path)
    args = ["--model-path", mp, "--data", xp, "--labels", yp, "--epochs", "1",
            "--batch-size-per-worker", "4", "--averaging-frequency", "3", "--workers", "4"]
    _both_train(tmp_path, capsys, [], ["--device", "cpu"], args)


def test_train_then_eval_on_a_labelled_csv(tmp_path, capsys):
    _, _, mp, x, y = _stage(tmp_path)
    csv = tmp_path / "data.csv"
    np.savetxt(csv, np.concatenate([x, y.argmax(-1)[:, None]], 1), delimiter=",", fmt="%.7g")
    args = ["--model-path", mp, "--data", str(csv), "--n-classes", "3", "--epochs", "3",
            "--batch-size-per-worker", "8", "--workers", "1"]
    outs = _both_train(tmp_path, capsys, [], ["--device", "cpu"], args)
    assert tcli.main(["eval", "--model-path", outs["torch"][1], "--data", str(csv),
                      "--n-classes", "3", "--device", "cpu"]) == 0
    assert "ccuracy" in capsys.readouterr().out


def test_train_with_the_dashboard_records_the_fit(tmp_path, capsys, monkeypatch):
    xp, yp, mp, _, _ = _stage(tmp_path)
    seen = []
    real = tcli._train_fit

    def spy(args, net, master, x, y):
        loss = real(args, net, master, x, y)
        from deeplearning4j_tpu_torch.ui import StatsListener
        st = next(l for l in net.listeners if isinstance(l, StatsListener)).storage
        seen.extend(st.get_records(type_="stats"))
        return loss

    monkeypatch.setattr(tcli, "_train_fit", spy)
    assert tcli.main(["train", "--model-path", mp, "--data", xp, "--labels", yp,
                      "--batch-size-per-worker", "16", "--workers", "1", "--ui-port", "0",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dashboard: http://127.0.0.1:" in out
    assert [r["iteration"] for r in seen] == list(range(1, 7))
    assert all(r["session"] == "cli" and r["params"] for r in seen)


def test_unknown_zoo_model_exits(tmp_path):
    xp = str(tmp_path / "x.npy")
    np.save(xp, np.zeros((4, 2), np.float32))
    with pytest.raises(SystemExit):
        tcli.main(["train", "--zoo", "not-a-model", "--data", xp, "--labels", xp,
                   "--device", "cpu"])


def test_train_asks_for_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp, yp, mp, _, _ = _stage(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["train", "--model-path", mp, "--data", xp, "--labels", yp])


# ----------------------------------------------------------------------
# the long-running verbs, as processes
# ----------------------------------------------------------------------

def _spawn(args, tmp_path):
    return subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=procutil.scrubbed_env(OMP_NUM_THREADS="1"))


def _url_line(proc, marker, timeout=120):
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if marker in line:
            return line.split("http://", 1)[1].split()[0]
    proc.kill()
    raise AssertionError("no %r line in:\n%s" % (marker, "".join(seen)))


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def test_ui_verb_answers(tmp_path):
    port = procutil.free_port()
    proc = _spawn(["ui", "--port", str(port)], tmp_path)
    try:
        addr = _url_line(proc, "UI server on")
        with urllib.request.urlopen(f"http://{addr}train/sessions", timeout=10) as r:
            assert json.loads(r.read()) == []
        with urllib.request.urlopen(f"http://{addr}health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_serve_port_answers_serving(tmp_path):
    _, _, mp, _, _ = _stage(tmp_path)
    proc = _spawn(["serve", "--model-path", mp, "--name", "mlp", "--port", "0",
                   "--max-batch", "4", "--batch-window-ms", "1", "--device", "cpu"], tmp_path)
    try:
        addr = _url_line(proc, "serving status:")
        with urllib.request.urlopen(f"http://{addr}", timeout=10) as r:
            status = json.loads(r.read())
        assert list(status["models"]) == ["mlp"]
        assert status["models"]["mlp"]["buckets"] == [1, 2, 4]
        metrics_url = f"http://{addr}".replace("/serving", "/metrics")
        with urllib.request.urlopen(metrics_url, timeout=10) as r:
            assert b"serving" in r.read()
    finally:
        _stop(proc)
    assert proc.returncode == 0


def test_fleet_parser_and_one_worker_smoke(tmp_path, capsys, monkeypatch):
    args = tcli._build_parser().parse_args(["fleet", "--model-path", "m.zip"])
    assert (args.workers, args.name, args.max_inflight, args.port, args.device) == \
        (2, "default", 64, None, "cuda")
    with pytest.raises(SystemExit):
        tcli._build_parser().parse_args(["fleet", "--model-path", "a", "--zoo", "b"])
    _, _, mp, x, _ = _stage(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the worker's intra-op threads
    rc = tcli.main(["fleet", "--model-path", mp, "--workers", "1", "--buckets", "1,4",
                    "--smoke", "12", "--port", "0", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{\n"):])
    assert doc["answered"] == 12
    assert doc["router"]["served"] == 12 if "served" in doc["router"] else True
    assert len(doc["workers"]["workers"]) == 1
    assert "fleet status: http://127.0.0.1:" in out


# ----------------------------------------------------------------------
# the reader verbs print what the JAX verbs print
# ----------------------------------------------------------------------

def _both(capsys, argv):
    """(JAX verb's stdout, port verb's stdout) on the same argv."""
    out = []
    for main in (jcli.main, tcli.main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.fixture
def flight_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    rec = TF.FlightRecorder(capacity=8)
    for i in range(6):
        rec.note(step=i, score=0.5 * i, t=float(i), step_time_s=0.01 * i)
    rec.annotate(5, grad_norm=2.0, loss_nonfinite=True)
    return rec.dump("numerics:nonfinite", extra={
        "anomaly": {"step": 5},
        "traces": {"serving.request": [_trace_doc("t1", 0.004), _trace_doc("t2", 0.009)]}})


def _trace_doc(tid, dur):
    return {"name": "serving.request", "trace_id": tid, "duration_s": dur, "status": "ok",
            "t0_unix": 1000.0, "spans": [
                {"name": "serving.request", "span_id": 1, "parent_id": None, "t0_s": 0.0,
                 "dur_s": dur, "thread": "MainThread", "args": {"model": "m"}},
                {"name": "queue_wait", "span_id": 2, "parent_id": 1, "t0_s": 0.001,
                 "dur_s": dur / 2, "thread": "drain"}]}


@pytest.mark.parametrize("argv", [["flightrec", "{dump}"], ["flightrec", "{dump}", "--last", "2"],
                                  ["flightrec", "{dump}", "--json"],
                                  ["traces", "--file", "{dump}"],
                                  ["traces", "--file", "{dump}", "--trace-id", "t2"],
                                  ["traces", "--file", "{dump}", "--json"],
                                  ["traces", "--cluster", "--file", "{dir}"]])
def test_reader_verbs_print_what_jax_prints(capsys, flight_dump, argv):
    argv = [a.format(dump=flight_dump, dir=os.path.dirname(flight_dump)) for a in argv]
    (jrc, jout), (trc, tout) = _both(capsys, argv)
    assert trc == jrc == 0
    assert tout == jout and tout.strip()


def test_traces_of_an_unknown_id_fail_like_jax(capsys, flight_dump):
    (jrc, jout), (trc, tout) = _both(capsys, ["traces", "--file", flight_dump,
                                              "--trace-id", "nope"])
    assert jrc == trc == 1 and jout == tout


def test_slo_replays_a_history_dir_like_jax(tmp_path, capsys):
    telemetry.reset()
    telemetry.enable()
    try:
        reg = telemetry.get_registry()
        c = reg.counter("serving_requests_total", "requests")
        store = TH.MetricsHistory(reg, history_dir=str(tmp_path / "hist"), segment_samples=2)
        for i in range(4):
            c.inc(10 * (i + 1), model="m", outcome="ok")
            store.sample_now(now=1000.0 + 10 * i)
        store.flush()
    finally:
        telemetry.reset()
        telemetry.disable()
    for extra in ([], ["--json"]):
        (jrc, jout), (trc, tout) = _both(capsys, ["slo", "--history", str(tmp_path / "hist"),
                                                  *extra])
        assert trc == jrc == 0
        assert tout == jout and tout.strip()


@pytest.fixture
def static_server(flight_dump):
    """A server answering fixed payloads: a /metrics scrape, an /slo
    verdict and a /traces ring, so both packages' readers read the same
    bytes."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    with open(flight_dump) as f:
        traces = {"traces": json.load(f)["traces"]}
    slo = {"rules": [
        {"name": "serving_error_ratio", "state": "ok", "value": 0.01, "op": "gt",
         "fire": 0.05, "kind": "ratio", "metric": "serving_requests_total"},
        {"name": "burn", "state": "firing", "value": {"short": 14.5, "long": 2.25},
         "op": "gt", "fire": 14.4, "kind": "burn_rate", "metric": "errors_total"},
        {"name": "goodput", "state": "warning", "value": None, "op": "lt", "fire": 0.5,
         "kind": "threshold", "metric": "goodput_fraction"}],
        "firing": ["burn"], "warning": ["goodput"], "evaluations": 3}
    bodies = {"/metrics": ("# TYPE a_total counter\na_total 3\n", "text/plain"),
              "/slo": (json.dumps(slo), "application/json"),
              "/traces": (json.dumps(traces), "application/json")}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body, ctype = bodies[self.path.split("?")[0]]
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body.encode())

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


@pytest.mark.parametrize("argv", [["telemetry", "--url", "{base}/metrics"],
                                  ["slo", "--url", "{base}/slo"],
                                  ["slo", "--url", "{base}/slo", "--json"],
                                  ["slo", "--url", "{base}/slo", "--gate"],
                                  ["traces", "--url", "{base}/traces"],
                                  ["traces", "--url", "{base}/traces", "--name",
                                   "serving.request", "--json"],
                                  ["traces", "--cluster", "--url", "{base}/traces"]])
def test_url_readers_print_what_jax_prints(capsys, static_server, argv):
    argv = [a.format(base=static_server) for a in argv]
    (jrc, jout), (trc, tout) = _both(capsys, argv)
    assert trc == jrc and tout == jout and tout.strip()
    assert trc == (1 if "--gate" in argv else 0)


def test_local_telemetry_formats(capsys):
    telemetry.reset()
    telemetry.enable()
    try:
        telemetry.get_registry().counter("cli_test_total", "a test counter").inc(2, k="v")
        for fmt in ("prom", "json", "jsonl"):
            assert tcli.main(["telemetry", "--format", fmt]) == 0
            assert "cli_test_total" in capsys.readouterr().out
    finally:
        telemetry.reset()
        telemetry.disable()
