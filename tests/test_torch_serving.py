"""Slice 1 as a whole: a char-RNN built and saved by the JAX package, served
by the port's registry, engine and CLI on the CPU, against the JAX
network's own output (atol 1e-5). And a ComputationGraph served in the
dict form: a two-input, two-output graph saved by the JAX package, its
results against the JAX graph's ``apply_fn`` outputs (f32, atol 1e-5); a
recurrent graph on (batch, seq) buckets; the ``serve`` and ``eval`` verbs
on graph zips (``eval`` on ``.npy`` arrays and on a labelled CSV); the
registry's API (``engine_kwargs``, ``names``, ``submit``, ``output``,
``unregister``, the module's ``reset``)."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iterator import BucketRegistry as JBuckets
from deeplearning4j_tpu.datasets.iterator import ShapeBuckets as JShape
from deeplearning4j_tpu.models.misc import text_generation_lstm as j_charnn
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry, ShapeBuckets
from deeplearning4j_tpu_torch.models.misc import text_generation_lstm as t_charnn
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.graph import GraphBuilder as TGB
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.serving import (ModelRegistry, ServingOverloaded,
                                              ServingShutdown)
from deeplearning4j_tpu_torch.utils import serialization as tser

VOCAB, HIDDEN, SEQ = 11, 32, 8
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_net():
    net = JNet(j_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ))
    net.init()
    return net


@pytest.fixture(scope="module")
def model_zip(jax_net, tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "charnn.zip"
    jser.save_model(jax_net, str(path))
    return path


@pytest.fixture
def registry():
    reg = ModelRegistry()
    yield reg
    reg.stop()


def _register(registry, model_zip, **kw):
    net = tser.load_model(model_zip, device="cpu")
    kw.setdefault("input_spec", (SEQ, VOCAB))
    kw.setdefault("max_batch_size", 4)
    return registry.register("charnn", net, device="cpu", **kw)


def _x(rows, steps, seed):
    return np.random.RandomState(seed).randn(rows, steps, VOCAB).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("steps", [5, 8])
def test_served_output_matches_jax(jax_net, model_zip, registry, rows, steps):
    engine = _register(registry, model_zip, seq_buckets=(4, 8))
    x = _x(rows, steps, seed=rows * 10 + steps)
    want = np.asarray(jax_net.output(x))
    singles = [engine.submit(x[i]) for i in range(rows)]
    batched = engine.submit(x, batched=True)
    got = np.stack([f.get(timeout=30) for f in singles])
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(batched.get(timeout=30), want, atol=1e-5)
    np.testing.assert_allclose(engine.output(x), want, atol=1e-5)
    stats = engine.stats()
    assert stats["requests"]["served"] == 3 * rows
    assert stats["seq_buckets"] == [4, 8] and stats["device"] == "cpu"


def test_batch_only_buckets_match_jax(jax_net, model_zip, registry):
    engine = _register(registry, model_zip, buckets=(2, 4))
    x = _x(5, SEQ, seed=3)
    futs = [engine.submit(x[i]) for i in range(5)]
    np.testing.assert_allclose(np.stack([f.get(timeout=30) for f in futs]),
                               np.asarray(jax_net.output(x)), atol=1e-5)
    assert engine.stats()["buckets"] == [2, 4]


def test_warmup_runs_every_bucket(model_zip, registry):
    engine = _register(registry, model_zip, seq_buckets=(4, 8))
    assert engine.stats()["forward"] == {"warmed": 6, "forwards": 6}  # batch {1,2,4} x seq {4,8}


def test_full_queue_sheds(model_zip, registry):
    engine = _register(registry, model_zip, max_queue=2, start=False)
    x = _x(3, SEQ, seed=4)
    engine.submit(x[0])
    engine.submit(x[1])
    with pytest.raises(ServingOverloaded) as info:
        engine.submit(x[2])
    assert info.value.reason == "queue_full"
    with pytest.raises(ValueError, match="admission bound"):
        engine.submit(x, batched=True)
    assert engine.stats()["requests"]["shed_queue_full"] == 1


def test_stale_request_sheds_by_deadline(model_zip, registry):
    engine = _register(registry, model_zip, start=False)
    fut = engine.submit(_x(1, SEQ, seed=5)[0], deadline_s=0.0)
    time.sleep(0.01)
    engine.start()
    with pytest.raises(ServingOverloaded) as info:
        fut.get(timeout=30)
    assert info.value.__cause__.reason == "deadline"


def test_stop_fails_pending_and_refuses_new(model_zip, registry):
    engine = _register(registry, model_zip, start=False)
    fut = engine.submit(_x(1, SEQ, seed=6)[0])
    engine.stop()
    with pytest.raises(ServingShutdown):
        fut.get(timeout=5)
    with pytest.raises(ServingShutdown):
        engine.submit(_x(1, SEQ, seed=6)[0])


def test_seq_longer_than_the_grid_is_refused(model_zip, registry):
    engine = _register(registry, model_zip, seq_buckets=(4, 8))
    with pytest.raises(ValueError, match="seq bucket"):
        engine.submit(_x(1, 9, seed=7)[0])
    # the dict form of a recurrent graph is served on the same grid: every
    # leaf padded on axis 1, the output sliced back; a longer one is refused
    g = TGB(seed=3)
    g.add_inputs("in")
    g.set_input_types(TI.RecurrentType(VOCAB, SEQ))
    g.add_layer("lstm", TL.GravesLSTM(n_out=8), "in")
    g.add_layer("out", TL.RnnOutputLayer(n_out=VOCAB, loss="mcxent"), "lstm")
    g.set_outputs("out")
    gnet = TGraph(g.build(), device="cpu")
    gnet.init()
    gengine = registry.register("charnn_graph", gnet, input_spec={"in": (SEQ, VOCAB)},
                                max_batch_size=4, seq_buckets=(4, 8), device="cpu")
    x = _x(2, 6, seed=7)
    got = [gengine.submit({"in": x[i]}).get(timeout=30) for i in range(2)]
    want = gnet.output({"in": x}).numpy()
    assert got[0]["out"].shape == (6, VOCAB)
    np.testing.assert_allclose(np.stack([r["out"] for r in got]), want, atol=1e-5)
    with pytest.raises(ValueError, match="seq bucket"):
        gengine.submit({"in": _x(1, 9, seed=7)[0]})


def test_registry_names_and_duplicates(model_zip, registry):
    _register(registry, model_zip)
    assert list(registry.status()["models"]) == ["charnn"]
    with pytest.raises(ValueError, match="already registered"):
        _register(registry, model_zip)
    with pytest.raises(KeyError, match="no model"):
        registry.engine("other")


def test_registry_api_matches_jax(jax_net, model_zip, registry):
    """``engine_kwargs``, ``names``, ``submit``, ``output`` and
    ``unregister``, the JAX registry's API (JAX ``serving/registry.py``):
    results against the JAX network's output."""
    _register(registry, model_zip, seq_buckets=(4, 8))
    net2 = tser.load_model(model_zip, device="cpu")
    registry.register("second", net2, input_spec=(SEQ, VOCAB), max_batch_size=2, device="cpu")
    assert registry.names() == ["charnn", "second"]
    kw = registry.engine_kwargs("charnn")
    assert kw["seq_buckets"] == (4, 8) and kw["max_batch_size"] == 4 and kw["device"] == "cpu"
    kw["max_batch_size"] = 99  # a copy: the registry keeps its own
    assert registry.engine_kwargs("charnn")["max_batch_size"] == 4
    x = _x(3, SEQ, seed=11)
    want = np.asarray(jax_net.output(x))
    np.testing.assert_allclose(registry.submit("charnn", x[0]).get(timeout=30), want[0], atol=1e-5)
    np.testing.assert_allclose(registry.submit("second", x, batched=True).get(timeout=30), want,
                               atol=1e-5)
    np.testing.assert_allclose(registry.output("charnn", x), want, atol=1e-5)
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        registry.submit("charnn", x[0], tenant="acme")
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        registry.submit("charnn", x[0], origin="batch-job")
    engine = registry.engine("second")
    registry.unregister("second")
    assert registry.names() == ["charnn"] and not engine.running
    with pytest.raises(KeyError, match="no model"):
        registry.engine_kwargs("second")
    with pytest.raises(KeyError):
        registry.unregister("second")


def test_module_reset_stops_the_default_registry(model_zip):
    from deeplearning4j_tpu_torch.serving import registry as reg_mod

    reg = reg_mod.get_model_registry()
    engine = reg.register("r", tser.load_model(model_zip, device="cpu"),
                          input_spec=(SEQ, VOCAB), max_batch_size=2, device="cpu")
    assert reg_mod.get_model_registry() is reg
    reg_mod.reset()
    assert not engine.running and reg.names() == []
    assert reg_mod.get_model_registry() is not reg
    reg_mod.reset()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TNet(t_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ))
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRegistry().register("x", TNet(t_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ),
                                           device="cpu"))


def test_serve_cli_smoke(model_zip):
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path",
         str(model_zip), "--smoke", "4", "--device", "cpu", "--max-batch", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "warmed buckets [1, 2, 4]" in proc.stdout
    assert '"served": 4' in proc.stdout


@pytest.mark.parametrize("sizes", [[1, 2, 4, 8], [3, 5, 16], [32]])
def test_bucket_registry_matches_jax(sizes):
    mine, ref = BucketRegistry(sizes), JBuckets(sizes)
    assert mine.sizes() == ref.sizes() and mine.max == ref.max
    for n in range(0, 40):
        assert mine.bucket_for(n) == ref.bucket_for(n)
    assert BucketRegistry.powers_of_two(48).sizes() == JBuckets.powers_of_two(48).sizes()


def test_shape_buckets_match_jax():
    mine, ref = ShapeBuckets([1, 4, 16], [32, 64, 128]), JShape([1, 4, 16], [32, 64, 128])
    assert mine.sizes() == ref.sizes() and mine.max_seq == ref.max_seq
    for rows in range(0, 20):
        for seq in (1, 31, 32, 33, 100, 128, 129):
            assert mine.bucket_for(rows, seq) == ref.bucket_for(rows, seq)


# ---------------------------------------------------------------------------
# a ComputationGraph in the dict form
# ---------------------------------------------------------------------------

def _two_in_two_out(GB, L, I, merge):
    g = GB(seed=11)
    g.add_inputs("img", "meta")
    g.set_input_types(I.ConvolutionalType(6, 6, 2), I.FeedForwardType(3))
    g.add_layer("conv", L.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same",
                                           activation="relu"), "img")
    g.add_layer("pool", L.GlobalPoolingLayer(mode="avg"), "conv")
    g.add_vertex("merge", merge, "pool", "meta")
    g.add_layer("h", L.DenseLayer(n_out=8, activation="tanh"), "merge")
    g.add_layer("cls", L.OutputLayer(n_out=3, loss="mcxent"), "h")
    g.add_layer("reg", L.OutputLayer(n_out=2, loss="mse", activation="identity"), "h")
    g.set_outputs("cls", "reg")
    return g.build()


@pytest.fixture(scope="module")
def graph_pair(tmp_path_factory):
    jnet = JGraph(_two_in_two_out(JGB, JL, JI, JMerge()))
    jnet.init()
    path = tmp_path_factory.mktemp("serve_graph") / "graph.zip"
    jser.save_model(jnet, str(path))
    return jnet, path


def _gx(rows, seed):
    rs = np.random.RandomState(seed)
    return {"img": rs.rand(rows, 6, 6, 2).astype(np.float32),
            "meta": rs.randn(rows, 3).astype(np.float32)}


def test_graph_dict_requests_match_jax(graph_pair, registry):
    jnet, path = graph_pair
    net = tser.load_model(path, device="cpu")
    engine = registry.register("graph", net, input_spec={"img": (6, 6, 2), "meta": (3,)},
                               max_batch_size=4, device="cpu")
    assert engine.stats()["forward"]["warmed"] == 3
    x = _gx(7, seed=1)
    want, _ = jnet.apply_fn(jnet.params, jnet.state, x)
    singles = [engine.submit({k: v[i] for k, v in x.items()}) for i in range(7)]
    batched = engine.submit({k: v[:5] for k, v in x.items()}, batched=True)
    direct = engine.output(x)
    for head in ("cls", "reg"):
        ref = np.asarray(want[head])
        np.testing.assert_allclose(np.stack([f.get(timeout=30)[head] for f in singles]), ref,
                                   atol=1e-5)
        np.testing.assert_allclose(batched.get(timeout=30)[head], ref[:5], atol=1e-5)
        np.testing.assert_allclose(direct[head], ref, atol=1e-5)
    assert engine.stats()["requests"]["errors"] == 0


def test_graph_batched_dict_with_mismatched_rows_is_refused(graph_pair, registry):
    _, path = graph_pair
    engine = registry.register("graph", tser.load_model(path, device="cpu"),
                               input_spec={"img": (6, 6, 2), "meta": (3,)}, max_batch_size=4,
                               device="cpu", start=False)
    x = _gx(4, seed=2)
    with pytest.raises(ValueError, match="one shared length"):
        engine.submit({"img": x["img"][:3], "meta": x["meta"][:2]}, batched=True)
    with pytest.raises(ValueError, match="at least one example"):
        engine.submit({"img": x["img"][:0], "meta": x["meta"][:0]}, batched=True)
    assert engine.stats()["queue_depth"] == 0


def test_serve_and_eval_cli_on_graph_zips(graph_pair, tmp_path):
    jnet, path = graph_pair
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path", str(path),
         "--smoke", "5", "--device", "cpu", "--max-batch", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'img': (6, 6, 2)" in proc.stdout and '"served": 5' in proc.stdout
    # eval on a single-input graph zip, labels as class indices
    g = JGB(seed=2)
    g.add_inputs("in")
    g.set_input_types(JI.FeedForwardType(4))
    g.add_layer("out", JL.OutputLayer(n_out=3, loss="mcxent"), "in")
    g.set_outputs("out")
    jg = JGraph(g.build())
    jg.init()
    zip_path = tmp_path / "g1.zip"
    jser.save_model(jg, str(zip_path))
    rs = np.random.RandomState(3)
    x, y = rs.randn(10, 4).astype(np.float32), rs.randint(0, 3, 10)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "eval", "--model-path", str(zip_path),
         "--data", str(tmp_path / "x.npy"), "--labels", str(tmp_path / "y.npy"),
         "--device", "cpu", "--batch-size", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from deeplearning4j_tpu.eval.classification import Evaluation
    ref = Evaluation()
    ref.eval(np.eye(3)[y], np.asarray(jg.output(x)))
    assert ref.stats() in proc.stdout
    # the same data as a labelled CSV (datasets/records.py): the label in column 0
    (tmp_path / "x.csv").write_text("\n".join(
        f"{lab}," + ",".join(repr(float(v)) for v in row) for row, lab in zip(x, y)) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "eval", "--model-path", str(zip_path),
         "--data", str(tmp_path / "x.csv"), "--label-column", "0", "--n-classes", "3",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ref.stats() in proc.stdout


def test_single_input_graph_batches_arrays_and_dicts_together(registry):
    """One array and the dict form of a single-input graph are the same
    request: both coalesce into one drained batch."""
    g = TGB(seed=4)
    g.add_inputs("input")
    g.set_input_types(TI.FeedForwardType(5))
    g.add_layer("fc", TL.OutputLayer(n_out=3, loss="mcxent"), "input")
    g.set_outputs("fc")
    net = TGraph(g.build(), device="cpu")
    net.init()
    engine = registry.register("g1", net, input_spec=(5,), buckets=(8,), device="cpu",
                               start=False)
    x = np.random.RandomState(6).randn(6, 5).astype(np.float32)
    futs = [engine.submit({"input": x[i]} if i % 2 else x[i]) for i in range(4)]
    futs.append(engine.submit({"input": x[4:]}, batched=True))
    engine.start()
    got = np.concatenate([np.stack([f.get(timeout=30)["fc"] for f in futs[:4]]),
                          futs[4].get(timeout=30)["fc"]])
    np.testing.assert_allclose(got, net.output(x).numpy(), atol=1e-6)
    assert engine.stats()["forward"]["forwards"] == engine.stats()["forward"]["warmed"] + 1
