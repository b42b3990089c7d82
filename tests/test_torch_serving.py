"""Slice 1 as a whole: a char-RNN built and saved by the JAX package, served
by the port's registry, engine and CLI on the CPU, against the JAX
network's own output (atol 1e-5)."""

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
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry, ShapeBuckets
from deeplearning4j_tpu_torch.models.misc import text_generation_lstm as t_charnn
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
    with pytest.raises(NotImplementedError, match="ComputationGraph"):
        engine.submit({"in": _x(1, 4, seed=7)[0]})


def test_registry_names_and_duplicates(model_zip, registry):
    _register(registry, model_zip)
    assert list(registry.status()["models"]) == ["charnn"]
    with pytest.raises(ValueError, match="already registered"):
        _register(registry, model_zip)
    with pytest.raises(KeyError, match="no model"):
        registry.engine("other")


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
