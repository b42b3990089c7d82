"""The port's numerics watchdog (``telemetry/health.py``) and score
pipeline (``telemetry/scorepipe.py``), on the CPU.

Mirrors the JAX package's ``tests/test_health.py`` where it applies (the
flight recorder and the metrics registry are not ported): the bundle
against the JAX package's ``health_stats`` on the same gradients,
parameters and loss (float32, rtol 1e-6); the policies through a real fit
with NaN features in one batch, at K=1 and K=4: ``record`` counts and
completes, ``warn`` logs, ``raise`` raises ``NumericsError`` naming the
step, one dispatch late; ``grad_norm_limit``; a stacked ``[K]`` bundle fans
out into one record a real step; the train step's bundle from inside the
step equals the one from its gradients.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.telemetry.health import health_stats as j_health_stats
from deeplearning4j_tpu_torch.continuous import StepDriver
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.telemetry import ScorePipeline, health
from deeplearning4j_tpu_torch.telemetry.health import (HealthMonitor, NumericsError,
                                                       any_nonfinite, health_stats,
                                                       tree_sq_sum)


@pytest.fixture(autouse=True)
def _isolate():
    health.get_monitor().reset()
    yield
    health.get_monitor().reset()


def _mlp(seed=0):
    conf = NeuralNetConfig(seed=seed, updater=U.Adam(learning_rate=0.01)).list(
        L.DenseLayer(n_out=8, activation="tanh"), L.OutputLayer(n_out=2, loss="mcxent"),
        input_type=I.FeedForwardType(4))
    return MultiLayerNetwork(conf, device="cpu")


def _xy(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]
    return x, y


def _nan_xy(n=64, batch=16):
    """A clean step 0 and NaN features in step 1's batch."""
    x, y = _xy(n)
    x[batch:2 * batch] = np.nan
    return x, y


class TestHealthStats:
    def test_bundle_list_tree(self):
        b = health_stats([{"W": torch.ones(2, 2)}, {}], [{"W": torch.full((2, 2), 2.0)}, {}],
                         torch.tensor(1.0))
        assert float(b["grad_norm"]) == pytest.approx(2.0)
        assert not bool(b["loss_nonfinite"]) and not bool(b["grad_nonfinite"])
        assert float(b["layer/0/grad_norm"]) == pytest.approx(2.0)
        assert float(b["layer/0/gw_ratio"]) == pytest.approx(0.5)
        assert float(b["layer/1/gw_ratio"]) == 0.0

    def test_bundle_dict_tree_keeps_vertex_names(self):
        b = health_stats({"dense": {"W": torch.ones(3)}, "out": {}},
                         {"dense": {"W": torch.ones(3)}, "out": {}}, torch.tensor(0.5))
        assert "layer/dense/grad_norm" in b and "layer/out/grad_norm" in b

    def test_detects_nonfinite(self):
        b = health_stats([{"W": torch.tensor([np.nan, 1.0])}], [{"W": torch.ones(2)}],
                         torch.tensor(np.inf))
        assert bool(b["grad_nonfinite"]) and bool(b["loss_nonfinite"])
        assert bool(any_nonfinite([{"a": torch.tensor([1.0, np.inf])}]))
        assert not bool(any_nonfinite([]))
        assert float(tree_sq_sum([{"a": torch.tensor([3.0, 4.0])}])) == 25.0

    @pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
    def test_matches_jax_on_the_same_gradients(self, graph):
        rs = np.random.RandomState(4)
        shapes = {"a": {"W": (5, 3), "b": (3,)}, "b": {"W": (3, 2)}, "c": {}}
        tree = lambda: {n: {k: rs.randn(*s).astype(np.float32) for k, s in d.items()}
                        for n, d in shapes.items()}
        g, p = tree(), tree()
        if not graph:
            g, p = list(g.values()), list(p.values())
        as_t = lambda t: ({n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in t.items()}
                          if isinstance(t, dict) else
                          [{k: torch.from_numpy(v) for k, v in d.items()} for d in t])
        as_j = lambda t: ({n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in t.items()}
                          if isinstance(t, dict) else
                          [{k: jnp.asarray(v) for k, v in d.items()} for d in t])
        mine = health_stats(as_t(g), as_t(p), torch.tensor(1.25))
        theirs = j_health_stats(as_j(g), as_j(p), jnp.float32(1.25))
        assert set(mine) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(float(mine[k]), float(theirs[k]), rtol=1e-6, err_msg=k)

    def test_train_step_bundle_is_computed_inside_the_step(self):
        net = _mlp()
        net.init()
        net.opt_state = net.conf.updater.init(net.params)
        x, y = (torch.from_numpy(a) for a in _xy(8))
        loss, _, grads = net.compute_gradients(net.params, net.state, x, y)
        want = health_stats(grads, net.params, loss)
        out = net.make_train_step(with_health=True)(net.params, net.state, net.opt_state, x, y,
                                                   0)
        assert len(out) == 5
        for k in want:
            assert float(out[4][k]) == pytest.approx(float(want[k]), rel=1e-6), k


class TestMonitor:
    def test_one_late_resolution_and_flush(self):
        mon = HealthMonitor().enable(policy="record")
        ok = health_stats([{"W": torch.ones(2)}], [{"W": torch.ones(2)}], torch.tensor(1.0))
        mon.on_step(ok, step=0)
        assert mon.steps_checked == 0  # queued, not resolved
        mon.on_step(ok, step=1)
        assert mon.steps_checked == 1
        mon.flush()
        assert mon.steps_checked == 2 and mon.last["step"] == 1

    def test_stacked_bundle_fans_out_real_steps(self):
        mon = HealthMonitor().enable(policy="record")
        bundle = {"loss": torch.tensor([1.0, np.nan, 0.0]),
                  "loss_nonfinite": torch.tensor([False, True, False]),
                  "grad_nonfinite": torch.tensor([False, False, False]),
                  "grad_norm": torch.tensor([1.0, 2.0, 0.0])}
        mon.on_step(bundle, step=10, k=2)
        mon.flush()
        assert mon.steps_checked == 2  # the padded third step is dropped
        assert [a["step"] for a in mon.anomalies] == [11]

    def test_raise_policy_and_summary(self):
        mon = HealthMonitor().enable(policy="raise", grad_norm_limit=1.5)
        big = health_stats([{"W": torch.full((4,), 1.0)}], [{"W": torch.ones(4)}],
                           torch.tensor(1.0))
        mon.on_step(big, step=7)
        with pytest.raises(NumericsError) as ei:
            mon.flush()
        assert ei.value.step == 7 and ei.value.record["kind"] == "grad_norm_limit"
        s = mon.summary()
        assert s["policy"] == "raise" and s["nonfinite_steps"] == 1 and s["active"]
        with pytest.raises(ValueError, match="policy"):
            mon.enable(policy="explode")
        assert not mon.disable().active

    def test_module_level_monitor(self):
        assert health.enable(policy="warn") is health.get_monitor()
        assert health.get_monitor().active and health.get_monitor().policy == "warn"
        health.disable()
        assert not health.get_monitor().active


class TestWatchdogFit:
    @pytest.mark.parametrize("k", [1, 4])
    def test_policy_raise_names_the_nan_step(self, k):
        health.enable(policy="raise")
        x, y = _nan_xy()
        with pytest.raises(NumericsError) as ei:
            _mlp().fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=k)
        assert ei.value.step == 1 and ei.value.record["kind"] == "nonfinite"

    @pytest.mark.parametrize("k", [1, 4])
    def test_policy_record_counts_and_completes(self, k):
        health.enable(policy="record")
        x, y = _nan_xy()
        net = _mlp()
        net.fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=k)
        mon = health.get_monitor()
        assert mon.nonfinite_steps >= 2 and mon.steps_checked == 4
        assert mon.summary()["anomalies"][0]["step"] == 1
        assert net.iteration == 4

    def test_raised_one_dispatch_late(self):
        """At K=2 the NaN sits in the first dispatch; its bundle resolves as
        the second dispatch is queued, so the raise comes from round 2."""
        health.enable(policy="raise")
        x, y = _nan_xy()
        net = _mlp()
        drv = StepDriver(net, lambda: ((x[i:i + 16], y[i:i + 16], None) for i in (0, 16, 32, 48)),
                         k=2, batch_size=16, prefetch=False)
        drv.run_round(1)  # queued, unresolved
        with pytest.raises(NumericsError):
            drv.run_round(1)
        assert net.iteration == 4
        drv.close_source()

    def test_policy_warn_logs(self, caplog):
        health.enable(policy="warn")
        x, y = _nan_xy(n=48)
        with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
            _mlp().fit(x, y, epochs=1, batch_size=16)
        assert any("numerics watchdog" in r.message for r in caplog.records)

    def test_healthy_fit_and_grad_norm_limit(self):
        health.enable(policy="raise")
        x, y = _xy()
        _mlp().fit(x, y, epochs=1, batch_size=16)
        assert health.get_monitor().nonfinite_steps == 0
        assert health.get_monitor().steps_checked == 4
        health.enable(policy="raise", grad_norm_limit=1e-9)
        with pytest.raises(NumericsError) as ei:
            _mlp().fit(x, y, epochs=1, batch_size=16)
        assert ei.value.record["kind"] == "grad_norm_limit"

    def test_graph_fit_watchdog(self):
        health.enable(policy="raise")
        conf = (GraphBuilder(updater=U.Sgd(learning_rate=0.1)).add_inputs("in")
                .set_input_types(I.FeedForwardType(4))
                .add_layer("d", L.DenseLayer(n_out=8, activation="tanh"), "in")
                .add_layer("out", L.OutputLayer(n_out=2, loss="mcxent"), "d")
                .set_outputs("out").build())
        x, y = _nan_xy()
        with pytest.raises(NumericsError):
            ComputationGraph(conf, device="cpu").fit(x, y, batch_size=16, steps_per_dispatch=2)

    def test_disabled_fit_checks_nothing(self):
        x, y = _xy()
        _mlp().fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=2)
        assert health.get_monitor().steps_checked == 0


class TestScorePipeline:
    def test_one_late_scalars_and_stacked(self):
        pipe = ScorePipeline()
        assert pipe.push(torch.tensor(1.5), {"i": 0}) is None and pipe.pending
        assert pipe.push(torch.tensor([2.0, 3.0]), {"i": 1}) == (1.5, {"i": 0})
        assert pipe.flush() == ([2.0, 3.0], {"i": 1})
        assert pipe.flush() is None
        pipe.push(torch.tensor(4.0))
        pipe.abandon()
        assert not pipe.pending

    def test_tbptt_chunks_resolve_together(self):
        pipe = ScorePipeline()
        pipe.push(torch.tensor(1.0), {"chunks": [(1, torch.tensor(0.5)), (2, torch.tensor(1.5))]})
        score, meta = pipe.flush()
        assert score == 1.0 and meta["chunk_scores"] == [0.5, 1.5]
