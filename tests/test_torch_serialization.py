"""Checkpoint zips (format v1) between the JAX package and the port."""

import io
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.misc import text_generation_lstm as j_charnn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.models.misc import text_generation_lstm as t_charnn
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser

VOCAB, HIDDEN, SEQ = 11, 32, 8


@pytest.fixture(scope="module")
def jax_net():
    net = JNet(j_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ))
    net.init()
    return net


@pytest.fixture(scope="module")
def jax_zip(jax_net, tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "jax.zip"
    jser.save_model(jax_net, str(path))
    return path


def _x(seed=0, rows=3):
    return np.random.RandomState(seed).randn(rows, SEQ, VOCAB).astype(np.float32)


def _arrays(path):
    with zipfile.ZipFile(path) as z:
        return dict(np.load(io.BytesIO(z.read("arrays.npz"))))


def test_jax_zip_loads_in_the_port(jax_net, jax_zip):
    net = tser.load_model(jax_zip, device="cpu")
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax_net.params)[0]}
    mine = {f"[{i}]['{k}']": t.detach().numpy()
            for i, layer in enumerate(net.params) for k, t in layer.items()}
    assert set(mine) == set(flat)
    for key, want in flat.items():
        np.testing.assert_array_equal(mine[key], want, err_msg=key)
    assert net.num_params() == jax_net.num_params()
    np.testing.assert_allclose(net.output(_x()).numpy(), np.asarray(jax_net.output(_x())),
                               atol=1e-5)


def test_port_zip_loads_in_jax(jax_zip, tmp_path):
    net = tser.load_model(jax_zip, device="cpu")
    out = tmp_path / "port.zip"
    tser.save_model(net, out)
    back = jser.load_model(str(out))
    np.testing.assert_allclose(np.asarray(back.output(_x(1))), net.output(_x(1)).numpy(),
                               atol=1e-5)
    assert back.conf.to_json() == net.conf.to_json()


def test_updater_state_and_rng_pass_through_unchanged(jax_zip, tmp_path):
    before = _arrays(jax_zip)
    assert any(k.startswith("opt") for k in before) and "rng" in before
    out = tmp_path / "again.zip"
    tser.save_model(tser.load_model(jax_zip, device="cpu"), out)
    after = _arrays(out)
    assert set(after) == set(before)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    back = jser.load_model(str(out))
    assert back.opt_state is not None


def test_params_from_numpy_matches_the_zip_path(jax_net, jax_zip):
    via_zip = tser.load_model(jax_zip, device="cpu")
    net = TNet(t_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ), device="cpu")
    net.init(torch.Generator().manual_seed(0))
    tser.params_from_numpy(net, [{k: np.asarray(v) for k, v in p.items()}
                                 for p in jax_net.params])
    np.testing.assert_array_equal(net.output(_x(2)).numpy(), via_zip.output(_x(2)).numpy())


def test_params_from_numpy_rejects_a_wrong_layout(jax_net):
    net = TNet(t_charnn(VOCAB, hidden=HIDDEN, seq_len=SEQ), device="cpu")
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jax_net.params]
    params[0]["Wx"] = params[0]["Wx"][:, :4]
    with pytest.raises(ValueError, match="shape"):
        tser.params_from_numpy(net, params)
    del params[1]["Wp"]
    params[0]["Wx"] = np.asarray(jax_net.params[0]["Wx"])
    with pytest.raises(ValueError, match="keys"):
        tser.params_from_numpy(net, params)


def test_graph_checkpoints_are_not_ported_yet(tmp_path):
    """A JAX graph checkpoint whose config uses a MergeVertex (once
    refused) loads in the port and computes the same output."""
    from deeplearning4j_tpu.nn import graph as jg
    from deeplearning4j_tpu.nn import layers as JL
    from deeplearning4j_tpu.nn.conf import inputs as JI

    conf = (jg.GraphBuilder().add_inputs("a", "b")
            .set_input_types(JI.FeedForwardType(3), JI.FeedForwardType(2))
            .add_vertex("merge", jg.MergeVertex(), "a", "b")
            .add_layer("out", JL.OutputLayer(n_out=2), "merge").set_outputs("out").build())
    net = jg.ComputationGraph(conf)
    net.init()
    path = tmp_path / "graph.zip"
    jser.save_model(net, str(path))
    tnet = tser.load_model(path, device="cpu")
    assert tnet.conf.to_json() == conf.to_json()
    rs = np.random.RandomState(0)
    x = {"a": rs.randn(4, 3).astype(np.float32), "b": rs.randn(4, 2).astype(np.float32)}
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(net.output(x)), atol=1e-6)