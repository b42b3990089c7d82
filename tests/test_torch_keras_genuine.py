"""The reference's genuine Keras 1.2.2 fixtures (tfscope/model.h5, its
tensorflow-name-scope variant, and the config JSON + save_weights() pair
KerasModelImportTest.java loads) through the port's importer, against a
numpy forward of the raw HDF5 datasets and against the JAX package's
import. The fixtures are read in place from the reference tree where it is
present, behind the same guard as ``tests/test_keras_genuine.py``, whose
location constant this module takes."""

import os

import numpy as np
import pytest
import torch

import torch_native_guard  # noqa: E402

# before any test runs: the JAX package's native library, built without the race
torch_native_guard.heal_reference_native()

from test_keras_genuine import FIXTURES

pytestmark = pytest.mark.skipif(
    not os.path.isdir(FIXTURES),
    reason="reference tree with genuine Keras fixtures not present")


def _raw_dense_chain(archive, prefix):
    """[(W, b), ...] for the two dense layers, located by each layer
    group's weight_names attribute or, without it, by walking the group."""
    from deeplearning4j_tpu_torch.modelimport.keras import _walk_datasets

    out = []
    for layer in ("dense_1", "dense_2"):
        base = f"{prefix}{layer}"
        try:
            names = archive.read_attr_strings("weight_names", base)
        except IOError:
            names = _walk_datasets(archive, base)
        w = {n.rsplit("_", 1)[-1].split(":")[0]: archive.read_dataset(f"{base}/{n}")
             for n in names}
        out.append((w["W"], w["b"]))
    return out


def _chain(path, prefix):
    from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

    with Hdf5Archive(path) as a:
        return _raw_dense_chain(a, prefix)


def _assert_import_matches(net, jnet, chain):
    assert [type(l).__name__ for l in net.conf.layers] == ["DenseLayer", "DenseLayer"]
    assert net.num_params() == 70 * 256 + 256 + 256 * 2 + 2  # 18,690
    x = np.random.RandomState(0).randn(8, 70).astype(np.float32)
    got = net.output(x).numpy()
    want = np.tanh(x @ chain[0][0] + chain[0][1]) @ chain[1][0] + chain[1][1]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), rtol=1e-5, atol=1e-6)
    for mine, theirs in zip(net.params, jnet.params):
        for k in mine:
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k], np.float32))


@pytest.mark.parametrize("h5name", ["model.h5", "model.h5.with.tensorflow.scope"])
def test_full_h5_import_is_numerically_exact(h5name):
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_sequential_model_and_weights as jimport
    from deeplearning4j_tpu_torch.modelimport.keras import \
        import_keras_sequential_model_and_weights

    path = os.path.join(FIXTURES, h5name)
    _assert_import_matches(import_keras_sequential_model_and_weights(path, device="cpu"),
                           jimport(path), _chain(path, "model_weights/"))


@pytest.mark.parametrize("jsonname,weightname", [
    ("model.json", "model.weight"),
    ("model.json.with.tensorflow.scope", "model.weight.with.tensorflow.scope")])
def test_config_plus_weights_pair_import(jsonname, weightname):
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_sequential_config_and_weights as jimport
    from deeplearning4j_tpu_torch.modelimport.keras import \
        import_keras_sequential_config_and_weights

    cfg, weights = os.path.join(FIXTURES, jsonname), os.path.join(FIXTURES, weightname)
    _assert_import_matches(import_keras_sequential_config_and_weights(cfg, weights, device="cpu"),
                           jimport(cfg, weights), _chain(weights, ""))


def test_scoped_weight_names_attr_not_truncated():
    """The fixed-length string attribute keeps its last character (':0',
    not ':')."""
    from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

    with Hdf5Archive(os.path.join(FIXTURES, "model.h5")) as a:
        names = a.read_attr_strings("weight_names", "model_weights/dense_1")
    assert names == ["global/shared/dense_1_W:0", "global/shared/dense_1_b:0"]


def test_restore_checkpoint_guesses_keras_h5():
    """``models.zoo.restore_checkpoint`` sniffs the HDF5 signature of the
    genuine file and routes it through the Keras importer."""
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_sequential_model_and_weights as jimport
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint

    path = os.path.join(FIXTURES, "model.h5")
    net = restore_checkpoint(path, device="cpu")
    assert all(p.device == torch.device("cpu") for p in net.parameters())
    _assert_import_matches(net, jimport(path), _chain(path, "model_weights/"))
