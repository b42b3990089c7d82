"""The port's ``SequenceVectors(mesh=, shard_tables=)`` against the JAX
package's mesh trainers, and against each package's own one-device fit.

One spawn of 4 gloo ranks on a data=4 mesh (``tests/torch_dist_text.py
w2v_program``, one intra-op thread a rank); the JAX references run on 4
devices of the virtual CPU mesh (``jax.devices()[:4]``). Same corpora,
settings and injected negatives (the host alias draws of one
``RandomState(seed)``) in both packages. Tolerances:

- one sharded SGNS batch: tables at rtol 1e-5 + atol 1e-7 (the JAX
  package's own sharded-step check), the loss at rtol 1e-5;
- the SGNS mesh fit against the one-device fit, in each package: atol
  2e-4 (the ragged tail is cut to a multiple of the axis), and the port's
  mesh fit against JAX's at ``test_torch_word2vec.py``'s fit tolerance,
  atol 2e-6;
- the table-sharded fit against the one-device fit at rtol 1e-5 + atol
  1e-6 (the JAX package's), and against JAX's one-device fit at atol 2e-6.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import torch_dist_text as TDT
from deeplearning4j_tpu.text import word2vec as JW
from deeplearning4j_tpu_torch.parallel import launch as TL
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.text import word2vec as TW
from deeplearning4j_tpu_torch.text.paragraph_vectors import ParagraphVectors

WORLD = 4
FIT_ATOL = 2e-6


def _jmesh():
    return JMesh(np.array(jax.devices()[:WORLD]).reshape(WORLD), ("data",))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    syn0, syn1, centers, contexts, negs = TDT.step_inputs()
    dstep, _ = JW._dist_fns(JW._sgns_math, _jmesh())
    lr = TDT.STEP["lr"]
    ref = {"step": dstep(syn0.copy(), syn1.copy(), centers, contexts, negs, lr),
           "step_single": JW._sgns_step(syn0.copy(), syn1.copy(), centers, contexts, negs, lr),
           "sgns": TDT.fit(JW.SequenceVectors, TDT.corpus(), mesh=_jmesh(), **TDT.FIT),
           "sgns_single": TDT.fit(JW.SequenceVectors, TDT.corpus(), **TDT.FIT),
           "sharded_single": TDT.fit(JW.SequenceVectors, TDT.sharded_corpus(),
                                     **TDT.SHARDED_FIT)}
    ranks = TL.run_ranks(TDT.w2v_program, WORLD, tmp_path_factory.mktemp("w2v"), timeout=300)
    return ref, ranks


def test_one_sharded_sgns_batch_is_the_global_batch_update(run):
    """Each rank steps on its quarter; the all-gathered scatter-mean makes
    every rank's tables the one-device update of the whole batch."""
    ref = run[0]
    for want in (ref["step"], ref["step_single"]):
        for r in run[1]:
            t0, t1, loss = r["step"]
            np.testing.assert_allclose(t0, np.asarray(want[0]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(t1, np.asarray(want[1]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(loss, float(want[2]), rtol=1e-5)


def test_sgns_mesh_fit_matches_one_device_in_both_packages(run):
    ref, ranks = run
    j_mesh, j_single = ref["sgns"], ref["sgns_single"]
    np.testing.assert_allclose(np.asarray(j_mesh.syn0), np.asarray(j_single.syn0), atol=2e-4)
    for r in ranks:
        got = r["sgns"]
        np.testing.assert_allclose(got["syn0"], r["sgns_single"]["syn0"], atol=2e-4)
        np.testing.assert_allclose(got["syn0"], np.asarray(j_mesh.syn0), rtol=0, atol=FIT_ATOL)
        np.testing.assert_allclose(got["syn1"], np.asarray(j_mesh.syn1), rtol=0, atol=FIT_ATOL)
        np.testing.assert_allclose(got["loss"], np.asarray(j_mesh.loss_history), rtol=0,
                                   atol=FIT_ATOL)
        assert got["dropped"] == j_mesh.examples_dropped
        assert got["dropped"] <= (WORLD - 1) * TDT.FIT["epochs"]  # the remainder rule
    np.testing.assert_allclose(ranks[0]["sgns"]["syn0"], ranks[3]["sgns"]["syn0"], rtol=0, atol=0)


@pytest.mark.parametrize("algorithm", ["cbow", "hs"])
def test_cbow_and_hs_run_distributed(run, algorithm):
    """Finite tables and losses, the same tables on every rank, the chunks
    run eagerly (gloo cannot be captured; CBOW's 22 batches an epoch make
    no chunk of 32)."""
    got = [r[algorithm] for r in run[1]]
    for g in got:
        assert np.isfinite(g["syn0"]).all() and len(g["loss"]) and np.isfinite(g["loss"]).all()
        assert bool(g["chunks"]) == (algorithm == "hs")
        assert all(c == (0, True) for c in g["chunks"])
        np.testing.assert_allclose(g["syn0"], got[0]["syn0"], rtol=0, atol=0)


def test_table_sharded_sgns_matches_one_device(run):
    """V/n rows of each table a rank (the vocabulary padded to a multiple
    of 4); the fit equals the one-device fit."""
    want = run[0]["sharded_single"]
    for r in run[1]:
        got = r["sharded"]
        assert got["vp"] % WORLD == 0 and got["vp"] >= got["vocab"]
        assert got["rows"] == (got["vp"] // WORLD, TDT.SHARDED_FIT["vector_size"])
        single = r["sharded_single"]
        np.testing.assert_allclose(got["syn0"], single["syn0"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["syn1"], single["syn1"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["syn0"], np.asarray(want.syn0), rtol=0, atol=FIT_ATOL)
        np.testing.assert_allclose(got["loss"], np.asarray(want.loss_history), rtol=0,
                                   atol=FIT_ATOL)


def _mesh(n=WORLD):
    return Mesh((n, 1, 1, 1), 0, {"data": None}, {"data": list(range(n))})


def test_batch_size_must_divide_the_axis():
    with pytest.raises(ValueError, match="divide"):
        TW.SequenceVectors(vector_size=8, min_count=1, batch_size=65, mesh=_mesh(), seed=1,
                           device="cpu")


def test_shard_tables_takes_skipgram_negative_sampling_only():
    with pytest.raises(ValueError, match="skipgram"):
        TW.SequenceVectors(mesh=_mesh(), shard_tables=True, use_hierarchic_softmax=True,
                           device="cpu")
    with pytest.raises(ValueError, match="skipgram"):
        TW.SequenceVectors(mesh=_mesh(), shard_tables=True, algorithm="cbow", device="cpu")
    with pytest.raises(ValueError, match="requires mesh"):
        TW.SequenceVectors(shard_tables=True, device="cpu")


def test_paragraph_vectors_refuse_a_mesh_as_jax_does():
    pv = ParagraphVectors(vector_size=8, min_count=1, batch_size=64, mesh=_mesh(),
                          device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        pv.fit_documents([("a", ["x", "y"])])
