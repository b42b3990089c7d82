"""The rank program of ``test_torch_word2vec_mesh.py``, run on the CPU as
gloo processes by the port's ``parallel.launch.run_ranks``, and the fits
both packages run (the fit functions take the package's word2vec module).

This module imports torch, numpy and the port only (never JAX), so a
spawned rank starts in a few seconds.
"""

import numpy as np
import torch

RANK_THREADS = 1
#: the JAX mesh tests' settings (``tests/test_text.py``)
FIT = dict(vector_size=16, window=3, min_count=1, negative=3, epochs=2, batch_size=64,
           subsample=0, seed=9)
SHARDED_FIT = dict(vector_size=8, window=2, min_count=1, negative=3, epochs=2, batch_size=32,
                   subsample=0, seed=11)
STEP = dict(v=20, d=8, b=64, k=3, lr=0.05)


def corpus():
    """The JAX distributed test's corpus: 120 sentences of 12 of 10 words."""
    rs = np.random.RandomState(4)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta", "iota",
             "kappa"]
    return [[words[i] for i in rs.randint(0, len(words), 12)] for _ in range(120)]


def sharded_corpus():
    """The JAX table-sharded test's corpus: 80 sentences of 10 of 30 words."""
    rs = np.random.RandomState(7)
    words = [f"tok{i}" for i in range(30)]
    return [[words[i] for i in rs.randint(0, len(words), 10)] for _ in range(80)]


def step_inputs():
    rs = np.random.RandomState(0)
    v, d, b, k = STEP["v"], STEP["d"], STEP["b"], STEP["k"]
    return ((rs.randn(v, d) * 0.1).astype(np.float32), (rs.randn(v, d) * 0.1).astype(np.float32),
            rs.randint(0, v, b).astype(np.int32), rs.randint(0, v, b).astype(np.int32),
            rs.randint(0, v, (b, k)).astype(np.int32))


def fit(SequenceVectors, sequences, inject=True, **kw):
    """A fit whose negatives are the host alias draws of one
    ``RandomState(seed)`` (the same in either package and on every rank)."""
    sv = SequenceVectors(**kw)
    sv.build_vocab(sequences)
    if inject:
        rs = np.random.RandomState(kw["seed"])
        sv._draw_negatives = lambda shape: sv._neg_alias.draw(rs, shape)
    return sv.fit(sequences)


def w2v_program(rank, world):
    """One rank of 4 on a data=4 mesh: one SGNS step on this rank's quarter
    of the batch; the SGNS fit over the mesh and on one device; CBOW and HS
    over the mesh; the table-sharded SGNS fit."""
    torch.set_num_threads(RANK_THREADS)
    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.text import word2vec as TW

    mesh = make_mesh(MeshSpec(data=world))
    group = mesh.group("data")
    syn0, syn1, centers, contexts, negs = step_inputs()
    q = STEP["b"] // world
    mine = slice(rank * q, (rank + 1) * q)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    loss = TW._sgns_math(t0, t1, torch.from_numpy(centers[mine]),
                         torch.from_numpy(contexts[mine]), torch.from_numpy(negs[mine]),
                         STEP["lr"], group=group)
    out = {"step": (t0.numpy(), t1.numpy(), float(loss))}

    def tables(sv):
        s0, s1 = sv.whole_tables()
        return {"syn0": s0, "syn1": s1, "loss": np.asarray(sv.loss_history),
                "dropped": sv.examples_dropped}

    sents = corpus()
    out["sgns"] = tables(fit(TW.SequenceVectors, sents, mesh=mesh, device="cpu", **FIT))
    out["sgns_single"] = tables(fit(TW.SequenceVectors, sents, device="cpu", **FIT))
    for name, kw in (("cbow", dict(algorithm="cbow")),
                     ("hs", dict(use_hierarchic_softmax=True))):
        sv = fit(TW.SequenceVectors, sents, inject=False, mesh=mesh, device="cpu",
                 **{**FIT, **kw})
        out[name] = {**tables(sv), "chunks": [(e.captures, e.eager)
                                              for e in sv._chunk_steps.values()]}
    sv = fit(TW.SequenceVectors, sharded_corpus(), mesh=mesh, shard_tables=True, device="cpu",
             **SHARDED_FIT)
    out["sharded"] = {**tables(sv), "rows": tuple(sv.syn0.shape), "vp": world * sv.syn0.shape[0],
                      "vocab": len(sv.vocab)}
    out["sharded_single"] = tables(fit(TW.SequenceVectors, sharded_corpus(), device="cpu",
                                       **SHARDED_FIT))
    return out
