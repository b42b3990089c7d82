"""The port's SequenceVectors / Word2Vec (``text/word2vec.py``) against the
JAX package's, on the CPU.

Both packages get the same numpy inputs made from a seed:

* the three update functions (``_sgns_math``, ``_hs_math``,
  ``_cbow_math``) one batch at a time with many index collisions (V = 12
  rows, B = 128), tables and loss at f32 rtol 1e-5 / atol 1e-7, as the JAX
  package's own sharded-step test holds its update
  (``tests/test_text.py::TestDistributedWord2Vec``); the same over one
  ``SCAN_CHUNK`` of batches plus leftover and ragged batches through
  ``_run_batched`` (the CPU runs the chunk eagerly over the static
  buffers a card captures into one CUDA graph);
* whole fits: hierarchical-softmax skip-gram draws only from the host's
  ``RandomState`` streams, so its fit is compared as is; SGNS and CBOW
  fits draw their negatives on the device from a ``torch.Generator`` in the
  port and from threefry in JAX, so both instances' ``_draw_negatives``
  are replaced by the same host alias draws. Each fit's tolerance is set
  from the difference measured between the packages (f32 sums in another
  order over a few hundred steps), about 10x above it;
* the device alias draw against the negative-sampling distribution, the
  touched-rows update against the dense form, ``tables_from_numpy``, the
  chunk engine's bookkeeping, no host sync inside a step (a card captures
  it), and the contract that ``device="cuda"`` raises without a card (the
  mesh trainers are ``test_torch_word2vec_mesh.py``'s).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.text import word2vec as JW
from deeplearning4j_tpu_torch.text import word2vec as TW

RTOL, ATOL = 1e-5, 1e-7


def _toy_corpus(n=300, seed=0):
    """Two topic clusters (the JAX tests' corpus)."""
    rs = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "meow"]
    vehicles = ["car", "road", "drive", "wheel", "fuel"]
    seqs = []
    for _ in range(n):
        pool = animals if rs.rand() < 0.5 else vehicles
        seqs.append([pool[rs.randint(len(pool))] for _ in range(8)])
    return seqs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(rs, v, d, rows1=None):
    syn0 = (rs.randn(v, d) * 0.3).astype(np.float32)
    syn1 = (rs.randn(rows1 or v, d) * 0.3).astype(np.float32)
    return syn0, syn1


def _close(port, jax_value, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_value), rtol=rtol, atol=atol)


# ---- the update functions, one batch, with collisions ----

@pytest.mark.parametrize("seed", [0, 1])
def test_sgns_step_matches_jax_under_collisions(seed):
    rs = np.random.RandomState(seed)
    v, d, b, k = 12, 16, 128, 4
    syn0, syn1 = _tables(rs, v, d)
    centers = rs.randint(0, v, b).astype(np.int32)
    contexts = rs.randint(0, v, b).astype(np.int32)
    negs = rs.randint(0, v, (b, k)).astype(np.int32)
    j0, j1, jl = JW._sgns_step(syn0.copy(), syn1.copy(), centers, contexts, negs, 0.05)
    t0, t1 = _t(syn0.copy()), _t(syn1.copy())
    loss = TW._sgns_math(t0, t1, _t(centers), _t(contexts), _t(negs), 0.05)
    _close(t0, j0)
    _close(t1, j1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_hs_step_matches_jax_under_collisions(seed):
    rs = np.random.RandomState(seed)
    v, d, b, depth = 12, 16, 128, 5
    syn0, syn1 = _tables(rs, v, d, rows1=v - 1)
    centers = rs.randint(0, v, b).astype(np.int32)
    points = rs.randint(0, v - 1, (b, depth)).astype(np.int32)
    codes = rs.randint(0, 2, (b, depth)).astype(np.float32)
    mask = (rs.rand(b, depth) < 0.7).astype(np.float32)
    j0, j1, jl = JW._hs_step(syn0.copy(), syn1.copy(), centers, points, codes, mask, 0.05)
    t0, t1 = _t(syn0.copy()), _t(syn1.copy())
    loss = TW._hs_math(t0, t1, _t(centers), _t(points), _t(codes), _t(mask), 0.05)
    _close(t0, j0)
    _close(t1, j1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_cbow_step_matches_jax_under_collisions(seed):
    rs = np.random.RandomState(seed)
    v, d, b, w, k = 12, 16, 128, 6, 3
    syn0, syn1 = _tables(rs, v, d)
    ctx = rs.randint(0, v, (b, w)).astype(np.int32)
    cmask = (rs.rand(b, w) < 0.6).astype(np.float32)
    ctx = np.where(cmask > 0, ctx, 0).astype(np.int32)  # padded slots point at row 0
    targets = rs.randint(0, v, b).astype(np.int32)
    negs = rs.randint(0, v, (b, k)).astype(np.int32)
    j0, j1, jl = JW._cbow_step(syn0.copy(), syn1.copy(), ctx, cmask, targets, negs, 0.05)
    t0, t1 = _t(syn0.copy()), _t(syn1.copy())
    loss = TW._cbow_math(t0, t1, _t(ctx), _t(cmask), _t(targets), _t(negs), 0.05)
    _close(t0, j0)
    _close(t1, j1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)


def test_touched_rows_update_equals_the_dense_form():
    """The scatter-mean on the touched rows only, through persistent
    scratch, equals the JAX package's dense ``table - lr*num/max(cnt,1)``
    to the bit, leaves untouched rows' bits alone and its scratch zeroed."""
    rs = np.random.RandomState(3)
    v, d = 20, 8
    table = rs.randn(v, d).astype(np.float32)
    idx = rs.randint(0, 6, 64)  # rows 6.. untouched
    grads = rs.randn(64, d).astype(np.float32)
    num = np.zeros_like(table)
    cnt = np.zeros(v, np.float32)
    np.add.at(num, idx, grads)
    np.add.at(cnt, idx, 1.0)
    want = table - np.float32(0.05) * num / np.maximum(cnt, 1.0)[:, None]
    t = _t(table.copy())
    scratch = TW.new_scratch(v, d)
    TW._scatter_mean_update(t, _t(idx), _t(grads), 0.05, scratch)
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(t.numpy()[6:], table[6:])
    assert not scratch[0].any() and not scratch[1].any()


# ---- _run_batched: one chunk, leftover batches, the ragged tail ----

def _pair_models(**kw):
    base = dict(vector_size=16, window=3, min_count=1, negative=4, epochs=1,
                learning_rate=0.05, batch_size=8, subsample=0, seed=5)
    base.update(kw)
    corpus = _toy_corpus(60, seed=2)
    j = JW.SequenceVectors(**base).build_vocab(corpus)
    t = TW.SequenceVectors(device="cpu", **base).build_vocab(corpus)
    return j, t


@pytest.mark.parametrize("algo", ["sgns", "hs", "cbow"])
def test_run_batched_chunk_matches_jax_scan(algo):
    """32 batches as one chunk (a JAX scanned call), then 3 full batches and
    a ragged one step by step, from the same tables and index arrays."""
    j, t = _pair_models(use_hierarchic_softmax=(algo == "hs"))
    rs = np.random.RandomState(7)
    v, bs, ck = len(j.vocab), j.batch_size, j.SCAN_CHUNK
    n = ck * bs + 3 * bs + 5
    syn0, syn1 = _tables(rs, v, 16, rows1=np.asarray(j.syn1).shape[0])
    j.syn0, j.syn1 = syn0.copy(), syn1.copy()
    TW.tables_from_numpy(t, syn0, syn1)
    if algo == "sgns":
        arrays = (rs.randint(0, v, n).astype(np.int32), rs.randint(0, v, n).astype(np.int32),
                  rs.randint(0, v, (n, 4)).astype(np.int32))
        jfns, tfn = (JW._sgns_epoch, JW._sgns_step, JW._sgns_math), TW._sgns_math
    elif algo == "hs":
        centers = rs.randint(0, v, n).astype(np.int32)
        arrays = (centers,) + j._huffman_batch(rs.randint(0, v, n))
        jfns, tfn = (JW._hs_epoch, JW._hs_step, JW._hs_math), TW._hs_math
    else:
        ctx = rs.randint(0, v, (n, 6)).astype(np.int32)
        cmask = (rs.rand(n, 6) < 0.7).astype(np.float32)
        arrays = (np.where(cmask > 0, ctx, 0).astype(np.int32), cmask,
                  rs.randint(0, v, n).astype(np.int32), rs.randint(0, v, (n, 4)).astype(np.int32))
        jfns, tfn = (JW._cbow_epoch, JW._cbow_step, JW._cbow_math), TW._cbow_math
    jl = j._run_batched(jfns[0], jfns[1], arrays, 0.05, math_fn=jfns[2])
    tl = t._run_batched(tfn, arrays, 0.05)
    assert len(tl) == len(jl) == ck + 4
    _close(t.syn0, j.syn0)
    _close(t.syn1, j.syn1)
    np.testing.assert_allclose([float(x) for x in tl], [float(x) for x in jl], rtol=RTOL)
    engine, = t._chunk_steps.values()
    assert engine.captures == 0 and engine.replays == 0  # the CPU runs it eagerly


def test_chunk_engine_is_one_per_algorithm_and_shape():
    _, t = _pair_models()
    rs = np.random.RandomState(1)
    v, n = len(t.vocab), t.SCAN_CHUNK * t.batch_size
    for _ in range(2):
        t._run_batched(TW._sgns_math, (rs.randint(0, v, n), rs.randint(0, v, n),
                                       rs.randint(0, v, (n, 4))), 0.05)
    t._run_batched(TW._sgns_math, (rs.randint(0, v, n), rs.randint(0, v, n),
                                   rs.randint(0, v, (n, 2))), 0.05)
    assert len(t._chunk_steps) == 2
    assert float(t._lr) == pytest.approx(0.05)


# ---- whole fits ----

def _host_negatives(model, seed):
    """Replace the model's negative draws with host alias draws from its own
    alias table and a RandomState(seed): the same indices in either package."""
    rs = np.random.RandomState(seed)
    model._draw_negatives = lambda shape: model._neg_alias.draw(rs, shape)
    return model


def _fit_pair(corpus, inject=True, **kw):
    j = JW.SequenceVectors(**kw)
    t = TW.SequenceVectors(device="cpu", **kw)
    if inject:
        for m in (j, t):
            m.build_vocab(corpus)
            _host_negatives(m, 99)
    j.fit(corpus)
    t.fit(corpus)
    return j, t


def _close_fit(j, t, atol):
    assert t.vocab.words() == j.vocab.words()
    np.testing.assert_allclose(t.syn0.numpy(), np.asarray(j.syn0), rtol=0, atol=atol)
    np.testing.assert_allclose(t.syn1.numpy(), np.asarray(j.syn1), rtol=0, atol=atol)
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=1e-5, atol=1e-6)


def test_hs_skipgram_fit_matches_jax():
    """Host RNG only: the whole fit, as is (measured: tables 3e-8, losses
    2e-7 apart)."""
    j, t = _fit_pair(_toy_corpus(200), inject=False, vector_size=16, window=3, min_count=1,
                     epochs=3, learning_rate=0.1, batch_size=128,
                     use_hierarchic_softmax=True, subsample=0, seed=2)
    assert len(t.loss_history) == len(j.loss_history) > 32
    _close_fit(j, t, atol=2e-6)


def test_sgns_fit_matches_jax_with_injected_negatives():
    """Measured: tables 2.4e-7, losses 7e-7 apart."""
    j, t = _fit_pair(_toy_corpus(300), vector_size=16, window=3, min_count=1, negative=4,
                     epochs=3, learning_rate=0.1, batch_size=128, subsample=0, seed=1)
    assert len(t.loss_history) > 32
    _close_fit(j, t, atol=2e-6)


def test_subsampled_sgns_fit_matches_jax():
    """With subsampling on (the host's keep draws) and the default window
    (measured: tables 3.6e-7, losses 5e-7 apart)."""
    corpus = _toy_corpus(300) + [["rare%d" % i] * 2 for i in range(6)]
    j, t = _fit_pair(corpus, vector_size=8, min_count=1, negative=3, epochs=2,
                     batch_size=16, subsample=0.05, seed=3)
    _close_fit(j, t, atol=2e-6)


def test_cbow_fit_matches_jax_with_injected_negatives():
    """Measured: tables 2e-9, losses 5e-7 apart."""
    j, t = _fit_pair(_toy_corpus(200), vector_size=16, window=3, min_count=1, negative=4,
                     epochs=3, learning_rate=0.1, batch_size=128, algorithm="cbow",
                     subsample=0, seed=3)
    _close_fit(j, t, atol=2e-6)


def test_word2vec_fit_sentences_and_iterator_match_jax():
    from deeplearning4j_tpu.text.corpus import CollectionSentenceIterator as JIt
    from deeplearning4j_tpu_torch.text.corpus import CollectionSentenceIterator as TIt
    sents = ["The cat sat on the mat.", "The dog ate my homework 42 times."] * 4
    kw = dict(vector_size=8, window=2, min_count=1, negative=2, epochs=2, seed=5,
              use_hierarchic_softmax=True)
    j = JW.Word2Vec(**kw).fit_sentences(sents)
    t = TW.Word2Vec(device="cpu", **kw).fit_sentences(sents)
    assert t.vocab.words() == j.vocab.words() and "42" not in t.vocab  # digits stripped
    _close(t.syn0, j.syn0, rtol=0, atol=1e-6)
    t2 = TW.Word2Vec(device="cpu", **kw).fit_iterator(TIt(sents))
    j2 = JW.Word2Vec(**kw).fit_iterator(JIt(sents))
    _close(t2.syn0, j2.syn0, rtol=0, atol=1e-6)


def test_query_api_returns_numpy_and_matches_jax():
    j, t = _fit_pair(_toy_corpus(100), inject=False, vector_size=8, window=2, min_count=1,
                     epochs=1, batch_size=64, use_hierarchic_softmax=True, subsample=0,
                     seed=4)
    v = t.get_word_vector("cat")
    assert isinstance(v, np.ndarray) and v.shape == (8,)
    assert t.get_word_vector("zebra") is None and np.isnan(t.similarity("cat", "zebra"))
    assert t.has_word("dog") and not t.has_word("zebra")
    assert t.similarity("cat", "dog") == pytest.approx(j.similarity("cat", "dog"), abs=1e-5)
    assert [w for w, _ in t.words_nearest("cat", 4)] == [w for w, _ in j.words_nearest("cat", 4)]
    assert t.words_nearest("zebra") == []


def test_sgns_learns_topic_structure_on_the_cpu_path():
    """The JAX test's toy-topic check, through the port's own device draws."""
    sv = TW.SequenceVectors(vector_size=16, window=3, min_count=1, negative=4, epochs=20,
                            learning_rate=0.1, batch_size=128, subsample=0, seed=1,
                            device="cpu")
    sv.fit(_toy_corpus())
    assert sv.similarity("cat", "dog") > sv.similarity("cat", "car") + 0.15
    assert sv.loss_history[-1] < sv.loss_history[0]


# ---- the device draws, tables, the step's capture contract ----

def test_device_alias_draws_follow_the_unigram_table():
    sv = TW.SequenceVectors(vector_size=4, min_count=1, seed=9, device="cpu")
    sv.build_vocab(_toy_corpus(100) + [["rare"]])
    negs = sv._draw_negatives((sv._NEG_CHUNK + 7, 3))
    assert negs.dtype == torch.int32 and tuple(negs.shape) == (sv._NEG_CHUNK + 7, 3)
    freq = np.bincount(negs.numpy().ravel(), minlength=len(sv.vocab)) / negs.numel()
    np.testing.assert_allclose(freq, sv._neg_table, atol=3e-3)
    again = TW.SequenceVectors(vector_size=4, min_count=1, seed=9, device="cpu")
    again.build_vocab(_toy_corpus(100) + [["rare"]])
    assert torch.equal(again._draw_negatives((10, 3)), negs[:10])  # seeded, chunked
    assert tuple(sv._draw_negatives((0, 3)).shape) == (0, 3)


def test_tables_from_numpy_installs_in_place():
    j, t = _pair_models()
    ptr = t.syn0.data_ptr()
    TW.tables_from_numpy(t, np.asarray(j.syn0), np.asarray(j.syn1))
    assert t.syn0.data_ptr() == ptr
    assert np.array_equal(t.syn0.numpy(), np.asarray(j.syn0))
    with pytest.raises(ValueError, match="shape"):
        TW.tables_from_numpy(t, np.zeros((3, 16), np.float32), np.asarray(j.syn1))
    with pytest.raises(ValueError, match="vocab"):
        TW.tables_from_numpy(TW.SequenceVectors(device="cpu"), np.zeros((1, 1)), np.zeros((1, 1)))


class _NoSync(TorchDispatchMode):
    banned = {"_local_scalar_dense", "nonzero", "masked_select", "item", "_unique2",
              "unique_dim", "_unique"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.banned:
            raise AssertionError(f"host sync in the step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("algo", ["sgns", "hs", "cbow"])
def test_chunk_runs_no_host_sync(algo):
    """What a card captures into one graph may not wait for the host."""
    _, t = _pair_models(use_hierarchic_softmax=(algo == "hs"))
    rs = np.random.RandomState(2)
    v, n = len(t.vocab), t.SCAN_CHUNK * t.batch_size
    if algo == "sgns":
        fn, arrays = TW._sgns_math, (rs.randint(0, v, n), rs.randint(0, v, n),
                                     rs.randint(0, v, (n, 4)))
    elif algo == "hs":
        fn, arrays = TW._hs_math, (rs.randint(0, v, n),) + t._huffman_batch(rs.randint(0, v, n))
    else:
        fn, arrays = TW._cbow_math, (rs.randint(0, v, (n, 6)), np.ones((n, 6), np.float32),
                                     rs.randint(0, v, n), rs.randint(0, v, (n, 4)))
    arrays = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    engine = t._chunk_engine(fn, arrays)
    t._lr.fill_(0.05)
    with _NoSync():
        losses = engine(t, arrays)
    assert tuple(losses.shape) == (t.SCAN_CHUNK,) and torch.isfinite(losses).all()


# ---- contracts ----

def test_trainers_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from deeplearning4j_tpu_torch.clustering import TSNE, BarnesHutTsne, KMeans
    from deeplearning4j_tpu_torch.graphlib import DeepWalk, Node2Vec
    from deeplearning4j_tpu_torch.text import GloVe, ParagraphVectors
    for make in (TW.SequenceVectors, TW.Word2Vec, ParagraphVectors, GloVe, DeepWalk,
                 Node2Vec, lambda: KMeans(3), TSNE, BarnesHutTsne):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
