"""The port's NLP tier beside ``text/word2vec.py`` against the JAX
package's, on the CPU: the copied host modules (tokenizers and CJK
analyzers, vocab and Huffman coding, corpus iterators, bag-of-words, the
word-vector files) must give identical results; the ported trainers
(ParagraphVectors, GloVe) and their steps are held on the same numpy
inputs at the tolerances stated beside each test.

* Tokens: every golden string of the JAX package's tests
  (``test_text.py``, ``test_cjk_heldout.py``) through every factory it is
  tested with, plus the n-gram factory: identical token lists.
* Vocab: words, counts, Huffman codes and points identical (the
  hierarchical softmax indexes syn1 by the points).
* Steps: ``_infer_step`` and ``_glove_step`` with index collisions at f32
  rtol 1e-5 / atol 1e-7.
* Fits: PV-DBOW, PV-DM and ``infer_vector`` with both packages'
  ``_draw_negatives`` replaced by the same host alias draws; GloVe as is
  (host RNG only). Tolerances are about 10x the measured difference.
* Files written by either package load in the other.
"""

import io
import os
import types

import numpy as np
import pytest
import torch

import test_cjk_heldout as heldout
from deeplearning4j_tpu.text import bow as jbow
from deeplearning4j_tpu.text import corpus as jcorpus
from deeplearning4j_tpu.text import glove as JG
from deeplearning4j_tpu.text import ja_lattice as jja
from deeplearning4j_tpu.text import languages as jlang
from deeplearning4j_tpu.text import paragraph_vectors as JPV
from deeplearning4j_tpu.text import serializer as jser
from deeplearning4j_tpu.text import tokenization as jtok
from deeplearning4j_tpu.text import vocab as jvocab
from deeplearning4j_tpu.text import word2vec as JW
from deeplearning4j_tpu.text import zh_lattice as jzh
from deeplearning4j_tpu_torch.text import bow as tbow
from deeplearning4j_tpu_torch.text import corpus as tcorpus
from deeplearning4j_tpu_torch.text import glove as TG
from deeplearning4j_tpu_torch.text import ja_lattice as tja
from deeplearning4j_tpu_torch.text import languages as tlang
from deeplearning4j_tpu_torch.text import paragraph_vectors as TPV
from deeplearning4j_tpu_torch.text import serializer as tser
from deeplearning4j_tpu_torch.text import tokenization as ttok
from deeplearning4j_tpu_torch.text import vocab as tvocab
from deeplearning4j_tpu_torch.text import word2vec as TW
from deeplearning4j_tpu_torch.text import zh_lattice as tzh
from deeplearning4j_tpu_torch.utils.hostsync import fetch_losses

JAX = types.SimpleNamespace(tok=jtok, lang=jlang, ja=jja, zh=jzh, vocab=jvocab,
                            corpus=jcorpus, bow=jbow, ser=jser)
PORT = types.SimpleNamespace(tok=ttok, lang=tlang, ja=tja, zh=tzh, vocab=tvocab,
                             corpus=tcorpus, bow=tbow, ser=tser)


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


# ---- tokens ----

FACTORIES = {
    "default": lambda m: m.tok.DefaultTokenizerFactory(),
    "common": lambda m: m.tok.DefaultTokenizerFactory(m.tok.CommonPreprocessor()),
    "ngram": lambda m: m.tok.NGramTokenizerFactory(1, 3, m.tok.CommonPreprocessor()),
    "stemming": lambda m: m.tok.DefaultTokenizerFactory(m.tok.StemmingPreprocessor()),
    "uima": lambda m: m.tok.UimaTokenizerFactory(m.tok.CommonPreprocessor()),
    "zh": lambda m: m.lang.ChineseTokenizerFactory(),
    "zh_bare": lambda m: m.lang.ChineseTokenizerFactory(mode="maxmatch",
                                                        use_default_lexicon=False),
    "zh_lex": lambda m: m.lang.ChineseTokenizerFactory(mode="maxmatch", use_default_lexicon=False,
                                                       lexicon=["北京", "天安门"]),
    "ja": lambda m: m.lang.JapaneseTokenizerFactory(),
    "ja_bare": lambda m: m.lang.JapaneseTokenizerFactory(use_default_lexicon=False),
    "ja_maxmatch": lambda m: m.lang.JapaneseTokenizerFactory(use_default_lexicon=False,
                                                             mode="maxmatch"),
    "ja_lex": lambda m: m.lang.JapaneseTokenizerFactory(lexicon=["深層学習"]),
    "ko": lambda m: m.lang.KoreanTokenizerFactory(),
    "ko_emit": lambda m: m.lang.KoreanTokenizerFactory(emit_josa=True),
    "ko_raw": lambda m: m.lang.KoreanTokenizerFactory(strip_josa=False),
    "ko_lex": lambda m: m.lang.KoreanTokenizerFactory(lexicon=["한국", "사람"]),
    "ko_morpheme": lambda m: m.lang.KoreanTokenizerFactory(morpheme=True),
    "zh_numq": lambda m: m.lang.ChineseTokenizerFactory(merge_num_quantifier=True),
}

FACTORY_CASES = [
    ("common", "Hello, World! 123 foo"), ("default", "a b c"),
    ("ngram", "The quick brown fox, 42 jumps."), ("common", "The cat sat on the mat."),
    ("stemming", "the cats were running"), ("stemming", "a cat runs daily"),
    ("uima", "First one. Second two!"),
    ("zh", "我爱北京天安门"), ("zh_bare", "我爱北京天安门"), ("zh_lex", "我爱北京天安门"),
    ("zh", "我们在学校"), ("zh", "你好，世界！"), ("zh", "北京 是 中国 首都"),
    ("ja", "東京にいるトヨタ"), ("ja_bare", "山川にいる"), ("ja_maxmatch", "肉を食べた"),
    ("ja", "私は学生です"), ("ja_lex", "深層学習の本"),
    ("ko", "학교에"), ("ko", "학교는"), ("ko_emit", "학교는"), ("ko_raw", "학교는"),
    ("ko", "한국어 토큰 test 123"), ("ko_lex", "한국사람"), ("ko_lex", "한국사람은"),
    ("ko", "학교에서"), ("ko", "선생님께서"), ("ko", "친구를 만났어요"), ("ko", "학교에서는"),
    ("ko", "친구에게도"), ("ko", "바나나"), ("ko", "조랑말가"), ("ko_emit", "먹었어요"),
    ("ko", "한국어"), ("ko", "세계 최초의 상용 수준 오픈소스 딥러닝 라이브러리입니다"),
] + [("ko", e) for e in ("먹었어요", "갔습니다", "공부했어요", "좋아합니다", "만났어요",
                         "마셨어요", "예뻤다", "봤습니다", "재미있었어요")] \
  + [("ko", s) for s in heldout.TestKoreanHeldOut.CASES] \
  + [("ko_morpheme", s) for s in ["세계 최초의 상용 수준 오픈소스 딥러닝 라이브러리입니다",
                                  *heldout.TestKoreanHeldOut.CASES]] \
  + [("zh_numq", s) for s in ["他每天早上七点起床", "我买了三个苹果"]]


@pytest.mark.parametrize("factory,text", FACTORY_CASES)
def test_factory_tokens_identical(factory, text):
    want = FACTORIES[factory](JAX).create(text).get_tokens()
    assert FACTORIES[factory](PORT).create(text).get_tokens() == want


JA_LATTICE = ["私は学生です", "東京に行きました", "猫が魚を食べた", "彼女は本を読んでいます",
              "今日はとても暑いですね", "データを使って新しいモデルを作りました",
              "日本で働いています", "問題がありました", "ありがとうございます",
              "先生と学生が学校で話しています", "ラーメンを食べた", "GPT4は強い", "", "   ",
              "深層学習は難しい"] + list(heldout.TestJapaneseHeldOut.CASES)
ZH_LATTICE = ["我爱北京天安门", "我们在学校学习汉语", "他买了三本书", "今天天气很好",
              "因为下雨所以我没去", "这个问题很复杂", "我吃了两碗米饭", "王小明是我的朋友",
              "我有2个GPU", "青山绿水和伟大的科学家让世界更美好和平"] \
    + list(heldout.TestChineseHeldOut.CASES)


@pytest.mark.parametrize("text", JA_LATTICE)
def test_ja_lattice_tokens_identical(text):
    assert PORT.ja.tokenize(text) == JAX.ja.tokenize(text)


@pytest.mark.parametrize("text", ZH_LATTICE)
def test_zh_lattice_tokens_identical(text):
    assert PORT.zh.tokenize(text) == JAX.zh.tokenize(text)


@pytest.mark.parametrize("lattice,text,entries", [
    ("ja", "深層学習は難しい", ["深層学習"]), ("zh", "深度学习模型", ["深度学习"])])
def test_lattice_user_entries_identical(lattice, text, entries):
    got = getattr(PORT, lattice).tokenize(text, user_entries=entries)
    assert got == getattr(JAX, lattice).tokenize(text, user_entries=entries)
    assert entries[0] in got


@pytest.mark.parametrize("text", ["今日は晴れ。明日は雨？ Yes! It works.", "彼は「行く。」と言った。"])
def test_sentence_splitting_identical(text):
    assert PORT.lang.split_sentences(text) == JAX.lang.split_sentences(text)


def test_porter_stems_identical():
    words = ["caresses", "ponies", "cats", "feed", "agreed", "plastered", "motoring", "sing",
             "running", "happy", "sky", "relational", "conditional", "hopeful", "goodness",
             "adjustable", "formalize", "probate", "hopefulness", "he" + "y" * 5000]
    js, ts = jtok.StemmingPreprocessor(), ttok.StemmingPreprocessor()
    assert [ts.stem(w) for w in words] == [js.stem(w) for w in words]


def test_ansj_core_dic_default_names_the_reference_pack():
    assert PORT.zh.ANSJ_CORE_DIC.endswith(
        "deeplearning4j-nlp-chinese/src/main/resources/core.dic")
    assert PORT.zh.ANSJ_CORE_DIC.split("deeplearning4j-nlp-parent")[1] == \
        JAX.zh.ANSJ_CORE_DIC.split("deeplearning4j-nlp-parent")[1]


@pytest.fixture
def ansj_core_dic():
    if not os.path.exists(JAX.zh.ANSJ_CORE_DIC):
        pytest.skip("the reference's nlp-chinese pack (core.dic) is not present")
    return JAX.zh.ANSJ_CORE_DIC


def test_ansj_core_dic_loads_and_segments_identically(ansj_core_dic):
    """The reference pack's genuine dictionary, where it is present."""
    jd, td = JAX.zh.load_ansj_core_dic(ansj_core_dic), PORT.zh.load_ansj_core_dic(ansj_core_dic)
    assert td[1] == jd[1] and td[0] == jd[0]
    for s in ZH_LATTICE:
        assert PORT.zh.tokenize(s, merged=td) == JAX.zh.tokenize(s, merged=jd)


# ---- vocab and Huffman coding ----

def _zipf_corpus(n_sent=200, v=300, seed=0):
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    return rs.choice(v, (n_sent, 12), p=p / p.sum()).tolist()


VOCAB_CORPORA = {
    "w_counts": lambda: [["w%d" % i] * (i + 1) for i in range(8)],
    "common_rare": lambda: [["common"] * 100, ["rare1"], ["rare2"], ["rare3"]],
    "toy": lambda: _toy_corpus(200),
    "zipf_ints": _zipf_corpus,
    "tuple_tokens": lambda: [[("a", 1), ("b", 2)], [("a", 1)]],  # not for np.unique: dict path
}


@pytest.mark.parametrize("name", sorted(VOCAB_CORPORA))
@pytest.mark.parametrize("min_count", [1, 2])
def test_vocab_and_huffman_paths_identical(name, min_count):
    seqs = VOCAB_CORPORA[name]()
    jv = jvocab.VocabConstructor(min_count=min_count).build(seqs)
    tv = tvocab.VocabConstructor(min_count=min_count).build(seqs)
    assert tv.words() == jv.words()
    assert np.array_equal(tv.counts(), jv.counts())
    for w in jv.words():
        assert tv.vocab_word(w).codes == jv.vocab_word(w).codes
        assert tv.vocab_word(w).points == jv.vocab_word(w).points
        assert tv.index_of(w) == jv.index_of(w)


def test_flatten_corpus_identical():
    seqs = _toy_corpus(50) + [[]]
    j, t = jvocab.flatten_corpus(seqs), tvocab.flatten_corpus(seqs)
    for field in ("uniq", "inverse", "counts", "lens"):
        assert np.array_equal(getattr(t, field), getattr(j, field))
    assert tvocab.flatten_corpus([[("a", 1)], [("b", 2)]]) is None


@pytest.mark.parametrize("use_hs", [False, True])
def test_word2vec_host_pipeline_identical(use_hs):
    """build_vocab's tables and the seeded host draws of one epoch: syn0's
    init, the alias table, the Huffman path tables, subsampling, pairs and
    CBOW windows."""
    corpus = _toy_corpus(80) + [["rare"]]
    kw = dict(vector_size=8, window=3, min_count=1, subsample=0.05, seed=4,
              use_hierarchic_softmax=use_hs)
    j = JW.SequenceVectors(**kw).build_vocab(corpus)
    t = TW.SequenceVectors(device="cpu", **kw).build_vocab(corpus)
    assert np.array_equal(t.syn0.numpy(), np.asarray(j.syn0))
    assert tuple(t.syn1.shape) == np.asarray(j.syn1).shape
    assert np.array_equal(t._neg_alias.prob, j._neg_alias.prob)
    assert np.array_equal(t._neg_alias.alias, j._neg_alias.alias)
    assert np.array_equal(t._keep_prob, j._keep_prob)
    if use_hs:
        for a in ("_hs_pts", "_hs_codes", "_hs_mask"):
            assert np.array_equal(getattr(t, a), getattr(j, a))
    flat = t._encode_corpus(corpus)
    assert all(np.array_equal(a, b) for a, b in zip(flat, j._encode_corpus(corpus)))
    for a, b in zip(t._pairs_from_corpus(*t._subsampled(*flat)),
                    j._pairs_from_corpus(*j._subsampled(*flat))):
        assert np.array_equal(a, b)
    for a, b in zip(t._cbow_windows_from_corpus(*flat), j._cbow_windows_from_corpus(*flat)):
        assert np.array_equal(a, b)


# ---- corpus iterators ----

def _files(tmp_path):
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "a.txt").write_text("s1\ns2\n", encoding="utf-8")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "b.txt").write_text("s3\n", encoding="utf-8")
    return tmp_path


ITERATORS = {
    "collection": lambda c, p: c.CollectionSentenceIterator(["  a b ", "c d"],
                                                           pre_processor=str.strip),
    "line": lambda c, p: c.LineSentenceIterator(str(_files(p) / "a.txt")),
    "stream": lambda c, p: c.StreamLineIterator(io.StringIO("x\ny\n")),
    "file": lambda c, p: c.FileSentenceIterator(str(_files(p))),
    "aggregating": lambda c, p: c.AggregatingSentenceIterator(
        [c.CollectionSentenceIterator(["a"]), c.CollectionSentenceIterator(["b", "c"])]),
    "epochs": lambda c, p: c.MultipleEpochsSentenceIterator(
        c.CollectionSentenceIterator(["a", "b"]), n_epochs=3),
    "prefetching": lambda c, p: c.PrefetchingSentenceIterator(
        c.CollectionSentenceIterator([f"s{i}" for i in range(100)]), buffer_size=8),
    "synchronized": lambda c, p: c.SynchronizedSentenceIterator(
        c.CollectionSentenceIterator([str(i) for i in range(20)])),
}


def _drain(it):
    out = [list(it)]
    it.reset()
    out.append(list(it))
    if hasattr(it, "finish"):
        it.finish()
    return out


@pytest.mark.parametrize("kind", sorted(ITERATORS))
def test_sentence_iterators_yield_the_same_sequences(kind, tmp_path):
    want = _drain(ITERATORS[kind](jcorpus, tmp_path / "j"))
    got = _drain(ITERATORS[kind](tcorpus, tmp_path / "t"))
    assert got == want and want[0]


def _label_files(root, flat):
    root.mkdir()
    for label, text in [("pos", "good"), ("neg", "bad")]:
        if flat:
            (root / f"doc_{label}.txt").write_text(text)
        else:
            (root / label).mkdir()
            (root / label / "doc0.txt").write_text(text)
    return str(root)


LABEL_ITERATORS = {
    "basic": lambda c, p: c.BasicLabelAwareIterator(
        c.CollectionSentenceIterator(["hello world", "foo bar"])),
    "simple": lambda c, p: c.SimpleLabelAwareIterator(
        [c.LabelledDocument("a", ["pos"]), c.LabelledDocument("b", ["neg"])]),
    "file": lambda c, p: c.FileLabelAwareIterator(_label_files(p, flat=False)),
    "filenames": lambda c, p: c.FilenamesLabelAwareIterator(_label_files(p, flat=True)),
    "async": lambda c, p: c.AsyncLabelAwareIterator(c.SimpleLabelAwareIterator(
        [c.LabelledDocument(f"d{i}", [f"L{i}"]) for i in range(50)]), buffer_size=4),
}


@pytest.mark.parametrize("kind", sorted(LABEL_ITERATORS))
def test_label_aware_iterators_yield_the_same_documents(kind, tmp_path):
    def docs(c, p):
        it = LABEL_ITERATORS[kind](c, p)
        out = [sorted((d.label, d.content) for d in it)]
        it.reset()
        out.append(sorted((d.label, d.content) for d in it))
        return out
    assert docs(tcorpus, tmp_path / "t") == docs(jcorpus, tmp_path / "j")


@pytest.mark.parametrize("source", ["SENT_", "DOC_%d_F", ["x", "y"]])
def test_labels_sources_identical(source):
    j, t = jcorpus.LabelsSource(source), tcorpus.LabelsSource(source)
    n = 2 if isinstance(source, list) else 3
    assert [t.next_label() for _ in range(n)] == [j.next_label() for _ in range(n)]
    assert t.get_labels() == j.get_labels()


# ---- bag of words ----

@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_identical(cls):
    docs = ["the cat sat", "the dog sat", "cars drive fast", "the cat and dog"]
    j = getattr(jbow, cls)(min_count=1)
    t = getattr(tbow, cls)(min_count=1)
    np.testing.assert_array_equal(t.fit_transform(docs), j.fit_transform(docs))
    assert t.vocab.words() == j.vocab.words()


# ---- word-vector files, across the packages ----

def _fit(pkg):
    kw = dict(vector_size=12, min_count=1, negative=2, epochs=1, seed=21, subsample=0,
              use_hierarchic_softmax=True)
    corpus = [["alpha", "beta", "gamma", "delta", "学校"] * 5] * 10
    sv = pkg.SequenceVectors(**kw) if pkg is JW else pkg.SequenceVectors(device="cpu", **kw)
    return sv.fit(corpus)


@pytest.mark.parametrize("fmt,path", [("text", "v.txt"), ("text", "v.txt.gz"),
                                      ("binary", "v.bin"), ("binary", "v.bin.gz")])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_word_vector_files_cross_packages(fmt, path, writer, tmp_path):
    model = _fit(JW if writer == "jax" else TW)
    w_ser, r_ser = (jser, tser) if writer == "jax" else (tser, jser)
    p = str(tmp_path / path)
    save, load = {"text": ("save_word_vectors", "load_word_vectors"),
                  "binary": ("save_word2vec_binary", "load_word2vec_binary")}[fmt]
    getattr(w_ser, save)(model, p)
    words, mat = getattr(r_ser, load)(p)
    assert words == model.vocab.words()
    np.testing.assert_allclose(mat, np.asarray(getattr(w_ser, "StaticWordVectors").load(p).matrix),
                               rtol=0, atol=0)
    np.testing.assert_allclose(mat[words.index("gamma")], model.get_word_vector("gamma"),
                               rtol=1e-4, atol=1e-5 if fmt == "text" else 0)
    wv = r_ser.StaticWordVectors.load(p)
    assert wv.similarity("gamma", "gamma") == pytest.approx(1.0)
    assert [w for w, _ in wv.words_nearest("alpha", 3)] == \
        [w for w, _ in w_ser.StaticWordVectors(words, mat).words_nearest("alpha", 3)]


# ---- ParagraphVectors ----

def test_infer_step_matches_jax_under_collisions():
    rs = np.random.RandomState(0)
    v, d, t, k = 10, 16, 64, 4
    syn1 = (rs.randn(v, d) * 0.3).astype(np.float32)
    vec = (rs.randn(1, d) * 0.1).astype(np.float32)
    targets = rs.randint(0, v, t).astype(np.int32)
    negs = rs.randint(0, v, (t, k)).astype(np.int32)
    want = JPV._infer_step(vec.copy(), syn1, targets, negs, 0.05)
    got = TPV._infer_step(torch.from_numpy(vec), torch.from_numpy(syn1),
                          torch.from_numpy(targets), torch.from_numpy(negs), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def _host_negatives(model, seed):
    rs = np.random.RandomState(seed)
    model._draw_negatives = lambda shape: model._neg_alias.draw(rs, shape)
    return model


def _docs(n=10, length=12):
    rs = np.random.RandomState(0)
    out = []
    for i in range(n):
        pool = ["cat", "dog", "pet"] if i % 2 == 0 else ["car", "road", "drive"]
        out.append((f"doc{i}", [pool[rs.randint(3)] for _ in range(length)]))
    return out


def _pv_pair(docs, **kw):
    base = dict(vector_size=12, min_count=1, negative=4, epochs=4, learning_rate=0.1,
                subsample=0, seed=7)
    base.update(kw)
    j = JPV.ParagraphVectors(**base)
    t = TPV.ParagraphVectors(device="cpu", **base)
    for m in (j, t):
        m.build_vocab([tokens for _, tokens in docs])
        _host_negatives(m, 11)
        m.fit_documents(docs)
    return j, t


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_fit_matches_jax(dm):
    """PV-DBOW (the SGNS step over [doc_vectors] and syn1) and PV-DM (the
    CBOW step over [doc_vectors; syn0]). Measured: 5e-10 apart (DBOW), 1e-9
    (DM)."""
    j, t = _pv_pair(_docs(), dm=dm, window=3)
    for a in ("doc_vectors", "syn0", "syn1"):
        np.testing.assert_allclose(getattr(t, a).numpy(), np.asarray(getattr(j, a)),
                                   rtol=0, atol=1e-8)
    assert t.doc_labels == j.doc_labels
    np.testing.assert_allclose(t.get_doc_vector("doc3"), j.get_doc_vector("doc3"), atol=1e-8)
    assert t.doc_similarity("doc0", "doc2") == pytest.approx(j.doc_similarity("doc0", "doc2"),
                                                             abs=1e-5)


def test_infer_vector_matches_jax():
    """20 steps against the frozen table, the same injected negatives
    (measured: equal to the bit)."""
    docs = [("d0", ["cat", "dog"] * 6), ("d1", ["car", "road"] * 6)]
    j, t = _pv_pair(docs, vector_size=8, negative=2, epochs=3)
    want = j.infer_vector(["cat", "dog", "cat"])
    got = t.infer_vector(["cat", "dog", "cat"])
    assert isinstance(got, np.ndarray) and got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(t.infer_vector(["zebra"]), j.infer_vector(["zebra"]))


def test_fit_label_aware_matches_jax():
    sents = ["cat dog pet cat dog", "car road drive car road"] * 3
    kw = dict(vector_size=8, min_count=1, negative=2, epochs=2, subsample=0, seed=2)
    models = []
    for pv, c in ((JPV, jcorpus), (TPV, tcorpus)):
        m = pv.ParagraphVectors(**kw) if pv is JPV else pv.ParagraphVectors(device="cpu", **kw)
        m.build_vocab([s.split() for s in sents])
        _host_negatives(m, 5)
        m.fit_label_aware(c.BasicLabelAwareIterator(c.CollectionSentenceIterator(sents)))
        models.append(m)
    j, t = models
    assert t.doc_labels == j.doc_labels and "SENT_5" in t.doc_labels
    np.testing.assert_allclose(t.doc_vectors.numpy(), np.asarray(j.doc_vectors), atol=1e-7)


# ---- GloVe ----

def test_glove_step_matches_jax_under_collisions():
    """Every duplicate's squared gradient lands in the AdaGrad
    accumulators before any update reads them."""
    rs = np.random.RandomState(0)
    v, d, b = 10, 8, 128
    tables = [(rs.randn(v, d) * 0.1).astype(np.float32) for _ in range(2)] + \
        [(rs.randn(v) * 0.1).astype(np.float32) for _ in range(2)] + \
        [rs.rand(v, d).astype(np.float32) for _ in range(2)] + \
        [rs.rand(v).astype(np.float32) for _ in range(2)]
    rows = rs.randint(0, v, b).astype(np.int32)
    cols = rs.randint(0, v, b).astype(np.int32)
    logx = rs.randn(b).astype(np.float32)
    weight = rs.rand(b).astype(np.float32)
    want = JG._glove_step(*[a.copy() for a in tables], rows, cols, logx, weight, 0.05)
    got = [torch.from_numpy(a.copy()) for a in tables]
    loss = TG._glove_step(*got, *(torch.from_numpy(a) for a in (rows, cols, logx, weight)),
                          0.05)
    for g, w in zip(got, want[:8]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(want[8]), rtol=1e-5)


def test_glove_fit_matches_jax():
    """Host RNG only (init, permutations). Measured: syn0 1.2e-7, losses
    4.8e-7 apart."""
    kw = dict(vector_size=12, window=3, min_count=1, epochs=6, learning_rate=0.05,
              batch_size=16, seed=10)
    j = JG.GloVe(**kw).fit(_toy_corpus(100))
    t = TG.GloVe(device="cpu", **kw).fit(_toy_corpus(100))
    assert len(t.loss_history) == len(j.loss_history) > 12
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.syn0.numpy(), np.asarray(j.syn0), rtol=0, atol=1e-6)
    assert t.similarity("cat", "dog") == pytest.approx(j.similarity("cat", "dog"), abs=1e-5)
    assert np.isnan(t.similarity("cat", "zebra")) and t.get_word_vector("zebra") is None


def test_fetch_losses_is_one_list_of_floats():
    assert fetch_losses([]) == []
    got = fetch_losses([torch.tensor(1.5), torch.tensor(2.0)])
    assert got == [1.5, 2.0] and all(isinstance(x, float) for x in got)
