"""Vocabulary construction + Huffman coding.

Reference analog: models/word2vec/wordstore/ (VocabCache,
AbstractCache, VocabConstructor) and the Huffman tree built for hierarchical
softmax (models/word2vec/Huffman.java, graph variant GraphHuffman.java) in
the reference's deeplearning4j-nlp module.
"""

from __future__ import annotations

import dataclasses as _dc
import heapq

import numpy as np


class VocabWord:
    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word, count=0, index=-1):
        self.word = word
        self.count = count
        self.index = index
        self.codes = []   # Huffman code bits
        self.points = []  # inner-node indices on the root path

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, idx={self.index})"


@_dc.dataclass
class FlatCorpus:
    """One np.unique pass over a whole corpus, shared by vocab construction
    and corpus encoding: tokens[i] == uniq[inverse[i]]."""
    uniq: object      # [U] distinct tokens (sorted)
    inverse: object   # [N] index into uniq per corpus token
    counts: object    # [U]
    lens: object      # [n_sequences] tokens per sequence


def flatten_corpus(sequences):
    """FlatCorpus for the token sequences, or None when the tokens are not
    amenable to np.unique (mixed types that don't order, tuple tokens that
    would form 2-D object arrays, ...) — callers then use dict-loop paths."""
    seqs = sequences if isinstance(sequences, (list, tuple)) else \
        list(sequences)
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    chunks = [np.asarray(s, object) for s in seqs if len(s)]
    if not chunks:
        z = np.zeros(0, object)
        return FlatCorpus(z, np.zeros(0, np.int64), np.zeros(0, np.int64),
                          lens)
    if any(c.ndim != 1 for c in chunks):
        return None  # tuple/sequence tokens became 2-D object arrays
    tokens = np.concatenate(chunks)
    try:
        uniq, inverse, counts = np.unique(tokens, return_inverse=True,
                                          return_counts=True)
    except TypeError:  # unorderable mixed token types
        return None
    return FlatCorpus(uniq, inverse, counts, lens)


class VocabCache:
    """Word <-> index bimap with counts (reference: AbstractCache)."""

    def __init__(self):
        self._words: dict[str, VocabWord] = {}
        self._by_index: list[VocabWord] = []

    def add(self, word, count=1):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word, 0)
            self._words[word] = vw
        vw.count += count
        return vw

    def finalize(self, min_count=1):
        """Prune rare words, assign indices by descending frequency."""
        kept = [w for w in self._words.values() if w.count >= min_count]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._words = {w.word: w for w in kept}
        self._by_index = kept
        for i, w in enumerate(kept):
            w.index = i
        return self

    def __contains__(self, word):
        return word in self._words

    def __len__(self):
        return len(self._by_index)

    def word_for(self, index):
        return self._by_index[index].word

    def index_of(self, word):
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def vocab_word(self, word):
        return self._words.get(word)

    def words(self):
        return [w.word for w in self._by_index]

    def counts(self):
        return np.array([w.count for w in self._by_index], np.int64)

    def total_count(self):
        return int(self.counts().sum())


def huffman_encode(vocab: VocabCache):
    """Assign Huffman codes/points for hierarchical softmax (reference:
    Huffman.java). Inner nodes are numbered 0..V-2."""
    v = len(vocab)
    if v < 2:
        return vocab
    counts = vocab.counts()
    # heap of (count, tiebreak, node_id); leaves 0..v-1, inner v..2v-2
    heap = [(int(counts[i]), i, i) for i in range(v)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = v
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        binary[n1] = 0
        binary[n2] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2]
    for i, vw in enumerate(vocab._by_index):
        codes, points = [], []
        node = i
        while node != root:
            codes.append(binary[node])
            points.append(parent[node] - v)  # inner-node index
            node = parent[node]
        vw.codes = codes[::-1]
        vw.points = points[::-1]
    return vocab


class VocabConstructor:
    """Build a VocabCache from an iterable of token sequences (reference:
    VocabConstructor.buildJointVocabulary). Counting runs through ONE
    np.unique pass over the flattened corpus when token types allow."""

    def __init__(self, min_count=5, build_huffman=True):
        self.min_count = min_count
        self.build_huffman = build_huffman

    def build(self, sequences) -> VocabCache:
        corpus = flatten_corpus(sequences)
        if corpus is not None:
            return self.build_from_counts(corpus.uniq, corpus.counts)
        # fallback: tokens not orderable/scalar (mixed types, tuples, ...)
        vocab = VocabCache()
        for seq in sequences:
            for tok in seq:
                vocab.add(tok)
        vocab.finalize(self.min_count)
        if self.build_huffman:
            huffman_encode(vocab)
        return vocab

    def build_from_counts(self, words, counts) -> VocabCache:
        """Build from precomputed (word, count) pairs — the flatten/unique
        pass is shared with corpus encoding (see flatten_corpus)."""
        vocab = VocabCache()
        for tok, cnt in zip(words, counts):
            vocab.add(tok, int(cnt))
        vocab.finalize(self.min_count)
        if self.build_huffman:
            huffman_encode(vocab)
        return vocab
