"""Bag-of-words / TF-IDF vectorizers.

Reference analog: bagofwords/vectorizer/ (BagOfWordsVectorizer,
TfidfVectorizer) in the reference's deeplearning4j-nlp module.
"""

from __future__ import annotations


import numpy as np

from deeplearning4j_tpu_torch.text.tokenization import CommonPreprocessor, DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabConstructor


class BagOfWordsVectorizer:
    def __init__(self, *, min_count=1, tokenizer_factory=None):
        self.min_count = min_count
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory(CommonPreprocessor())
        self.vocab = None

    def _tokenize(self, text):
        return self.tokenizer_factory.create(text).get_tokens()

    def fit(self, documents):
        seqs = [self._tokenize(d) for d in documents]
        self.vocab = VocabConstructor(self.min_count, build_huffman=False).build(seqs)
        return self

    def transform(self, documents):
        out = np.zeros((len(documents), len(self.vocab)), np.float32)
        for r, d in enumerate(documents):
            for t in self._tokenize(d):
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[r, i] += 1.0
        return out

    def fit_transform(self, documents):
        return self.fit(documents).transform(documents)


class TfidfVectorizer(BagOfWordsVectorizer):
    def fit(self, documents):
        super().fit(documents)
        n = len(documents)
        df = np.zeros(len(self.vocab), np.float64)
        for d in documents:
            seen = {self.vocab.index_of(t) for t in self._tokenize(d)}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        self.idf = np.log((n + 1.0) / (df + 1.0)) + 1.0
        return self

    def transform(self, documents):
        tf = super().transform(documents)
        return (tf * self.idf).astype(np.float32)
