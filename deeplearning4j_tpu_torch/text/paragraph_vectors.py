"""ParagraphVectors (doc2vec).

The port of ``deeplearning4j_tpu/text/paragraph_vectors.py`` (reference
analog: models/paragraphvectors/ParagraphVectors.java and the DBOW/DM
sequence learning algorithms in the reference's deeplearning4j-nlp).

PV-DBOW: the document vector predicts each word of the document (skip-gram
with the doc vector as "center"). PV-DM: mean of doc vector + context window
predicts the target. Both run the update functions of ``word2vec.py`` in
place; document vectors live in a separate table.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.text.word2vec import (SequenceVectors, _cbow_math, _host, _rows,
                                                    _sgns_math, new_scratch)
from deeplearning4j_tpu_torch.utils.device import as_device


def _infer_step(vec, syn1neg, targets, negatives, lr):
    """SGNS update of a single doc vector [1, D] against the FROZEN output
    table; returns the updated vector."""
    v = vec[0]                                     # [D]
    u_pos = _rows(syn1neg, targets)                # [T,D]
    u_neg = _rows(syn1neg, negatives)              # [T,K,D]
    s_pos = torch.sigmoid(u_pos @ v)
    s_neg = torch.sigmoid(u_neg @ v)
    grad = torch.mean((s_pos - 1.0)[:, None] * u_pos, dim=0) + \
        torch.mean(torch.bmm(s_neg.unsqueeze(1), u_neg).squeeze(1), dim=0)
    return vec - lr * grad[None, :]


class ParagraphVectors(SequenceVectors):
    def __init__(self, *, dm=False, tokenizer_factory=None, **kwargs):
        super().__init__(**kwargs)
        self.dm = dm
        from deeplearning4j_tpu_torch.text.tokenization import \
            default_tokenizer_factory
        self.tokenizer_factory = tokenizer_factory or \
            default_tokenizer_factory()
        self.doc_vectors = None
        self.doc_labels = []

    def fit_label_aware(self, iterator):
        """Train from any corpus LabelAwareIterator (reference:
        ParagraphVectors.Builder.iterate(LabelAwareIterator) — see
        text/corpus.py: Basic/Simple/File/Filenames/AsyncLabelAwareIterator
        + LabelsSource). Documents tokenize through the constructor's
        ``tokenizer_factory`` (same contract as Word2Vec)."""
        tf = self.tokenizer_factory
        docs = [(doc.label, tf.create(doc.content).get_tokens())
                for doc in iterator]
        return self.fit_documents(docs)

    def _scratch_for(self, rows):
        """The model's scratch, grown to at least ``rows`` rows."""
        if self._scratch[1].shape[0] < rows:
            self._scratch = new_scratch(rows, self.vector_size, device=self.device)
        return self._scratch

    def fit_documents(self, documents):
        """documents: list of (label, token list)."""
        if self.mesh is not None:
            raise ValueError(
                "ParagraphVectors doc-vector training is single-device (the "
                "per-document loop does not batch across the mesh); construct "
                "without mesh=. Word co-occurrence tables can still be "
                "pre-trained distributed via SequenceVectors(mesh=...).fit().")
        self.doc_labels = [label for label, _ in documents]
        seqs = [list(tokens) for _, tokens in documents]
        if self.vocab is None:
            self.build_vocab(seqs)
        n_docs, d = len(documents), self.vector_size
        rs = np.random.RandomState(self.seed + 1)
        self.doc_vectors = torch.from_numpy(
            (rs.rand(n_docs, d).astype(np.float32) - 0.5) / d).to(self.device)
        # doc rows, and under DM the [doc_vectors; syn0] rows
        scratch = self._scratch_for(n_docs + (len(self.vocab) if self.dm else 0))

        for epoch in range(self.epochs):
            lr = max(self.learning_rate * (1 - epoch / max(self.epochs, 1)),
                     self.min_learning_rate)
            for di, seq in enumerate(seqs):
                idx = self._encode(seq)
                if not idx:
                    continue
                targets = np.asarray(idx, np.int32)
                negs = self._draw_negatives((len(targets), self.negative))
                if self.dm:
                    self._dm_step(di, idx, lr, scratch)
                else:
                    docs = np.full(len(targets), di, np.int32)
                    _sgns_math(self.doc_vectors, self.syn1, as_device(docs, self.device),
                               as_device(targets, self.device), as_device(negs, self.device),
                               lr, scratch)
        return self

    def _dm_step(self, di, idx, lr, scratch):
        n = len(idx)
        W = 2 * self.window
        rows, masks, targets = [], [], []
        for pos in range(n):
            b = self._rs.randint(1, self.window + 1)
            window = [idx[pos + off] for off in range(-b, b + 1)
                      if off != 0 and 0 <= pos + off < n]
            row = np.zeros(W, np.int32)
            m = np.zeros(W, np.float32)
            row[:len(window)] = window
            m[:len(window)] = 1.0
            rows.append(row)
            masks.append(m)
            targets.append(idx[pos])
        targets = np.asarray(targets, np.int32)
        negs = self._draw_negatives((len(targets), self.negative))
        # combined table: [doc_vectors; syn0] — doc index = row di
        combined = torch.cat([self.doc_vectors, self.syn0])
        n_docs = self.doc_vectors.shape[0]
        ctx = np.stack(rows) + n_docs          # shift word indices
        ctx = np.concatenate([np.full((len(targets), 1), di, np.int32), ctx], axis=1)
        cmask = np.concatenate([np.ones((len(targets), 1), np.float32),
                                np.stack(masks)], axis=1)
        dev = self.device
        _cbow_math(combined, self.syn1, as_device(ctx, dev), as_device(cmask, dev),
                   as_device(targets, dev), as_device(negs, dev), lr, scratch)
        self.doc_vectors.copy_(combined[:n_docs])
        self.syn0.copy_(combined[n_docs:])

    def get_doc_vector(self, label):
        i = self.doc_labels.index(label)
        return _host(self.doc_vectors[i])

    def doc_similarity(self, l1, l2):
        a, b = self.get_doc_vector(l1), self.get_doc_vector(l2)
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    def infer_vector(self, tokens, steps=20, lr=0.05):
        """Infer a vector for an unseen document (frozen word tables)."""
        idx = self._encode(tokens)
        rs = np.random.RandomState(0)
        vec = torch.from_numpy((rs.rand(1, self.vector_size).astype(np.float32) - 0.5)
                               / self.vector_size).to(self.device)
        if not idx:
            return _host(vec[0])
        targets = as_device(np.asarray(idx, np.int32), self.device)
        for _ in range(steps):
            negs = self._draw_negatives((len(idx), self.negative))
            vec = _infer_step(vec, self.syn1, targets, as_device(negs, self.device), lr)
        return _host(vec[0])
