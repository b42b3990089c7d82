"""GloVe embeddings.

The port of ``deeplearning4j_tpu/text/glove.py`` (reference analog:
models/glove/Glove.java and the co-occurrence counting of models/glove/count/
in the reference's deeplearning4j-nlp). Weighted least squares on log
co-occurrence with AdaGrad, batched over the sparse co-occurrence entries as
index arrays: the co-occurrence counting runs on the host, the steps are
gathers and ``index_add_`` on the device.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from deeplearning4j_tpu_torch.text.vocab import VocabConstructor
from deeplearning4j_tpu_torch.text.word2vec import _host
from deeplearning4j_tpu_torch.utils.device import as_device, resolve_device
from deeplearning4j_tpu_torch.utils.hostsync import fetch_losses


def _glove_step(w, wc, b, bc, gw, gwc, gb, gbc, rows, cols, logx, weight, lr):
    """One AdaGrad step on a batch of co-occurrence entries, in place;
    returns the loss. Every duplicate's squared gradient is added to the
    accumulators first, then each update is scaled by the accumulated value
    at its row (the JAX package's order); duplicates' updates add up."""
    rows, cols = rows.long(), cols.long()
    wi = w.index_select(0, rows)
    wj = wc.index_select(0, cols)
    bi = b.index_select(0, rows)
    bj = bc.index_select(0, cols)
    diff = torch.sum(wi * wj, dim=1) + bi + bj - logx
    wdiff = weight * diff
    loss = 0.5 * torch.mean(wdiff * diff)

    grad_wi = wdiff[:, None] * wj
    grad_wj = wdiff[:, None] * wi

    # AdaGrad accumulators
    gw.index_add_(0, rows, grad_wi**2)
    gwc.index_add_(0, cols, grad_wj**2)
    gb.index_add_(0, rows, wdiff**2)
    gbc.index_add_(0, cols, wdiff**2)

    w.index_add_(0, rows, -lr * grad_wi / torch.sqrt(gw.index_select(0, rows) + 1e-8))
    wc.index_add_(0, cols, -lr * grad_wj / torch.sqrt(gwc.index_select(0, cols) + 1e-8))
    b.index_add_(0, rows, -lr * wdiff / torch.sqrt(gb.index_select(0, rows) + 1e-8))
    bc.index_add_(0, cols, -lr * wdiff / torch.sqrt(gbc.index_select(0, cols) + 1e-8))
    return loss


class GloVe:
    def __init__(self, *, vector_size=50, window=5, min_count=1, x_max=100.0,
                 alpha=0.75, learning_rate=0.05, epochs=25, batch_size=4096,
                 seed=123, device="cuda"):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window = window
        self.min_count = min_count
        self.x_max = x_max
        self.alpha = alpha
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.vocab = None

    def fit(self, sequences):
        seq_list = [list(s) for s in sequences]
        self.vocab = VocabConstructor(self.min_count, build_huffman=False).build(seq_list)
        v, d = len(self.vocab), self.vector_size

        # co-occurrence with 1/distance weighting (standard GloVe counting)
        cooc = collections.defaultdict(float)
        for seq in seq_list:
            idx = [self.vocab.index_of(t) for t in seq]
            idx = [i for i in idx if i >= 0]
            for pos, wi in enumerate(idx):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(idx):
                        break
                    cooc[(wi, idx[j])] += 1.0 / off
                    cooc[(idx[j], wi)] += 1.0 / off

        entries = np.array([(r, c, x) for (r, c), x in cooc.items()], np.float64)
        rows = entries[:, 0].astype(np.int32)
        cols = entries[:, 1].astype(np.int32)
        x = entries[:, 2]
        logx = np.log(x).astype(np.float32)
        weight = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(np.float32)

        rs = np.random.RandomState(self.seed)
        scale = 0.5 / d
        dev = self.device
        w = torch.from_numpy(rs.uniform(-scale, scale, (v, d)).astype(np.float32)).to(dev)
        wc = torch.from_numpy(rs.uniform(-scale, scale, (v, d)).astype(np.float32)).to(dev)
        b, bc, gb, gbc = (torch.zeros(v, dtype=torch.float32, device=dev) for _ in range(4))
        gw, gwc = (torch.zeros((v, d), dtype=torch.float32, device=dev) for _ in range(2))
        entries = [as_device(a, dev) for a in (rows, cols, logx, weight)]

        self.loss_history = []  # reset up front: a mid-fit failure must not
        losses = []             # leave a previous fit's history behind
        n = len(rows)
        for epoch in range(self.epochs):
            perm = as_device(rs.permutation(n), dev)
            for i in range(0, n, self.batch_size):
                sl = perm[i:i + self.batch_size]
                losses.append(_glove_step(w, wc, b, bc, gw, gwc, gb, gbc,
                                          *(a[sl] for a in entries),
                                          self.learning_rate))  # stays on the device
        self.loss_history = fetch_losses(losses)
        self.syn0 = w + wc  # standard GloVe: sum of word+context vectors
        return self

    def get_word_vector(self, word):
        i = self.vocab.index_of(word)
        return None if i < 0 else _host(self.syn0[i])

    def similarity(self, w1, w2):
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        if a is None or b is None:
            return float("nan")
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
