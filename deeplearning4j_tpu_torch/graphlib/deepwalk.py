"""DeepWalk graph embeddings.

The port of ``deeplearning4j_tpu/graphlib/deepwalk.py`` (reference analog:
graph/models/deepwalk/DeepWalk.java + GraphHuffman.java in the reference's
deeplearning4j-graph): random walks fed to skip-gram with hierarchical
softmax over a degree-based Huffman tree. The walks feed SequenceVectors
(the same reuse the reference makes of its word2vec core).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.graphlib.walks import (Node2VecWalkIterator,
                                                     RandomWalkIterator)
from deeplearning4j_tpu_torch.text.word2vec import SequenceVectors
from deeplearning4j_tpu_torch.utils.device import resolve_device


class DeepWalk:
    def __init__(self, *, vector_size=64, window=5, walk_length=40,
                 walks_per_vertex=10, learning_rate=0.05, epochs=3,
                 use_hierarchic_softmax=True, negative=5, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window = window
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.use_hs = use_hierarchic_softmax
        self.negative = negative
        self.seed = seed
        self.vectors = None

    def _walks(self, graph):
        walks = []
        for rep in range(self.walks_per_vertex):
            it = RandomWalkIterator(graph, self.walk_length, seed=self.seed + rep)
            for walk in it:
                walks.append([str(v) for v in walk])
        return walks

    def fit(self, graph):
        walks = self._walks(graph)
        self._sv = SequenceVectors(
            vector_size=self.vector_size, window=self.window, min_count=1,
            negative=0 if self.use_hs else self.negative,
            learning_rate=self.learning_rate, epochs=self.epochs,
            batch_size=1024, subsample=0,
            use_hierarchic_softmax=self.use_hs, seed=self.seed, device=self.device)
        self._sv.fit(walks)
        self.vectors = np.stack([
            self._sv.get_word_vector(str(v)) if self._sv.has_word(str(v))
            else np.zeros(self.vector_size, np.float32)
            for v in range(graph.n_vertices)])
        return self

    def get_vertex_vector(self, v):
        return self.vectors[v]

    def similarity(self, a, b):
        va, vb = self.vectors[a], self.vectors[b]
        return float(np.dot(va, vb) /
                     (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))


class Node2Vec(DeepWalk):
    """node2vec graph embeddings (reference: models/node2vec/Node2Vec.java —
    SequenceVectors over biased p/q walks). p controls return likelihood,
    q interpolates BFS (<1: outward/DFS-like) vs local (>1) exploration."""

    def __init__(self, *, p=1.0, q=1.0, **kw):
        super().__init__(**kw)
        self.p = float(p)
        self.q = float(q)

    def _walks(self, graph):
        walks = []
        for rep in range(self.walks_per_vertex):
            it = Node2VecWalkIterator(graph, self.walk_length, p=self.p,
                                      q=self.q, seed=self.seed + rep)
            for walk in it:
                walks.append([str(v) for v in walk])
        return walks
