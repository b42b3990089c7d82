"""Vantage-point tree for exact nearest-neighbor search.

Reference analog: clustering/vptree/VPTree.java (608 LoC) in the reference's
deeplearning4j-nearestneighbors-parent/nearestneighbor-core. Host-side
structure (tree construction is pointer-chasing, not device work); the distance
evaluations inside search use vectorized numpy over candidate sets.
"""

from __future__ import annotations

import heapq

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index):
        self.index = index
        self.threshold = 0.0
        self.inside = None
        self.outside = None


class VPTree:
    def __init__(self, points, *, distance="euclidean", seed=0):
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        self._rs = np.random.RandomState(seed)
        idx = np.arange(len(self.points))
        self.root = self._build(idx)

    def _dist(self, a, b_many):
        if self.distance == "euclidean":
            return np.sqrt(np.sum((b_many - a) ** 2, axis=-1))
        if self.distance == "cosine":
            an = a / (np.linalg.norm(a) + 1e-12)
            bn = b_many / (np.linalg.norm(b_many, axis=-1, keepdims=True) + 1e-12)
            return 1.0 - bn @ an
        if self.distance == "manhattan":
            return np.sum(np.abs(b_many - a), axis=-1)
        raise ValueError(self.distance)

    def _build(self, idx):
        if len(idx) == 0:
            return None
        vp_pos = self._rs.randint(len(idx))
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        node = _Node(vp)
        if len(rest) == 0:
            return node
        d = self._dist(self.points[vp], self.points[rest])
        med = np.median(d)
        node.threshold = float(med)
        node.inside = self._build(rest[d <= med])
        node.outside = self._build(rest[d > med])
        return node

    def knn(self, query, k=1):
        """Returns (indices, distances) of the k nearest neighbors."""
        query = np.asarray(query, np.float64)
        heap = []  # max-heap of (-dist, idx)
        tau = [np.inf]

        def search(node):
            if node is None:
                return
            d = float(self._dist(query, self.points[node.index][None])[0])
            if d < tau[0] or len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                search(node.inside)
                if d + tau[0] > node.threshold:
                    search(node.outside)
            else:
                search(node.outside)
                if d - tau[0] <= node.threshold:
                    search(node.inside)

        search(self.root)
        pairs = sorted((-nd, i) for nd, i in heap)
        return [i for _, i in pairs], [d for d, _ in pairs]
