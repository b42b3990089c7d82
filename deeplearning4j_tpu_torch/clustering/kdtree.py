"""KD-tree (reference: clustering/kdtree/KDTree.java in the reference's
deeplearning4j-nearestneighbors-parent/nearestneighbor-core)."""

from __future__ import annotations

import heapq

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index, axis):
        self.index = index
        self.axis = axis
        self.left = None
        self.right = None


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        self.root = self._build(np.arange(len(self.points)), 0)

    def _build(self, idx, depth):
        if len(idx) == 0:
            return None
        axis = depth % self.dims
        order = np.argsort(self.points[idx, axis], kind="stable")
        idx = idx[order]
        mid = len(idx) // 2
        node = _KDNode(int(idx[mid]), axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def knn(self, query, k=1):
        query = np.asarray(query, np.float64)
        heap = []

        def search(node):
            if node is None:
                return
            p = self.points[node.index]
            d = float(np.sqrt(np.sum((p - query) ** 2)))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = query[node.axis] - p[node.axis]
            near, far = (node.left, node.right) if diff <= 0 else (node.right, node.left)
            search(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                search(far)

        search(self.root)
        pairs = sorted((-nd, i) for nd, i in heap)
        return [i for _, i in pairs], [d for d, _ in pairs]

    def nearest(self, query):
        idx, dist = self.knn(query, 1)
        return idx[0], dist[0]
