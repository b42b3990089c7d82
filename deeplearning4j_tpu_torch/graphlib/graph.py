"""Graph API.

Reference analog: the reference's deeplearning4j-graph module
(org/deeplearning4j/graph/) — IGraph/Graph adjacency-list API
used by DeepWalk.
"""

from __future__ import annotations



class Graph:
    """Adjacency-list graph with optional edge weights."""

    def __init__(self, n_vertices, directed=False):
        self.n_vertices = n_vertices
        self.directed = directed
        self._adj = [[] for _ in range(n_vertices)]      # list of (dst, weight)

    def add_edge(self, a, b, weight=1.0):
        self._adj[a].append((b, float(weight)))
        if not self.directed:
            self._adj[b].append((a, float(weight)))

    def neighbors(self, v):
        return [d for d, _ in self._adj[v]]

    def neighbors_weighted(self, v):
        return list(self._adj[v])

    def degree(self, v):
        return len(self._adj[v])

    def num_edges(self):
        total = sum(len(a) for a in self._adj)
        return total if self.directed else total // 2
