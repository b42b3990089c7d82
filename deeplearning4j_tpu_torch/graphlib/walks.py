"""Random-walk generators.

Reference analog: graph/iterator/RandomWalkIterator.java /
WeightedWalkIterator.java in the reference's deeplearning4j-graph.
"""

from __future__ import annotations

import numpy as np


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex."""

    def __init__(self, graph, walk_length, *, seed=0, no_edge_handling="self_loop"):
        self.graph = graph
        self.walk_length = walk_length
        self.rs = np.random.RandomState(seed)
        self.no_edge_handling = no_edge_handling

    def __iter__(self):
        for start in range(self.graph.n_vertices):
            yield self.walk_from(start)

    def walk_from(self, start):
        walk = [start]
        cur = start
        for _ in range(self.walk_length - 1):
            nbrs = self.graph.neighbors(cur)
            if not nbrs:
                if self.no_edge_handling == "self_loop":
                    walk.append(cur)
                    continue
                break
            cur = nbrs[self.rs.randint(len(nbrs))]
            walk.append(cur)
        return walk


class WeightedWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks."""

    def walk_from(self, start):
        walk = [start]
        cur = start
        for _ in range(self.walk_length - 1):
            nbrs = self.graph.neighbors_weighted(cur)
            if not nbrs:
                walk.append(cur)
                continue
            weights = np.array([w for _, w in nbrs])
            probs = weights / weights.sum()
            cur = nbrs[self.rs.choice(len(nbrs), p=probs)][0]
            walk.append(cur)
        return walk


class Node2VecWalkIterator(RandomWalkIterator):
    """Second-order biased walks (reference: models/node2vec/Node2Vec.java,
    which layers the Grover-Leskovec p/q sampling over SequenceVectors).

    Transition weight from walk step (t -> v) to candidate x:
      1/p if x == t (return), 1 if x is a neighbor of t (BFS-like),
      1/q otherwise (DFS-like).
    """

    def __init__(self, graph, walk_length, *, p=1.0, q=1.0, seed=0,
                 no_edge_handling="self_loop"):
        super().__init__(graph, walk_length, seed=seed,
                         no_edge_handling=no_edge_handling)
        self.p = float(p)
        self.q = float(q)

    def walk_from(self, start):
        walk = [start]
        prev = None
        cur = start
        for _ in range(self.walk_length - 1):
            nbrs = self.graph.neighbors(cur)
            if not nbrs:
                if self.no_edge_handling == "self_loop":
                    walk.append(cur)
                    continue
                break
            if prev is None:
                nxt = nbrs[self.rs.randint(len(nbrs))]
            else:
                prev_nbrs = set(self.graph.neighbors(prev))
                w = np.array([1.0 / self.p if x == prev
                              else (1.0 if x in prev_nbrs else 1.0 / self.q)
                              for x in nbrs])
                nxt = nbrs[self.rs.choice(len(nbrs), p=w / w.sum())]
            walk.append(nxt)
            prev, cur = cur, nxt
        return walk
