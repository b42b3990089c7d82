"""Graph file loading: the GraphLoader role.

Reference analog: org.deeplearning4j.graph.data.GraphLoader
(loadUndirectedGraphEdgeListFile, loadWeightedEdgeListFile, the
vertex+edge two-file form) — the reference's own TestGraphLoading /
TestGraphLoadingWeighted drive it against
deeplearning4j-graph/src/test/resources/{simplegraph,WeightedGraph,
test_graph_vertices,test_graph_edges}.txt; the same genuine files
validate this module. Comment lines start ``//`` in those fixtures;
``ignore_prefix`` mirrors the reference's ignoreLinesStartingWith.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.graphlib.graph import Graph


def _data_lines(path, ignore_prefix="//"):
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if line and not (ignore_prefix and
                             line.startswith(ignore_prefix)):
                yield lineno, line


def _vertex_id(raw, n_vertices, path, lineno):
    """int id, range-checked: a negative id would silently alias to a
    high-index vertex through Python list indexing."""
    v = int(raw)
    if not 0 <= v < n_vertices:
        raise ValueError(f"{path}:{lineno}: vertex id {v} outside "
                         f"[0, {n_vertices})")
    return v


def load_undirected_edge_list(path, n_vertices, *, delimiter=",",
                              ignore_prefix="//"):
    """``from,to`` lines -> undirected unweighted Graph
    (GraphLoader.loadUndirectedGraphEdgeListFile)."""
    g = Graph(n_vertices, directed=False)
    for lineno, line in _data_lines(path, ignore_prefix):
        a, b = line.split(delimiter)
        g.add_edge(_vertex_id(a, n_vertices, path, lineno),
                   _vertex_id(b, n_vertices, path, lineno))
    return g


def load_weighted_edge_list(path, n_vertices, *, delimiter=",",
                            directed=False, ignore_prefix="//"):
    """``from,to,weight`` lines -> weighted Graph
    (GraphLoader.loadWeightedEdgeListFile)."""
    g = Graph(n_vertices, directed=directed)
    for lineno, line in _data_lines(path, ignore_prefix):
        a, b, w = line.split(delimiter)
        g.add_edge(_vertex_id(a, n_vertices, path, lineno),
                   _vertex_id(b, n_vertices, path, lineno),
                   weight=float(w))
    return g


def load_graph(vertex_path, edge_path, *, delimiter=",",
               vertex_delimiter=":", directed=False, ignore_prefix="//"):
    """Two-file form (GraphLoader.loadGraph): a vertex file of
    ``index:label`` lines and an edge file of ``from,to`` lines.
    Returns (Graph, [label, ...]) with labels indexed by vertex id."""
    labels = {}
    for _, line in _data_lines(vertex_path, ignore_prefix):
        idx, label = line.split(vertex_delimiter, 1)
        labels[int(idx)] = label
    n = max(labels) + 1 if labels else 0
    if set(labels) != set(range(n)):
        missing = sorted(set(range(n)) - set(labels))
        raise ValueError(f"{vertex_path}: vertex ids not contiguous "
                         f"(missing {missing[:5]})")
    g = Graph(n, directed=directed)
    for lineno, line in _data_lines(edge_path, ignore_prefix):
        a, b = line.split(delimiter)
        g.add_edge(_vertex_id(a, n, edge_path, lineno),
                   _vertex_id(b, n, edge_path, lineno))
    return g, [labels[i] for i in range(n)]
