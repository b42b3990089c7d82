"""The port's graph embeddings (``graphlib/``) and clustering
(``clustering/``) against the JAX package's, on the CPU.

* The copied host modules (graph, walks, loader, VP- and KD-trees, the
  nearest-neighbour server) give identical results on the same inputs.
* DeepWalk and Node2Vec train hierarchical-softmax skip-gram from host
  draws only (walks, windows, permutations), so whole fits are compared.
* ``_lloyd_step`` with tied and empty clusters and a whole KMeans fit
  (centroids, labels, inertia) in float32, as both packages run it.
* t-SNE: the JAX package's dtype follows ``jax_enable_x64``, which the JAX
  tests turn on (``tests/conftest.py``), so ``_tsne_grad`` and short runs
  of TSNE and BarnesHutTsne are compared with the port in float64
  (``dtype=torch.float64``); the port's float32 default, the JAX
  package's float32 for its users, is checked for the same structure.
Tolerances stand beside each test, about 10x the measured difference.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kdtree as jkd
from deeplearning4j_tpu.clustering import kmeans as JK
from deeplearning4j_tpu.clustering import tsne as JT
from deeplearning4j_tpu.clustering import vptree as jvp
from deeplearning4j_tpu.graphlib import deepwalk as JD
from deeplearning4j_tpu.graphlib import graph as jgraph
from deeplearning4j_tpu.graphlib import loader as jloader
from deeplearning4j_tpu.graphlib import walks as jwalks
from deeplearning4j_tpu_torch.clustering import kdtree as tkd
from deeplearning4j_tpu_torch.clustering import kmeans as TK
from deeplearning4j_tpu_torch.clustering import server as tserver
from deeplearning4j_tpu_torch.clustering import tsne as TT
from deeplearning4j_tpu_torch.clustering import vptree as tvp
from deeplearning4j_tpu_torch.graphlib import deepwalk as TD
from deeplearning4j_tpu_torch.graphlib import graph as tgraph
from deeplearning4j_tpu_torch.graphlib import loader as tloader
from deeplearning4j_tpu_torch.graphlib import walks as twalks


def _barbell(graph_mod, k=5, weighted=False):
    """Two k-cliques joined by one edge (weights i + j + 1 if weighted)."""
    g = graph_mod.Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j, weight=(i + j + 1) if weighted else 1.0)
    g.add_edge(k - 1, k)
    return g


# ---- graphs and walks ----

WALKS = {
    "uniform": lambda w, g: w.RandomWalkIterator(g, 10, seed=3),
    "weighted": lambda w, g: w.WeightedWalkIterator(g, 10, seed=3),
    "node2vec": lambda w, g: w.Node2VecWalkIterator(g, 10, p=4.0, q=0.25, seed=3),
    "no_edges_stop": lambda w, g: w.RandomWalkIterator(g, 6, seed=1, no_edge_handling="stop"),
}


@pytest.mark.parametrize("kind", sorted(WALKS))
def test_walks_identical(kind):
    jg, tg = _barbell(jgraph, weighted=True), _barbell(tgraph, weighted=True)
    if kind == "no_edges_stop":
        jg, tg = jgraph.Graph(3), tgraph.Graph(3)
        for g in (jg, tg):
            g.add_edge(0, 1)
    assert list(WALKS[kind](twalks, tg)) == list(WALKS[kind](jwalks, jg))


def test_graph_api_identical():
    jg, tg = _barbell(jgraph, weighted=True), _barbell(tgraph, weighted=True)
    assert tg.num_edges() == jg.num_edges()
    for v in range(jg.n_vertices):
        assert tg.neighbors_weighted(v) == jg.neighbors_weighted(v)
        assert tg.degree(v) == jg.degree(v)


@pytest.mark.parametrize("form", ["undirected", "weighted", "two_files", "bad_id"])
def test_loaders_identical(form, tmp_path):
    edges = tmp_path / "edges.txt"
    verts = tmp_path / "verts.txt"
    edges.write_text("// comment\n0,1\n1,2\n2,3\n3,0\n")
    if form == "weighted":
        edges.write_text("0,1,0.5\n1,2,2.0\n// c\n2,0,1.5\n")
    verts.write_text("0:v_0\n1:v_1\n2:v_2\n3:v_3\n")
    if form == "bad_id":
        edges.write_text("0,1\n4,10\n")
        for m in (jloader, tloader):
            with pytest.raises(ValueError, match="outside"):
                m.load_undirected_edge_list(str(edges), 10)
        return
    load = {"undirected": lambda m: (m.load_undirected_edge_list(str(edges), 4), None),
            "weighted": lambda m: (m.load_weighted_edge_list(str(edges), 3, directed=True),
                                   None),
            "two_files": lambda m: m.load_graph(str(verts), str(edges))}[form]
    (jg, jl), (tg, tl) = load(jloader), load(tloader)
    assert tl == jl and tg.directed == jg.directed
    assert [tg.neighbors_weighted(v) for v in range(tg.n_vertices)] == \
        [jg.neighbors_weighted(v) for v in range(jg.n_vertices)]


# ---- DeepWalk / Node2Vec ----

@pytest.mark.parametrize("cls", ["DeepWalk", "Node2Vec"])
def test_graph_embedding_fit_matches_jax(cls):
    """Hierarchical softmax (the default): host draws only. Measured: the
    vertex vectors 9e-10 (DeepWalk) and 1.9e-9 (Node2Vec) apart, the
    losses 1.2e-7."""
    kw = dict(vector_size=16, window=3, walk_length=12, walks_per_vertex=6, epochs=3,
              learning_rate=0.2, seed=4)
    if cls == "Node2Vec":
        kw.update(p=1.0, q=0.5)
    j = getattr(JD, cls)(**kw).fit(_barbell(jgraph))
    t = getattr(TD, cls)(device="cpu", **kw).fit(_barbell(tgraph))
    assert t.vectors.shape == (10, 16)
    np.testing.assert_allclose(t.vectors, j.vectors, rtol=0, atol=2e-8)
    np.testing.assert_allclose(t._sv.loss_history, j._sv.loss_history, rtol=1e-5, atol=1e-6)
    assert t.similarity(0, 1) == pytest.approx(j.similarity(0, 1), abs=1e-5)


def test_deepwalk_with_negative_sampling_runs_on_the_port():
    dw = TD.DeepWalk(vector_size=8, window=2, walk_length=8, walks_per_vertex=2, epochs=1,
                     use_hierarchic_softmax=False, negative=3, seed=1, device="cpu")
    dw.fit(_barbell(tgraph))
    assert np.isfinite(dw.vectors).all() and dw.get_vertex_vector(3).shape == (8,)


# ---- KMeans ----

def test_lloyd_step_matches_jax_with_an_empty_cluster():
    rs = np.random.RandomState(0)
    pts = np.concatenate([rs.randn(40, 3) + 5, rs.randn(40, 3) - 5]).astype(np.float32)
    cents = np.array([[5, 0, 0], [-5, 0, 0], [100, 100, 100]], np.float32)  # the last: empty
    jc, ja, ji = JK._lloyd_step(pts, cents, 3)
    tc, ta, ti = TK._lloyd_step(torch.from_numpy(pts), torch.from_numpy(cents), 3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert tc.numpy()[2].tolist() == [100, 100, 100]
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_fit_matches_jax(init):
    """Centroids, labels, inertia and iteration count (measured: centroids
    equal, inertia 7e-8 relative)."""
    rs = np.random.RandomState(0)
    pts = np.concatenate([rs.randn(50, 3) + [10, 0, 0], rs.randn(50, 3) + [-10, 0, 0],
                          rs.randn(50, 3) + [0, 10, 0]])
    j = JK.KMeans(3, seed=1, init=init).fit(pts)
    t = TK.KMeans(3, seed=1, init=init, device="cpu").fit(pts)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=0, atol=1e-6)
    assert t.inertia_ == pytest.approx(j.inertia_, rel=1e-6)
    assert t.n_iter_ == j.n_iter_
    np.testing.assert_array_equal(t.predict(pts), j.predict(pts))
    if init == "kmeans++":  # a random start may settle in a local optimum (both do)
        for sl in (slice(0, 50), slice(50, 100), slice(100, 150)):
            assert len(np.unique(t.labels_[sl])) == 1


# ---- t-SNE ----

def test_tsne_grad_matches_jax_in_float64():
    rs = np.random.RandomState(0)
    y = rs.randn(30, 2)
    p = rs.rand(30, 30)
    p = (p + p.T) / (2 * p.sum())
    jg, jkl = JT._tsne_grad(y, p)
    tg, tkl = TT._tsne_grad(torch.from_numpy(y), torch.from_numpy(p))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(tkl), float(jkl), rtol=1e-9)


def _clusters(n_each, seed=0):
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.randn(n_each, 10) + 8, rs.randn(n_each, 10) - 8])


@pytest.mark.parametrize("cls,n_each", [("TSNE", 20), ("BarnesHutTsne", 40)])
def test_tsne_run_matches_jax_in_float64(cls, n_each):
    """16 iterations across the exaggeration switch (at 6); BarnesHutTsne at
    N = 80 > 64 takes its sparse-attraction path. Measured: 2e-10
    (TSNE) and 3.9e-10 (BarnesHutTsne) apart. A longer run cannot be held
    in either dtype: under exaggeration the two packages' last-bit
    differences grow about tenfold every few iterations (4.5e-16 after one,
    8e-7 after 20, O(1) after 40 at N = 40), as two runs of either package
    would from inputs one ulp apart."""
    x = _clusters(n_each)
    kw = dict(perplexity=10, n_iter=16, exaggeration_iters=6, learning_rate=50, seed=3)
    j = getattr(JT, cls)(**kw)
    t = getattr(TT, cls)(device="cpu", dtype=torch.float64, **kw)
    jy, ty = j.fit_transform(x), t.fit_transform(x)
    assert ty.dtype == np.float64
    np.testing.assert_allclose(ty, jy, rtol=0, atol=4e-9)
    np.testing.assert_allclose(t.kl_history, j.kl_history, rtol=1e-12)


def test_tsne_float32_default_keeps_the_clusters():
    """The mean silhouette over the true clusters stays well above 0
    (measured 0.34-0.46 for seeds 3-5 in either dtype; the JAX test's gap >
    2 x spread is decided by last-bit chaos on this data)."""
    x = _clusters(30)
    t = TT.TSNE(perplexity=10, n_iter=300, learning_rate=50, seed=3, device="cpu")
    y = t.fit_transform(x)
    assert y.dtype == np.float32 and y.shape == (60, 2)
    d = np.sqrt(((y[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    lab = np.repeat([0, 1], 30)
    same = (lab[:, None] == lab[None, :]) & ~np.eye(60, dtype=bool)
    a = (d * same).sum(1) / same.sum(1)
    b = (d * (lab[:, None] != lab[None, :])).sum(1) / 30
    assert np.mean((b - a) / np.maximum(a, b)) > 0.25
    assert t.kl_history[-1] < t.kl_history[0]


# ---- trees, the nearest-neighbour server ----

@pytest.mark.parametrize("trees", [(jvp.VPTree, tvp.VPTree), (jkd.KDTree, tkd.KDTree)])
def test_trees_identical(trees):
    rs = np.random.RandomState(0)
    pts = rs.randn(200, 5)
    j, t = trees[0](pts), trees[1](pts)
    for _ in range(10):
        q = rs.randn(5)
        assert t.knn(q, k=5) == j.knn(q, k=5)


def test_nearest_neighbor_server_roundtrip():
    rs = np.random.RandomState(0)
    pts = rs.randn(50, 4)
    server = tserver.NearestNeighborServer(pts, port=0).start()
    try:
        idx, dist = tserver.NearestNeighborClient(port=server.port).knn(pts[7], k=3)
        assert idx[0] == 7 and dist[0] == pytest.approx(0.0, abs=1e-9)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/knn",
            data=json.dumps({"vector": pts[3].tolist(), "k": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["indices"][0] == 3
    finally:
        server.stop()
