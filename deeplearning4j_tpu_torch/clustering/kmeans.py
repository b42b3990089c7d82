"""K-means clustering on the device.

The port of ``deeplearning4j_tpu/clustering/kmeans.py`` (reference analog:
clustering/kmeans/KMeansClustering.java in the reference's
nearestneighbor-core). Lloyd iterations run as one matmul for the
distances and one for the cluster sums; the kmeans++ initialisation runs on
the host from the seed's ``numpy.random.RandomState``.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.device import resolve_device


def _lloyd_step(points, centroids, k):
    """One Lloyd iteration: ``(new_centroids, assign, inertia)``; an empty
    cluster keeps its centroid."""
    # pairwise squared distances via (a-b)^2 = a^2 - 2ab + b^2 (one matmul)
    p2 = torch.sum(points**2, dim=1, keepdim=True)
    c2 = torch.sum(centroids**2, dim=1)
    d2 = p2 - 2.0 * points @ centroids.T + c2
    assign = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    counts = torch.sum(onehot, dim=0)
    sums = onehot.T @ points
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / counts[:, None].clamp_min(1.0),
                                centroids)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    return new_centroids, assign, inertia


class KMeans:
    def __init__(self, k, *, max_iterations=100, tol=1e-6, seed=0,
                 init="kmeans++", device="cuda"):
        self.device = resolve_device(device)
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.init = init
        self.centroids = None

    def _init_centroids(self, points, rs):
        n = len(points)
        if self.init == "random":
            return points[rs.choice(n, self.k, replace=False)]
        # kmeans++
        centroids = [points[rs.randint(n)]]
        for _ in range(1, self.k):
            d2 = np.min(np.stack([np.sum((points - c) ** 2, axis=1)
                                  for c in centroids]), axis=0)
            probs = d2 / max(d2.sum(), 1e-12)
            centroids.append(points[rs.choice(n, p=probs)])
        return np.stack(centroids)

    def fit(self, points):
        points = np.asarray(points, np.float32)
        rs = np.random.RandomState(self.seed)
        centroids = torch.from_numpy(self._init_centroids(points, rs)).to(self.device)
        pts = torch.from_numpy(points).to(self.device)
        prev_inertia = np.inf
        for it in range(self.max_iterations):
            centroids, assign, inertia = _lloyd_step(pts, centroids, self.k)
            inertia = float(inertia)  # the convergence test is a host decision each iteration
            if abs(prev_inertia - inertia) < self.tol * max(abs(prev_inertia), 1.0):
                break
            prev_inertia = inertia
        self.centroids = centroids.cpu().numpy()
        self.labels_ = assign.cpu().numpy()
        self.inertia_ = inertia
        self.n_iter_ = it + 1
        return self

    def predict(self, points):
        points = np.asarray(points, np.float32)
        d2 = (np.sum(points**2, 1, keepdims=True)
              - 2 * points @ self.centroids.T + np.sum(self.centroids**2, 1))
        return np.argmin(d2, axis=1)
