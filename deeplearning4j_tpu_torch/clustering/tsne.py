"""t-SNE on the device, exact gradient.

The port of ``deeplearning4j_tpu/clustering/tsne.py`` (reference analog:
plot/BarnesHutTsne.java + plot/Tsne.java in the reference's
deeplearning4j-core). The EXACT O(N^2) gradient as dense matmuls on the
card; perplexity calibration by binary search on the host, early
exaggeration, momentum and per-dimension gains as in the standard t-SNE
recipe.

``dtype``: the JAX package's t-SNE follows ``jax_enable_x64`` (float32 for
its users); the port runs float32 by default, and ``dtype=torch.float64``
gives the JAX package's float64 runs.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.device import resolve_device


def _pairwise_sq_dists(x):
    x2 = torch.sum(x**2, dim=1)
    return x2[:, None] - 2.0 * x @ x.T + x2[None, :]


def _binary_search_perplexity(d2, perplexity, tol=1e-5, max_iter=50):
    """Per-row beta search for target entropy (host loop, vectorized rows)."""
    n = d2.shape[0]
    d2 = np.array(d2, copy=True)
    np.fill_diagonal(d2, 0.0)
    offdiag = 1.0 - np.eye(n)
    target = np.log(perplexity)
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    P = np.zeros((n, n))
    for _ in range(max_iter):
        p = np.exp(-d2 * beta[:, None]) * offdiag
        psum = np.maximum(p.sum(1), 1e-12)
        H = np.log(psum) + beta * (d2 * p).sum(1) / psum
        P = p / psum[:, None]
        diff = H - target
        done = np.abs(diff) < tol
        if done.all():
            break
        hi = diff > 0
        beta_min[hi & ~done] = beta[hi & ~done]
        beta_max[~hi & ~done] = beta[~hi & ~done]
        beta[hi & ~done] = np.where(np.isinf(beta_max[hi & ~done]),
                                    beta[hi & ~done] * 2,
                                    (beta[hi & ~done] + beta_max[hi & ~done]) / 2)
        beta[~hi & ~done] = np.where(np.isinf(beta_min[~hi & ~done]),
                                     beta[~hi & ~done] / 2,
                                     (beta[~hi & ~done] + beta_min[~hi & ~done]) / 2)
    return P


def _tsne_grad(y, P):
    """(gradient of KL(P||Q) at y, KL) for the Student-t Q of y."""
    d2 = _pairwise_sq_dists(y)
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(y.shape[0], dtype=y.dtype, device=y.device))
    Q = num / torch.sum(num).clamp_min(1e-12)
    PQ = (P - Q) * num
    grad = 4.0 * ((torch.diag(torch.sum(PQ, dim=1)) - PQ) @ y)
    kl = torch.sum(P * torch.log(P.clamp_min(1e-12) / Q.clamp_min(1e-12)))
    return grad, kl


class TSNE:
    def __init__(self, *, n_components=2, perplexity=30.0, learning_rate="auto",
                 n_iter=1000, early_exaggeration=12.0, exaggeration_iters=250,
                 momentum=0.5, final_momentum=0.8, seed=0, device="cuda",
                 dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.seed = seed

    def fit_transform(self, x):
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        d2 = _pairwise_sq_dists(self._tensor(x)).cpu().numpy().astype(np.float64)
        P = _binary_search_perplexity(d2, min(self.perplexity, (n - 1) / 3.0))
        P = (P + P.T) / (2.0 * n)
        P = np.maximum(P, 1e-12)
        return self._optimize(P)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _optimize(self, P):
        """Gradient descent with momentum + per-dimension adaptive gains (the
        standard van der Maaten stabilization; without gains the default
        learning rate diverges on well-separated data)."""
        n = P.shape[0]
        # sample-size-scaled step (the sklearn "auto" rule); a fixed big rate
        # diverges at small N
        lr = (max(n / self.early_exaggeration / 4.0, 50.0)
              if self.learning_rate == "auto" else self.learning_rate)
        rs = np.random.RandomState(self.seed)
        y = self._tensor(1e-4 * rs.randn(n, self.n_components))
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        P_dev = self._tensor(P)
        self.kl_history = []
        for it in range(self.n_iter):
            exag = self.early_exaggeration if it < self.exaggeration_iters else 1.0
            mom = self.momentum if it < self.exaggeration_iters else self.final_momentum
            grad, kl = _tsne_grad(y, P_dev * exag)
            same_dir = (grad > 0) == (vel > 0)
            gains = torch.where(same_dir, gains * 0.8, gains + 0.2).clamp_min(0.01)
            vel = mom * vel - lr * gains * grad
            y = y + vel
            y = y - torch.mean(y, dim=0)
            if it % 50 == 0:
                self.kl_history.append(float(kl))
        self.embedding_ = y.cpu().numpy()
        return self.embedding_


class BarnesHutTsne(TSNE):
    """Large-N t-SNE (reference: plot/BarnesHutTsne.java — theta-approximate
    gradient over SpTree/QuadTree, input similarities restricted to the
    3*perplexity nearest neighbors, VPTree-backed).

    As in the JAX package: the reference needed a C++ quadtree because its
    repulsive-force sum is O(N^2) pointer arithmetic on CPU. On the device
    the dense N^2 repulsion is the fast path (one matmul per iteration), so what
    survives of Barnes-Hut is the part that actually changes the asymptotics
    of the INPUT side: sparse attractive forces over the 3*perplexity nearest
    neighbors (exactly the reference's neighbor budget,
    BarnesHutTsne.java:459-605 pipeline). ``theta`` is accepted for API
    parity; it scales the neighbor budget (larger theta = coarser = fewer
    neighbors), and theta=0 degenerates to exact dense t-SNE like the
    reference's decomposed path (:459-460).
    """

    def __init__(self, *, theta=0.5, **kw):
        super().__init__(**kw)
        self.theta = float(theta)

    def fit_transform(self, x):
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if self.theta == 0.0 or n <= 64:
            return super().fit_transform(x)
        perp = min(self.perplexity, (n - 1) / 3.0)
        # reference neighbor budget: 3*perplexity; theta coarsens it
        k = int(min(n - 1, max(8, round(3.0 * perp / max(self.theta * 2, 1.0)))))

        # kNN on device: dense distance matrix -> top-k (one matmul; the
        # VPTree build/query of the reference collapses into this)
        d2 = _pairwise_sq_dists(self._tensor(x)).cpu().numpy().astype(np.float64)
        np.fill_diagonal(d2, np.inf)
        nbr = np.argpartition(d2, k, axis=1)[:, :k]          # [n, k]
        nd2 = np.take_along_axis(d2, nbr, axis=1)            # [n, k]

        # per-row beta search restricted to the neighbor set
        target = np.log(perp)
        beta = np.ones(n)
        bmin = np.full(n, -np.inf)
        bmax = np.full(n, np.inf)
        for _ in range(50):
            p = np.exp(-nd2 * beta[:, None])
            psum = np.maximum(p.sum(1), 1e-12)
            H = np.log(psum) + beta * (nd2 * p).sum(1) / psum
            diff = H - target
            if (np.abs(diff) < 1e-5).all():
                break
            hi = diff > 0
            bmin[hi] = beta[hi]
            bmax[~hi] = beta[~hi]
            beta[hi] = np.where(np.isinf(bmax[hi]), beta[hi] * 2,
                                (beta[hi] + bmax[hi]) / 2)
            beta[~hi] = np.where(np.isinf(bmin[~hi]), beta[~hi] / 2,
                                 (beta[~hi] + bmin[~hi]) / 2)
        p = np.exp(-nd2 * beta[:, None])
        p /= np.maximum(p.sum(1, keepdims=True), 1e-12)
        # symmetrize the sparse P into dense (device-friendly; memory O(N^2)
        # is fine to ~20k points in f32 HBM)
        P = np.zeros((n, n))
        np.put_along_axis(P, nbr, p, axis=1)
        P = (P + P.T) / (2.0 * n)
        P = np.maximum(P, 1e-12)
        return self._optimize(P)
