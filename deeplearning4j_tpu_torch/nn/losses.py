"""Loss-function catalog with per-example masking and label weights.

The same 12 functions under the same 15 catalog names as
``deeplearning4j_tpu/nn/losses.py``. Every loss takes ``(predictions,
labels, mask, weights)`` where predictions are the output layer's
post-activation values, and returns the scalar mean over (example, step)
rows. A mask ([batch] or [batch, time]) weights the rows and the mean is
divided by ``max(sum(mask), 1)``.

``mcxent`` is not ``F.cross_entropy`` on logits: it takes the log of
softmax probabilities clipped at 1e-8, so where the clip bites its
gradient is 0, as in the JAX package.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.utils import collectives as _collectives

_EPS = 1e-8


def _flatten_tail(x):
    """[B, ..., F] -> [B*, F] collapsing any time dims into batch."""
    return x.reshape(-1, x.shape[-1])


def _apply_mask_and_mean(per_example, mask):
    if mask is None:
        return per_example.mean()
    mask = mask.reshape(-1).to(per_example.dtype)
    # the global count of valid rows under a batch group (parallel/)
    return (per_example * mask).sum() / _collectives.masked_denominator(mask.sum())


def mse(pred, labels, mask=None, weights=None):
    d = (pred - labels) ** 2
    if weights is not None:
        d = d * weights
    return _apply_mask_and_mean(_flatten_tail(d).mean(dim=-1), mask)


def mae(pred, labels, mask=None, weights=None):
    d = (pred - labels).abs()
    if weights is not None:
        d = d * weights
    return _apply_mask_and_mean(_flatten_tail(d).mean(dim=-1), mask)


l1 = mae
l2 = mse


def xent(pred, labels, mask=None, weights=None):
    """Binary cross-entropy on sigmoid outputs."""
    p = pred.clamp(_EPS, 1.0 - _EPS)
    ce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    if weights is not None:
        ce = ce * weights
    return _apply_mask_and_mean(_flatten_tail(ce).sum(dim=-1), mask)


def mcxent(pred, labels, mask=None, weights=None):
    """Multi-class cross-entropy on softmax outputs (log of probabilities
    clipped at 1e-8)."""
    ce = -labels * torch.log(pred.clamp(_EPS, 1.0))
    if weights is not None:
        ce = ce * weights
    return _apply_mask_and_mean(_flatten_tail(ce).sum(dim=-1), mask)


negativeloglikelihood = mcxent


def sparse_mcxent(pred, labels, mask=None, weights=None):
    """mcxent with integer class labels."""
    flat = _flatten_tail(torch.log(pred.clamp(_EPS, 1.0)))
    idx = labels.reshape(-1).to(torch.int64)
    per = -torch.gather(flat, 1, idx[:, None])[:, 0]
    if weights is not None:
        per = per * weights.reshape(-1)
    return _apply_mask_and_mean(per, mask)


def hinge(pred, labels, mask=None, weights=None):
    """labels in {-1, +1}."""
    h = (1.0 - labels * pred).clamp_min(0.0)
    if weights is not None:
        h = h * weights
    return _apply_mask_and_mean(_flatten_tail(h).sum(dim=-1), mask)


def squared_hinge(pred, labels, mask=None, weights=None):
    h = (1.0 - labels * pred).clamp_min(0.0) ** 2
    if weights is not None:
        h = h * weights
    return _apply_mask_and_mean(_flatten_tail(h).sum(dim=-1), mask)


def kl_divergence(pred, labels, mask=None, weights=None):
    p = pred.clamp(_EPS, 1.0)
    q = labels.clamp(_EPS, 1.0)
    kl = labels * (torch.log(q) - torch.log(p))
    if weights is not None:
        kl = kl * weights
    return _apply_mask_and_mean(_flatten_tail(kl).sum(dim=-1), mask)


def cosine_proximity(pred, labels, mask=None, weights=None):
    pf, lf = _flatten_tail(pred), _flatten_tail(labels)
    pn = pf / (torch.linalg.vector_norm(pf, dim=-1, keepdim=True) + _EPS)
    ln = lf / (torch.linalg.vector_norm(lf, dim=-1, keepdim=True) + _EPS)
    return _apply_mask_and_mean(-(pn * ln).sum(dim=-1), mask)


def poisson(pred, labels, mask=None, weights=None):
    p = pred.clamp_min(_EPS)
    loss = p - labels * torch.log(p)
    if weights is not None:
        loss = loss * weights
    return _apply_mask_and_mean(_flatten_tail(loss).sum(dim=-1), mask)


def mean_squared_log_error(pred, labels, mask=None, weights=None):
    d = (torch.log1p(pred.clamp_min(0)) - torch.log1p(labels.clamp_min(0))) ** 2
    if weights is not None:
        d = d * weights
    return _apply_mask_and_mean(_flatten_tail(d).mean(dim=-1), mask)


def mean_absolute_percentage_error(pred, labels, mask=None, weights=None):
    d = 100.0 * ((labels - pred) / labels.abs().clamp_min(_EPS)).abs()
    if weights is not None:
        d = d * weights
    return _apply_mask_and_mean(_flatten_tail(d).mean(dim=-1), mask)


_CATALOG = {
    "mse": mse,
    "mae": mae,
    "l1": l1,
    "l2": l2,
    "xent": xent,
    "mcxent": mcxent,
    "sparse_mcxent": sparse_mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "cosine_proximity": cosine_proximity,
    "poisson": poisson,
    "mean_squared_log_error": mean_squared_log_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
}


def get(name):
    if callable(name):
        return name
    try:
        return _CATALOG[name.lower()]
    except KeyError:
        raise KeyError(f"Unknown loss {name!r}. Known: {sorted(_CATALOG)}") from None


def names():
    return sorted(_CATALOG)
