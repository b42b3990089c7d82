"""Finite-difference gradient checker, the port of
``deeplearning4j_tpu/utils/gradcheck.py`` (reference: GradientCheckUtil).

Central differences per parameter in float64 against autograd, with the
relative error |analytic - numeric| / max(|analytic|, |numeric|) and an
absolute floor below which a parameter passes whatever its relative error
(the reference's minAbsoluteError). The leaves are walked as the JAX
package walks its pytrees (dict keys sorted), so ``max_params_per_leaf``
samples the same indices and a failure names the same ``keystr`` path.
The tensors stay on their device: the check runs on a card as well.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}[{i}]")
    elif hasattr(tree, "items"):
        for k in sorted(tree.keys()):
            yield from _leaves_with_paths(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


def _rebuild(tree, leaves):
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    if hasattr(tree, "items"):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree.keys())}
        return {k: out[k] for k in tree.keys()}
    return next(leaves)


def check_gradients(loss_fn, params, *, epsilon=1e-6, max_rel_error=1e-5, min_abs_error=1e-8,
                    max_params_per_leaf=None, verbose=False):
    """Compare autograd's gradient of ``loss_fn(params) -> scalar`` with
    central differences. ``params`` is a tree (lists and dicts) of tensors,
    cast to float64 here. Returns (ok, failures), a failure a dict with
    the parameter's path, flat index, both gradients and the relative
    error."""
    named = [(path, leaf.detach().to(torch.float64))
             for path, leaf in _leaves_with_paths(params)]
    paths = [p for p, _ in named]
    leaves = [t.clone().requires_grad_(True) for _, t in named]
    with torch.enable_grad():
        loss = loss_fn(_rebuild(params, iter(leaves)))
        analytic = torch.autograd.grad(loss, leaves, allow_unused=True)
    analytic = [torch.zeros_like(t) if a is None else a for t, a in zip(leaves, analytic)]
    base = [t.detach() for t in leaves]

    def score(li, flat):
        cur = list(base)
        cur[li] = flat.view(base[li].shape)
        with torch.no_grad():
            return float(loss_fn(_rebuild(params, iter(cur))))

    failures = []
    total_checked = 0
    for li, (leaf, a_leaf, path) in enumerate(zip(base, analytic, paths)):
        flat = leaf.reshape(-1).clone()
        a_flat = a_leaf.reshape(-1).cpu().numpy()
        n = flat.numel()
        idxs = range(n)
        if max_params_per_leaf is not None and n > max_params_per_leaf:
            rng = np.random.RandomState(12345 + li)
            idxs = rng.choice(n, size=max_params_per_leaf, replace=False)
        for i in idxs:
            i = int(i)
            orig = flat[i].item()
            flat[i] = orig + epsilon
            score_plus = score(li, flat)
            flat[i] = orig - epsilon
            score_minus = score(li, flat)
            flat[i] = orig
            numeric = (score_plus - score_minus) / (2.0 * epsilon)
            analytic_i = float(a_flat[i])
            abs_err = abs(analytic_i - numeric)
            denom = max(abs(analytic_i), abs(numeric))
            rel_err = abs_err / denom if denom > 0 else 0.0
            total_checked += 1
            if rel_err > max_rel_error and abs_err > min_abs_error:
                failures.append({"param": path, "index": i, "analytic": analytic_i,
                                 "numeric": numeric, "rel_error": rel_err})
                if verbose:
                    print(f"FAIL {path}[{i}]: analytic={analytic_i:.3e} "
                          f"numeric={numeric:.3e} rel={rel_err:.3e}")
    if verbose:
        print(f"gradcheck: {total_checked} params checked, {len(failures)} failures")
    return len(failures) == 0, failures
