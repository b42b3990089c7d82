"""Full-batch optimizers: line-search gradient descent, conjugate gradient
and L-BFGS, the port of ``deeplearning4j_tpu/nn/solvers.py`` (reference:
Solver.java, BaseOptimizer, ConjugateGradient, LBFGS with m=4,
BackTrackLineSearch and the step functions).

The parameters are one flat vector (``torch.cat`` of the leaves, the
reference's flat parameter view); a loss of it runs the network on views
of that vector. An iteration is the search direction, a backtracking line
search and the step, all on the device. The line search always runs its
``ls_iterations`` trials with masked carries: after the Armijo accept the
remaining trials evaluate the loss and change nothing, as the JAX
package's ``lax.while_loop`` would have stopped. That wastes at most
``ls_iterations - 1`` forwards an iteration and keeps the host out of the
search: the host syncs once an iteration, on the score it compares with
the tolerance, as the JAX package does.

These are whole-batch trainers by construction (a line search on a
stochastic objective means nothing); minibatch SGD is the network's train
step.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.utils.trees import tree_leaves

# termination defaults (BaseOptimizer's scoreTolerance; BackTrackLineSearch's
# ABS_TOLX / stepMax / maxIterations)
DEFAULT_SCORE_TOLERANCE = 1e-5
DEFAULT_STEP_MAX = 100.0
DEFAULT_LS_ITERATIONS = 5
_ABS_TOLX = 1e-8
_ALF = 1e-4  # Armijo sufficient-decrease constant (c1)


# ---------------------------------------------------------------------------
# step functions (reference: optimize/stepfunctions/*.java)
# ---------------------------------------------------------------------------

def default_step(params, search_dir, step):
    """params + step*dir (DefaultStepFunction)."""
    return params + step * search_dir


def negative_default_step(params, search_dir, step):
    """params - step*dir (NegativeDefaultStepFunction)."""
    return params - step * search_dir


def gradient_step(params, search_dir, step):
    """params + dir, the step size ignored (GradientStepFunction)."""
    del step
    return params + search_dir


def negative_gradient_step(params, search_dir, step):
    del step
    return params - search_dir


STEP_FUNCTIONS = {
    "default": default_step,
    "negative_default": negative_default_step,
    "gradient": gradient_step,
    "negative_gradient": negative_gradient_step,
}

# The names follow the reference, whose step functions apply to the RAW
# gradient (negative_* descend). The directions here are already descent
# directions, so the function applied is the sign-mirrored one.
_MIRRORED_STEP_FUNCTIONS = {
    "default": negative_default_step,
    "negative_default": default_step,
    "gradient": negative_gradient_step,
    "negative_gradient": gradient_step,
}


def _at(t, idx):
    """``t[idx]`` for a 0-d index tensor, without a host read of it."""
    return t.index_select(0, idx.reshape(1))[0]


# ---------------------------------------------------------------------------
# line search (reference: BackTrackLineSearch.java, Numerical Recipes' lnsrch)
# ---------------------------------------------------------------------------

def backtrack_line_search(flat_loss, x, f0, g, direction, *,
                          max_iterations=DEFAULT_LS_ITERATIONS, step_max=DEFAULT_STEP_MAX):
    """Armijo backtracking with quadratic, then cubic, interpolation.
    Returns (step, f_new) as 0-d tensors on ``x``'s device, with no host
    sync. A direction longer than ``step_max`` is scaled to it; each trial
    step is clipped to [0.1, 0.5] of the last; after ``max_iterations``
    trials without an accept the best step seen is taken, or a zero step
    if none improved on ``f0``. The step is relative to the caller's
    (unscaled) direction."""
    dt = x.dtype
    tiny = torch.full((), 1e-30, dtype=dt, device=x.device)  # filled on the device: no copy
    dnorm = torch.linalg.vector_norm(direction)
    scale = torch.where(dnorm > step_max, step_max / torch.maximum(dnorm, tiny),
                   torch.ones((), dtype=dt, device=x.device))
    direction = direction * scale
    slope = torch.dot(g, direction)
    # the smallest meaningful step (alamin from ABS_TOLX)
    denom = torch.maximum(torch.max(direction.abs() / torch.clamp(x.abs(), min=1.0)), tiny)
    alamin = _ABS_TOLX / denom

    def nz(v):
        return torch.where(v == 0, tiny, v)

    one = torch.ones((), dtype=dt, device=x.device)
    alam, alam2, f2 = one, one, f0
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    best_alam = torch.zeros((), dtype=dt, device=x.device)
    best_f = torch.full((), float("inf"), dtype=dt, device=x.device)
    for it in range(max_iterations):
        f_new = flat_loss(x + alam * direction)
        live = ~done
        better = live & (f_new < best_f)
        best_alam = torch.where(better, alam, best_alam)
        best_f = torch.where(better, f_new, best_f)
        accept = (f_new <= f0 + _ALF * alam * slope) | (alam < alamin)
        if it == 0:
            tmp = -slope / (2.0 * (f_new - f0 - slope))
        else:
            rhs1 = f_new - f0 - alam * slope
            rhs2 = f2 - f0 - alam2 * slope
            da = nz(alam - alam2)
            a = (rhs1 / (alam * alam) - rhs2 / (alam2 * alam2)) / da
            b = (-alam2 * rhs1 / (alam * alam) + alam * rhs2 / (alam2 * alam2)) / da
            disc = torch.clamp(b * b - 3.0 * a * slope, min=0.0)
            tmp = torch.where(a.abs() < 1e-30, -slope / (2.0 * nz(b)),
                         (-b + torch.sqrt(disc)) / (3.0 * nz(a)))
        tmp = torch.minimum(torch.maximum(tmp, 0.1 * alam), 0.5 * alam)  # NR bounds
        tmp = torch.where(torch.isfinite(tmp), tmp, 0.5 * alam)
        # a finished search keeps its carries: the trial only costs a forward
        alam, alam2, f2 = (torch.where(live, torch.where(accept, alam, tmp), alam),
                           torch.where(live, alam, alam2), torch.where(live, f_new, f2))
        done = done | accept
    step = torch.where(done, alam, best_alam)
    f_out = torch.where(done, f2, torch.where(torch.isfinite(best_f), best_f, f0))
    improved = f_out <= f0
    return (torch.where(improved, step * scale, torch.zeros_like(step)),
            torch.where(improved, f_out, f0))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class BaseConvexOptimizer:
    """The shared loop: a host loop over device iterations (direction,
    line search, step), ending when the score moves by less than
    ``tolerance`` (BaseOptimizer). ``loss_fn(x, *args)`` takes the flat
    parameter vector."""

    def __init__(self, loss_fn, *, max_iterations=100, tolerance=DEFAULT_SCORE_TOLERANCE,
                 line_search_iterations=DEFAULT_LS_ITERATIONS, step_max=DEFAULT_STEP_MAX,
                 step_function="negative_default"):
        self.loss_fn = loss_fn
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.ls_iterations = line_search_iterations
        self.step_max = step_max
        if step_function not in STEP_FUNCTIONS:
            raise ValueError(f"Unknown step_function {step_function!r}; "
                             f"choose from {sorted(STEP_FUNCTIONS)}")
        self.step_function_name = step_function
        self._apply_step = _MIRRORED_STEP_FUNCTIONS[step_function]

    # subclass hooks ---------------------------------------------------
    def _init_aux(self, x):
        return ()

    def _direction(self, g, aux):
        """(descent direction, new aux): applied as x + step*direction."""
        raise NotImplementedError

    def _post_step(self, x_new, x_old, g_new, g_old, aux):
        return aux

    # the loop -----------------------------------------------------------
    def iteration(self, x, g, f0, aux, *args):
        """One iteration from (x, its gradient, its loss): (x_new, f_new,
        aux, step), all on the device."""
        direction, aux = self._direction(g, aux)
        with torch.no_grad():
            step, f_new = backtrack_line_search(
                lambda v: self.loss_fn(v, *args), x, f0, g, direction,
                max_iterations=self.ls_iterations, step_max=self.step_max)
        return self._apply_step(x, direction, step), f_new, aux, step

    def value_and_grad(self, x, *args):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self.loss_fn(x, *args)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g.detach()

    def optimize(self, x0, *args):
        """Minimize ``loss_fn(x, *args)`` from the flat vector ``x0``.
        Returns (x, final score as a float, iterations run)."""
        x = x0.detach()
        f, g = self.value_and_grad(x, *args)
        aux = self._init_aux(x)
        score = prev = float(f)  # the host's one read before the loop, then one an iteration
        it = 0
        for it in range(1, self.max_iterations + 1):
            x_new, _, aux, _ = self.iteration(x, g, f, aux, *args)
            f2, g_new = self.value_and_grad(x_new, *args)
            aux = self._post_step(x_new, x, g_new, g, aux)
            x, g, f = x_new, g_new, f2
            score = float(f)
            if abs(prev - score) < self.tolerance:
                break
            prev = score
        return x, score, it


class LineGradientDescent(BaseConvexOptimizer):
    """Steepest descent with the line search (LineGradientDescent.java)."""

    def _direction(self, g, aux):
        return -g, aux


class ConjugateGradient(BaseConvexOptimizer):
    """Polak-Ribiere nonlinear CG with a restart on a non-descent direction
    (ConjugateGradient.java: beta = max(0, g.(g - g_prev) / g_prev.g_prev),
    dir = -g + beta * dir_prev)."""

    def _init_aux(self, x):
        return (torch.zeros_like(x), torch.zeros_like(x))  # (g_prev, dir_prev)

    def _direction(self, g, aux):
        g_prev, dir_prev = aux
        gg_prev = torch.dot(g_prev, g_prev)
        beta = torch.where(gg_prev > 0,
                      torch.clamp(torch.dot(g, g - g_prev) / torch.clamp(gg_prev, min=1e-30),
                                  min=0.0),
                      torch.zeros_like(gg_prev))
        direction = -g + beta * dir_prev
        direction = torch.where(torch.dot(direction, g) < 0, direction, -g)
        return direction, (g_prev, direction)

    def _post_step(self, x_new, x_old, g_new, g_old, aux):
        return (g_old, aux[1])


class LBFGS(BaseConvexOptimizer):
    """Limited-memory BFGS, the two-loop recursion over the last ``m``
    (s, y) pairs (LBFGS.java, m=4), kept as fixed-shape rings on the
    device with the pair count as a device scalar."""

    def __init__(self, loss_fn, m=4, **kw):
        super().__init__(loss_fn, **kw)
        self.m = m

    def _init_aux(self, x):
        m, n = self.m, x.shape[0]
        z = dict(dtype=x.dtype, device=x.device)
        return (torch.zeros((m, n), **z), torch.zeros((m, n), **z), torch.zeros((m,), **z),
                torch.zeros((), dtype=torch.int64, device=x.device))

    def _direction(self, g, aux):
        s, y, rho, count = aux
        m = self.m
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        n_valid = torch.clamp(count, max=m)
        q = g
        alphas = []  # by bwd step i, which reads ring slot (count - 1 - i) mod m
        for i in range(m):  # newest to oldest
            idx = torch.remainder(count - 1 - i, m)
            alpha = torch.where(i < n_valid, _at(rho, idx) * torch.dot(_at(s, idx), q), zero)
            q = q - alpha * _at(y, idx)
            alphas.append(alpha)
        alphas = torch.stack(alphas)
        newest = torch.remainder(count - 1, m)
        s_new, y_new = _at(s, newest), _at(y, newest)
        yy = torch.dot(y_new, y_new)
        gamma = torch.where((count > 0) & (yy > 0),
                       torch.dot(s_new, y_new) / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
        r = gamma * q
        for i in range(m):  # oldest to newest: slot of bwd step j
            j = n_valid - 1 - i
            idx = torch.remainder(count - 1 - j, m)
            valid = j >= 0
            beta = torch.where(valid, _at(rho, idx) * torch.dot(_at(y, idx), r), zero)
            alpha = _at(alphas, torch.clamp(j, min=0))
            r = r + torch.where(valid, alpha - beta, zero) * _at(s, idx)
        direction = -r
        direction = torch.where(torch.dot(direction, g) < 0, direction, -g)
        return direction, aux

    def _post_step(self, x_new, x_old, g_new, g_old, aux):
        s_ring, y_ring, rho, count = aux
        s = x_new - x_old
        y = g_new - g_old
        sy = torch.dot(s, y)
        idx = torch.remainder(count, self.m)
        ok = sy > 1e-10  # the curvature condition; otherwise skip the pair
        slot = torch.arange(self.m, device=s.device) == idx
        put = ok & slot
        s_ring = torch.where(put[:, None], s[None, :], s_ring)
        y_ring = torch.where(put[:, None], y[None, :], y_ring)
        rho = torch.where(put, 1.0 / torch.clamp(sy, min=1e-30), rho)
        return (s_ring, y_ring, rho, count + ok.to(count.dtype))


ALGORITHMS = {
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


def flatten_params(params):
    """(the leaves of ``params`` as one flat detached vector, the leaves)."""
    leaves = list(tree_leaves(params))
    return torch.cat([p.detach().reshape(-1) for p in leaves]), leaves


def unflatten_like(flat, params):
    """Plain lists and dicts shaped as ``params`` whose leaves are views of
    ``flat``, so gradients reach the flat vector."""
    leaves = iter(tree_leaves(params))
    offset = [0]

    def take(p):
        n = p.numel()
        v = flat[offset[0]:offset[0] + n].view(p.shape)
        offset[0] += n
        return v

    def build(node):
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        if hasattr(node, "items"):
            return {k: build(v) for k, v in node.items()}
        return take(next(leaves))

    return build(params)


class Solver:
    """A network trained full batch by one of ``ALGORITHMS`` (reference:
    Solver.java): ``optimize(x, y)`` minimizes the network's loss over its
    parameters, writes the result into them in place and returns the final
    score. Works on either network kind (for a graph, ``x`` and ``y`` are
    what its ``loss_fn`` takes). The loss runs with ``train=True`` and the
    fixed seed 0, as the JAX package's fixed key."""

    def __init__(self, net, algorithm="lbfgs", **kw):
        if algorithm == "stochastic_gradient_descent":
            raise ValueError("SGD is the network's train step (make_train_step); Solver "
                             "hosts the full-batch algorithms: " + ", ".join(ALGORITHMS))
        self.net = net
        self.algorithm = algorithm
        self.kw = kw

    def optimize(self, x, y, mask=None):
        from deeplearning4j_tpu_torch.utils import dtypes as _dtypes

        net = self.net
        if net.params is None:
            net.init()
        dev = net.device
        x, y = _on(x, dev), _on(y, dev)
        mask = None if mask is None else _on(mask, dev)
        params, state = net.params, net.state
        flat0, leaves = flatten_params(params)

        def loss_fn(v, x, y):
            kw = {} if mask is None else {"mask": mask}
            loss, _ = net.loss_fn(unflatten_like(v, params), state, x, y, train=True, rng=0,
                                  **kw)
            return loss

        opt = ALGORITHMS[self.algorithm](loss_fn, **self.kw)
        with _dtypes.policy_precision():
            flat, score, iters = opt.optimize(flat0, x, y)
        with torch.no_grad():
            offset = 0
            for p in leaves:
                p.copy_(flat[offset:offset + p.numel()].view(p.shape))
                offset += p.numel()
        net.iteration += iters
        return score


def _on(a, device):
    """``a`` (numpy, a tensor or a dict of them) as tensors on ``device``."""
    if isinstance(a, dict):
        return {k: _on(v, device) for k, v in a.items()}
    t = a if torch.is_tensor(a) else torch.from_numpy(a)
    return t.to(device)
