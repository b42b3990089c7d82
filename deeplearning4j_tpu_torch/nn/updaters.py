"""Updaters (optimizers) and learning-rate schedules.

The same classes, fields, defaults and math as
``deeplearning4j_tpu/nn/updaters.py``, so a ``config.json`` naming any of
them parses, round-trips and trains alike. The update math is written by
hand here, not taken from ``torch.optim``: the JAX package's Adam folds the
bias correction into the step size (``lr * sqrt(1 - b2^t) / (1 - b1^t)``)
and adds epsilon to the uncorrected ``sqrt(v)``, with ``t = step + 1``,
where ``torch.optim.Adam`` adds epsilon after the correction; the others
differ in similar details.

Each updater has
  init(params)                           -> state
  scalars(step)                          -> its per-step scalars (floats)
  step_table(steps)                      -> [len(steps), n] float32 of them
  update_(params, grads, state, step)    -> state
where ``params`` is the network's list of per-layer parameter trees,
``grads`` a matching list of dicts of tensors, and ``state`` mirrors the
JAX package's optimizer state: a per-layer tree list, a dict of them
(``{"m": ..., "v": ...}``), or ``()``. ``update_`` updates the parameters
and the state in place under ``torch.no_grad()`` (the JAX package returns
new arrays; updating in place keeps one copy of each on the card).

The per-step scalars (the learning rate from its schedule, the bias
corrections) are computed on the host in float32, as JAX computes them,
and reach the update as a device tensor: ``step`` is either an iteration
(an int, whose row of ``step_table`` is staged to the parameters' device)
or that row already on the device. The K-step engine (``nn/fused.py``)
stages the table of a dispatch's K steps with its super-batch, so a
captured CUDA graph reads each step's scalars from a buffer instead of
baking the capture's values in; the K=1 loop runs the same arithmetic on
its one-row table.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.serde import register_config
from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

_F32 = np.float32


def _f(x):
    return _F32(x)


@register_config
@dataclasses.dataclass(frozen=True)
class FixedSchedule:
    value: float = 0.1

    def __call__(self, step):
        return float(_f(self.value))


@register_config
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule:
    initial: float = 0.1
    gamma: float = 0.99

    def __call__(self, step):
        return float(_f(self.initial) * _f(self.gamma) ** _f(step))


@register_config
@dataclasses.dataclass(frozen=True)
class InverseSchedule:
    initial: float = 0.1
    gamma: float = 0.99
    power: float = 1.0

    def __call__(self, step):
        return float(_f(self.initial) / (_f(1) + _f(self.gamma) * _f(step)) ** _f(self.power))


@register_config
@dataclasses.dataclass(frozen=True)
class PolySchedule:
    initial: float = 0.1
    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, step):
        frac = np.clip(_f(step) / _f(self.max_iter), _f(0), _f(1))
        return float(_f(self.initial) * (_f(1) - frac) ** _f(self.power))


@register_config
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule:
    initial: float = 0.1
    gamma: float = 0.99
    step_size: int = 100

    def __call__(self, step):
        z = -_f(self.gamma) * (_f(step) - _f(self.step_size))
        return float(_f(self.initial) / (_f(1) + np.exp(z)))


@register_config
@dataclasses.dataclass(frozen=True)
class StepSchedule:
    initial: float = 0.1
    decay_rate: float = 0.5
    step_size: int = 1000

    def __call__(self, step):
        n = np.floor(_f(step) / _f(self.step_size))
        return float(_f(self.initial) * _f(self.decay_rate) ** n)


@register_config
@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule:
    peak: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10000
    floor: float = 0.0

    def __call__(self, step):
        s = _f(step)
        if s < self.warmup_steps:
            return float(_f(self.peak) * s / _f(max(self.warmup_steps, 1)))
        span = _f(max(self.total_steps - self.warmup_steps, 1))
        frac = np.clip((s - _f(self.warmup_steps)) / span, _f(0), _f(1))
        return float(_f(self.floor) + _f(0.5) * (_f(self.peak) - _f(self.floor))
                     * (_f(1) + np.cos(_f(math.pi) * frac)))


Schedule = typing.Union[float, FixedSchedule, ExponentialSchedule, InverseSchedule,
                        PolySchedule, SigmoidSchedule, StepSchedule, WarmupCosineSchedule]


def resolve_lr(lr, step):
    """The learning rate at ``step``: a schedule's value or the constant."""
    return lr(step) if callable(lr) else float(_f(lr))


def _row(table_row, like):
    """A step's scalar row as a tensor on ``like``'s device (pinned and
    copied without a host wait on a card)."""
    row = torch.from_numpy(table_row)
    if like.device.type == "cuda":
        return row.pin_memory().to(like.device, non_blocking=True)
    return row


class _Scalars:
    """The per-step scalar table every updater shares."""

    def scalars(self, step):
        return ()

    def step_table(self, steps):
        """[len(steps), n] float32: ``scalars`` of each step."""
        rows = [self.scalars(int(s)) for s in steps]
        return np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)

    def step_row(self, step, like):
        """``step``'s scalars as a device tensor: an int's row of the table
        staged to ``like``'s device, or a row given on the device."""
        if torch.is_tensor(step):
            return step
        return _row(self.step_table([step])[0], like)


def zeros_like_tree(params):
    """Plain lists and dicts of zeros mirroring ``params``."""
    return tree_like(params, (torch.zeros_like(p.detach()) for p in tree_leaves(params)))


def _bias_powers(b, step):
    """(b^t, b^(t+1)) in float32 with t = step + 1."""
    t = _f(step) + _f(1)
    return _f(b) ** t, _f(b) ** (t + _f(1))


@register_config
@dataclasses.dataclass(frozen=True)
class Sgd(_Scalars):
    learning_rate: Schedule = 0.1

    def init(self, params):
        return ()

    def scalars(self, step):
        return (resolve_lr(self.learning_rate, step),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr = self.step_row(step, leaves[0])[0]
        for p, g in zip(leaves, tree_leaves(grads)):
            p.add_(-lr * g)
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class Nesterovs(_Scalars):
    learning_rate: Schedule = 0.1
    momentum: float = 0.9

    def init(self, params):
        return zeros_like_tree(params)

    def scalars(self, step):
        return (resolve_lr(self.learning_rate, step),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr, mu = self.step_row(step, leaves[0])[0], self.momentum
        for p, g, v in zip(leaves, tree_leaves(grads), tree_leaves(state)):
            v.copy_(mu * v - lr * g)
            p.add_(mu * v - lr * g)  # look-ahead (ND4J NesterovsUpdater)
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class Adam(_Scalars):
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": zeros_like_tree(params), "v": zeros_like_tree(params)}

    def scalars(self, step):
        lr = resolve_lr(self.learning_rate, step)
        b1t, b2t = _bias_powers(self.beta1, step)[0], _bias_powers(self.beta2, step)[0]
        return (float(-_f(lr) * (np.sqrt(_f(1) - b2t) / (_f(1) - b1t))),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr_t = self.step_row(step, leaves[0])[0]
        b1, b2 = self.beta1, self.beta2
        for p, g, m, v in zip(leaves, tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.add_(lr_t * m / (torch.sqrt(v) + self.epsilon))
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class AdaMax(_Scalars):
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": zeros_like_tree(params), "u": zeros_like_tree(params)}

    def scalars(self, step):
        lr = resolve_lr(self.learning_rate, step)
        return (float(_f(lr) / (_f(1) - _bias_powers(self.beta1, step)[0])),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        scale = self.step_row(step, leaves[0])[0]
        b1, b2 = self.beta1, self.beta2
        for p, g, m, u in zip(leaves, tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["u"])):
            m.copy_(b1 * m + (1 - b1) * g)
            u.copy_(torch.maximum(b2 * u, g.abs()))
            p.add_(-scale * m / (u + self.epsilon))
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class Nadam(_Scalars):
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": zeros_like_tree(params), "v": zeros_like_tree(params)}

    def scalars(self, step):
        b1t, b1t1 = _bias_powers(self.beta1, step)
        b2t = _bias_powers(self.beta2, step)[0]
        return (resolve_lr(self.learning_rate, step), float(_f(1) - b1t1), float(_f(1) - b1t),
                float(_f(1) - b2t))

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr, c_m, c_g, c_v = self.step_row(step, leaves[0])
        b1, b2 = self.beta1, self.beta2
        for p, g, m, v in zip(leaves, tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mhat = b1 * m / c_m + (1 - b1) * g / c_g
            vhat = v / c_v
            p.add_(-lr * mhat / (torch.sqrt(vhat) + self.epsilon))
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class AdaGrad(_Scalars):
    learning_rate: Schedule = 0.1
    epsilon: float = 1e-6

    def init(self, params):
        return zeros_like_tree(params)

    def scalars(self, step):
        return (resolve_lr(self.learning_rate, step),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr = self.step_row(step, leaves[0])[0]
        for p, g, h in zip(leaves, tree_leaves(grads), tree_leaves(state)):
            h.add_(g * g)
            p.add_(-lr * g / (torch.sqrt(h) + self.epsilon))
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class AdaDelta(_Scalars):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, params):
        return {"g2": zeros_like_tree(params), "dx2": zeros_like_tree(params)}

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        rho, eps = self.rho, self.epsilon
        for p, g, g2, dx2 in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["g2"]),
                                 tree_leaves(state["dx2"])):
            g2.copy_(rho * g2 + (1 - rho) * g * g)
            u = -g * torch.sqrt(dx2 + eps) / torch.sqrt(g2 + eps)
            dx2.copy_(rho * dx2 + (1 - rho) * u * u)
            p.add_(u)
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class RmsProp(_Scalars):
    learning_rate: Schedule = 1e-3
    decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return zeros_like_tree(params)

    def scalars(self, step):
        return (resolve_lr(self.learning_rate, step),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr, d = self.step_row(step, leaves[0])[0], self.decay
        for p, g, a in zip(leaves, tree_leaves(grads), tree_leaves(state)):
            a.copy_(d * a + (1 - d) * g * g)
            p.add_(-lr * g / (torch.sqrt(a) + self.epsilon))
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class AmsGrad(_Scalars):
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": zeros_like_tree(params), "v": zeros_like_tree(params),
                "vhat": zeros_like_tree(params)}

    def scalars(self, step):
        return (resolve_lr(self.learning_rate, step),)

    @torch.no_grad()
    def update_(self, params, grads, state, step):
        leaves = list(tree_leaves(params))
        if not leaves:
            return state
        lr = self.step_row(step, leaves[0])[0]
        b1, b2 = self.beta1, self.beta2
        for p, g, m, v, vh in zip(leaves, tree_leaves(grads), tree_leaves(state["m"]),
                                  tree_leaves(state["v"]), tree_leaves(state["vhat"])):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            torch.maximum(vh, v, out=vh)
            p.add_(-lr * m / (torch.sqrt(vh) + self.epsilon))
        return state


@register_config
@dataclasses.dataclass(frozen=True)
class NoOp(_Scalars):
    def init(self, params):
        return ()

    def update_(self, params, grads, state, step):
        return state


UPDATERS = {
    "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "adadelta": AdaDelta,
    "nesterovs": Nesterovs, "nadam": Nadam, "adagrad": AdaGrad,
    "rmsprop": RmsProp, "amsgrad": AmsGrad, "none": NoOp,
}


def get(name, **kwargs):
    if not isinstance(name, str):
        return name
    cls = UPDATERS.get(name.lower())
    if cls is None:
        raise KeyError(f"Unknown updater {name!r}. Known: {sorted(UPDATERS)}")
    return cls(**kwargs)
