"""Updater and learning-rate schedule configs.

Only the config dataclasses are ported: the same classes, fields and
defaults as ``deeplearning4j_tpu/nn/updaters.py``, so a ``config.json``
naming any of them parses and round-trips. The update math arrives with
the training slice; serving never runs it.
"""

from __future__ import annotations

import dataclasses
import typing

from deeplearning4j_tpu_torch.utils.serde import register_config


@register_config
@dataclasses.dataclass(frozen=True)
class FixedSchedule:
    value: float = 0.1


@register_config
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule:
    initial: float = 0.1
    gamma: float = 0.99


@register_config
@dataclasses.dataclass(frozen=True)
class InverseSchedule:
    initial: float = 0.1
    gamma: float = 0.99
    power: float = 1.0


@register_config
@dataclasses.dataclass(frozen=True)
class PolySchedule:
    initial: float = 0.1
    power: float = 1.0
    max_iter: int = 10000


@register_config
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule:
    initial: float = 0.1
    gamma: float = 0.99
    step_size: int = 100


@register_config
@dataclasses.dataclass(frozen=True)
class StepSchedule:
    initial: float = 0.1
    decay_rate: float = 0.5
    step_size: int = 1000


@register_config
@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule:
    peak: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10000
    floor: float = 0.0


Schedule = typing.Union[float, FixedSchedule, ExponentialSchedule, InverseSchedule,
                        PolySchedule, SigmoidSchedule, StepSchedule, WarmupCosineSchedule]


@register_config
@dataclasses.dataclass(frozen=True)
class Sgd:
    learning_rate: Schedule = 0.1


@register_config
@dataclasses.dataclass(frozen=True)
class Nesterovs:
    learning_rate: Schedule = 0.1
    momentum: float = 0.9


@register_config
@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_config
@dataclasses.dataclass(frozen=True)
class AdaMax:
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_config
@dataclasses.dataclass(frozen=True)
class Nadam:
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_config
@dataclasses.dataclass(frozen=True)
class AdaGrad:
    learning_rate: Schedule = 0.1
    epsilon: float = 1e-6


@register_config
@dataclasses.dataclass(frozen=True)
class AdaDelta:
    rho: float = 0.95
    epsilon: float = 1e-6


@register_config
@dataclasses.dataclass(frozen=True)
class RmsProp:
    learning_rate: Schedule = 1e-3
    decay: float = 0.95
    epsilon: float = 1e-8


@register_config
@dataclasses.dataclass(frozen=True)
class AmsGrad:
    learning_rate: Schedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_config
@dataclasses.dataclass(frozen=True)
class NoOp:
    pass


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
