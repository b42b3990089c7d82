"""Early stopping (reference: earlystopping/ — EarlyStoppingConfiguration
.java, trainer/BaseEarlyStoppingTrainer.java:76 fit(), the termination
conditions, the in-memory and local-file savers, the score calculators).

The port of ``deeplearning4j_tpu/nn/earlystopping.py``, for both network
kinds: the same conditions, savers, configuration, result and trainer
loop. ``InMemoryModelSaver`` keeps detached copies of the parameters and
state on the network's device and copies them back into the live
network's tensors on restore; ``LocalFileModelSaver`` writes checkpoint
zips that either package reads.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from deeplearning4j_tpu_torch.utils.trees import tree_leaves


# ---- termination conditions (reference: earlystopping/termination/) ----


@dataclasses.dataclass(frozen=True)
class MaxEpochsTermination:
    max_epochs: int = 10

    def terminate_epoch(self, epoch, score, best_score):
        return epoch >= self.max_epochs


@dataclasses.dataclass(frozen=True)
class ScoreImprovementEpochsTermination:
    """Stop after N epochs with no score improvement."""

    max_epochs_no_improvement: int = 5
    min_improvement: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "_best", None)
        object.__setattr__(self, "_stale", 0)

    def terminate_epoch(self, epoch, score, best_score):
        if self._best is None or score < self._best - self.min_improvement:
            object.__setattr__(self, "_best", score)
            object.__setattr__(self, "_stale", 0)
            return False
        object.__setattr__(self, "_stale", self._stale + 1)
        return self._stale >= self.max_epochs_no_improvement


@dataclasses.dataclass(frozen=True)
class BestScoreTermination:
    """Stop once score is at or below a target."""

    target: float = 0.0

    def terminate_epoch(self, epoch, score, best_score):
        return score <= self.target


@dataclasses.dataclass(frozen=True)
class MaxTimeTermination:
    max_seconds: float = 3600.0

    def __post_init__(self):
        object.__setattr__(self, "_start", time.time())

    def terminate_epoch(self, epoch, score, best_score):
        return time.time() - self._start > self.max_seconds


@dataclasses.dataclass(frozen=True)
class MaxScoreIterationTermination:
    """Abort mid-training if score blows past a ceiling (divergence guard)."""

    max_score: float = 1e9

    def terminate_iteration(self, iteration, score):
        return score > self.max_score


# ---- savers (reference: earlystopping/saver/) ----


class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    def save_best(self, net, score, epoch):
        self.best = (self._snapshot(net), score, epoch)

    def save_latest(self, net, score, epoch):
        self.latest = (self._snapshot(net), score, epoch)

    @staticmethod
    def _snapshot(net):
        # real copies: the live network's updater writes its tensors in place
        return {"params": [p.detach().clone() for p in tree_leaves(net.params)],
                "state": [t.clone() for t in tree_leaves(net.state)]}

    def restore_best(self, net):
        """Copy the best snapshot back into ``net``'s own tensors (the
        snapshot stays intact for another restore). Returns ``net``."""
        snap, _, _ = self.best
        with torch.no_grad():
            for dst, src in zip(tree_leaves(net.params), snap["params"]):
                dst.copy_(src)
            for dst, src in zip(tree_leaves(net.state), snap["state"]):
                dst.copy_(src)
        return net


class LocalFileModelSaver:
    def __init__(self, directory):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save_best(self, net, score, epoch):
        from deeplearning4j_tpu_torch.utils.serialization import save_model
        save_model(net, os.path.join(self.directory, "bestModel.zip"))

    def save_latest(self, net, score, epoch):
        from deeplearning4j_tpu_torch.utils.serialization import save_model
        save_model(net, os.path.join(self.directory, "latestModel.zip"))

    def restore_best(self, net):
        """The best checkpoint, loaded on ``net``'s device."""
        from deeplearning4j_tpu_torch.utils.serialization import load_model
        return load_model(os.path.join(self.directory, "bestModel.zip"), device=net.device)


# ---- score calculators (reference: earlystopping/scorecalc/) ----


class DataSetLossCalculator:
    def __init__(self, x, y, mask=None):
        self.x, self.y, self.mask = x, y, mask

    def __call__(self, net):
        return net.score(self.x, self.y, mask=self.mask)


# ---- configuration + trainer ----


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: object = None
    epoch_terminations: tuple = ()
    iteration_terminations: tuple = ()
    saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str = ""
    termination_details: str = ""
    total_epochs: int = 0
    best_epoch: int = -1
    best_score: float = float("inf")
    score_vs_epoch: dict = dataclasses.field(default_factory=dict)
    best_model: object = None


class EarlyStoppingTrainer:
    """(reference: trainer/BaseEarlyStoppingTrainer.java:76 fit loop)."""

    def __init__(self, config: EarlyStoppingConfiguration, net, x, y, *,
                 batch_size=None, mask=None):
        self.config = config
        self.net = net
        self.x, self.y, self.mask = x, y, mask
        self.batch_size = batch_size

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        result = EarlyStoppingResult()
        if self.net.params is None:
            self.net.init()
        epoch = 0
        while True:
            self.net.fit(self.x, self.y, epochs=1, batch_size=self.batch_size,
                         mask=self.mask)
            # iteration-level divergence guard
            score_now = getattr(self.net, "score_value", None)
            if score_now is not None:
                for t in cfg.iteration_terminations:
                    if t.terminate_iteration(self.net.iteration, float(score_now)):
                        result.termination_reason = "IterationTermination"
                        result.termination_details = type(t).__name__
                        result.total_epochs = epoch + 1
                        result.best_model = self.net
                        return result
            epoch += 1
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator(self.net)
                result.score_vs_epoch[epoch] = score
                if score < result.best_score:
                    result.best_score = score
                    result.best_epoch = epoch
                    cfg.saver.save_best(self.net, score, epoch)
                if cfg.save_last_model:
                    cfg.saver.save_latest(self.net, score, epoch)
                for t in cfg.epoch_terminations:
                    if t.terminate_epoch(epoch, score, result.best_score):
                        result.termination_reason = "EpochTermination"
                        result.termination_details = type(t).__name__
                        result.total_epochs = epoch
                        result.best_model = cfg.saver.restore_best(self.net) \
                            if getattr(cfg.saver, "best", True) is not None else self.net
                        return result
