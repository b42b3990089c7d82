"""Simple classification result wrappers, the port's copy of
``deeplearning4j_tpu/nn/simple.py`` (reference: RankClassificationResult.java
and BinaryClassificationResult.java): raw output matrices turned into
ranked labels and probabilities for application code. numpy on the host;
a tensor is fetched once.
"""

from __future__ import annotations

import numpy as np


class RankClassificationResult:
    """Rank classes by probability per example (reference:
    RankClassificationResult.java — sortWithIndices descending + labels)."""

    def __init__(self, outcome, labels=None):
        if hasattr(outcome, "detach"):  # a tensor, wherever it lives
            outcome = outcome.detach().float().cpu().numpy()
        outcome = np.asarray(outcome)
        if outcome.ndim == 1:
            outcome = outcome[None, :]
        if outcome.ndim != 2:
            raise ValueError("only vectors and matrices are supported")
        self.probabilities = outcome.astype(np.float32)
        self.ranked_indices = np.argsort(-outcome, axis=1, kind="stable")
        self.labels = (list(labels) if labels is not None
                       else [str(i) for i in range(outcome.shape[1])])

    def ranked_labels(self, row):
        """Class labels for one example, most probable first."""
        return [self.labels[i] for i in self.ranked_indices[row]]

    def max_label(self, row):
        return self.labels[self.ranked_indices[row][0]]

    def max_labels(self):
        return [self.max_label(r) for r in range(len(self.ranked_indices))]

    def probability_for_label(self, row, label):
        return float(self.probabilities[row, self.labels.index(label)])


class BinaryClassificationResult:
    """Thresholded binary outcome (reference:
    BinaryClassificationResult.java)."""

    def __init__(self, probability, threshold=0.5):
        self.probability = float(probability)
        self.threshold = float(threshold)

    @property
    def is_positive(self):
        return self.probability >= self.threshold

    def __repr__(self):
        return (f"BinaryClassificationResult(p={self.probability:.4f}, "
                f"positive={self.is_positive})")
