"""Calibration evaluation.

Reference analog: org.deeplearning4j.eval.EvaluationCalibration
(EvaluationCalibration.java) and
eval/curves/{ReliabilityDiagram,Histogram}.java — reliability diagram bins,
residual-probability histograms (all classes + per label class), probability
histograms (all classes + per label class), label/prediction counts per
class, expected calibration error, stats(), merge().

The residual plot bins |label - p| over [0,1]; the per-class variant
restricts to rows whose TRUE label is that class (EvaluationCalibration
.java:362-386). The probability histogram bins the predicted probability of
class c; the per-class variant restricts rows to true-label==c
(EvaluationCalibration.java:388-410).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deeplearning4j_tpu_torch.eval.classification import _flatten_masked, _host


@dataclass
class Histogram:
    """Curve-data analog of eval/curves/Histogram.java."""
    title: str
    lower: float
    upper: float
    bin_counts: np.ndarray

    @property
    def n_bins(self):
        return len(self.bin_counts)

    def bin_lower_bounds(self):
        w = (self.upper - self.lower) / self.n_bins
        return self.lower + w * np.arange(self.n_bins)

    def bin_upper_bounds(self):
        w = (self.upper - self.lower) / self.n_bins
        return self.lower + w * (np.arange(self.n_bins) + 1)

    def bin_mid_values(self):
        return (self.bin_lower_bounds() + self.bin_upper_bounds()) / 2


@dataclass
class ReliabilityDiagram:
    """Curve-data analog of eval/curves/ReliabilityDiagram.java."""
    title: str
    mean_predicted_value: np.ndarray
    fraction_positives: np.ndarray


class EvaluationCalibration:
    def __init__(self, reliability_bins=10, histogram_bins=50):
        self.rel_bins = reliability_bins
        self.hist_bins = histogram_bins
        self._init_done = False

    def _ensure(self, c):
        if not self._init_done:
            self.n_classes = c
            self.bin_count = np.zeros((c, self.rel_bins), np.int64)
            self.bin_pos = np.zeros((c, self.rel_bins), np.int64)
            self.bin_prob_sum = np.zeros((c, self.rel_bins), np.float64)
            # residual |label - p| histograms: all rows, and per true class
            self.residual_hist = np.zeros(self.hist_bins, np.int64)
            self.residual_hist_by_label = np.zeros((c, self.hist_bins), np.int64)
            # probability histograms: p(c) over all rows, and over rows with
            # true label c
            self.prob_hist = np.zeros((c, self.hist_bins), np.int64)
            self.prob_hist_by_label = np.zeros((c, self.hist_bins), np.int64)
            self.label_counts = np.zeros(c, np.int64)
            self.pred_counts = np.zeros(c, np.int64)
            self._init_done = True

    def reset(self):
        self._init_done = False

    def eval(self, labels, predictions, mask=None):
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds, labels = _flatten_masked(predictions, labels, mask)
        self._ensure(preds.shape[-1])
        true_cls = np.argmax(labels, -1)
        np.add.at(self.label_counts, true_cls, 1)
        np.add.at(self.pred_counts, np.argmax(preds, -1), 1)
        for c in range(self.n_classes):
            p = preds[:, c]
            l = labels[:, c] >= 0.5
            bins = np.clip((p * self.rel_bins).astype(np.int64), 0, self.rel_bins - 1)
            np.add.at(self.bin_count[c], bins, 1)
            np.add.at(self.bin_pos[c], bins[l], 1)
            np.add.at(self.bin_prob_sum[c], bins, p)
            hb = np.clip((p * self.hist_bins).astype(np.int64), 0, self.hist_bins - 1)
            np.add.at(self.prob_hist[c], hb, 1)
            np.add.at(self.prob_hist_by_label[c], hb[true_cls == c], 1)
        resid = np.abs(labels - preds)
        rb = np.clip((resid * self.hist_bins).astype(np.int64), 0, self.hist_bins - 1)
        np.add.at(self.residual_hist, rb.reshape(-1), 1)
        for c in range(self.n_classes):
            np.add.at(self.residual_hist_by_label[c],
                      rb[true_cls == c].reshape(-1), 1)

    def merge(self, other):
        if not other._init_done:
            return
        self._ensure(other.n_classes)
        for attr in ("bin_count", "bin_pos", "bin_prob_sum", "residual_hist",
                     "residual_hist_by_label", "prob_hist",
                     "prob_hist_by_label", "label_counts", "pred_counts"):
            setattr(self, attr, getattr(self, attr) + getattr(other, attr))

    # ---- curve data ----

    def reliability_diagram(self, cls):
        """(mean predicted prob, observed frequency) per bin."""
        count = np.maximum(self.bin_count[cls], 1)
        mean_pred = self.bin_prob_sum[cls] / count
        frac_pos = self.bin_pos[cls] / count
        return mean_pred, frac_pos

    def get_reliability_diagram(self, cls):
        mean_pred, frac_pos = self.reliability_diagram(cls)
        return ReliabilityDiagram(f"Reliability Diagram: Class {cls}",
                                  mean_pred, frac_pos)

    def get_residual_plot_all_classes(self):
        return Histogram("Residual Plot - All Predictions and Classes",
                         0.0, 1.0, self.residual_hist.copy())

    def get_residual_plot(self, label_cls):
        return Histogram(f"Residual Plot - Predictions for Label Class {label_cls}",
                         0.0, 1.0, self.residual_hist_by_label[label_cls].copy())

    def get_probability_histogram_all_classes(self):
        return Histogram("Network Probabilities Histogram - All Predictions and Classes",
                         0.0, 1.0, self.prob_hist.sum(0))

    def get_probability_histogram(self, label_cls):
        return Histogram(
            f"Network Probabilities Histogram - P(class {label_cls}) for "
            f"Label Class {label_cls}",
            0.0, 1.0, self.prob_hist_by_label[label_cls].copy())

    def get_label_counts_each_class(self):
        return self.label_counts.copy()

    def get_prediction_counts_each_class(self):
        return self.pred_counts.copy()

    def num_classes(self):
        return self.n_classes

    # ---- scalar summaries ----

    def expected_calibration_error(self, cls=None):
        if cls is None:
            return float(np.mean([self.expected_calibration_error(c)
                                  for c in range(self.n_classes)]))
        mean_pred, frac_pos = self.reliability_diagram(cls)
        weights = self.bin_count[cls] / max(self.bin_count[cls].sum(), 1)
        return float(np.sum(weights * np.abs(mean_pred - frac_pos)))

    def stats(self):
        lines = ["EvaluationCalibration(reliability_bins=%d, histogram_bins=%d)"
                 % (self.rel_bins, self.hist_bins)]
        if self._init_done:
            lines.append("Classes: %d, observed labels per class: %s"
                         % (self.n_classes, self.label_counts.tolist()))
            lines.append("ECE per class: " + ", ".join(
                f"{self.expected_calibration_error(c):.4f}"
                for c in range(self.n_classes)))
        return "\n".join(lines)
