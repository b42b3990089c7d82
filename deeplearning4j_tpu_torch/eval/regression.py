"""Regression evaluation.

Reference analog: org.deeplearning4j.eval.RegressionEvaluation
(RegressionEvaluation.java) —
per-column MSE, MAE, RMSE, RSE (relative squared error), PC (Pearson
correlation), R^2; streaming accumulation; time-series masking.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.classification import _flatten_masked, _host


class RegressionEvaluation:
    def __init__(self, n_columns=None, column_names=None):
        self.column_names = list(column_names) if column_names else None
        self.n_columns = n_columns or (len(column_names) if column_names else None)
        self._init_done = False

    def _ensure(self, c):
        if not self._init_done:
            self.n_columns = self.n_columns or c
            z = lambda: np.zeros(self.n_columns, np.float64)
            self.count = z()
            self.sum_sq_err = z()
            self.sum_abs_err = z()
            self.sum_label = z()
            self.sum_label_sq = z()
            self.sum_pred = z()
            self.sum_pred_sq = z()
            self.sum_label_pred = z()
            self._init_done = True

    def eval(self, labels, predictions, mask=None):
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds, labels = _flatten_masked(predictions, labels, mask)
        self._ensure(preds.shape[-1])
        err = preds - labels
        self.count += len(preds)
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred_sq += (preds ** 2).sum(0)
        self.sum_label_pred += (labels * preds).sum(0)

    def mean_squared_error(self, col):
        return float(self.sum_sq_err[col] / self.count[col])

    def mean_absolute_error(self, col):
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col):
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col):
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        ss_tot = self.sum_label_sq[col] - n * mean_label ** 2
        return float(self.sum_sq_err[col] / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col):
        n = self.count[col]
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        var_l = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        var_p = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        denom = np.sqrt(var_l * var_p)
        return float(cov / denom) if denom else 0.0

    def r_squared(self, col):
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self):
        return float(np.mean([self.mean_squared_error(i) for i in range(self.n_columns)]))

    def average_mean_absolute_error(self):
        return float(np.mean([self.mean_absolute_error(i) for i in range(self.n_columns)]))

    def average_r_squared(self):
        return float(np.mean([self.r_squared(i) for i in range(self.n_columns)]))

    def stats(self):
        name = lambda i: (self.column_names[i] if self.column_names else f"col{i}")
        return "\n".join(
            f"{name(i)}: MSE={self.mean_squared_error(i):.5f} "
            f"MAE={self.mean_absolute_error(i):.5f} "
            f"RMSE={self.root_mean_squared_error(i):.5f} "
            f"RSE={self.relative_squared_error(i):.5f} "
            f"PC={self.pearson_correlation(i):.5f} R^2={self.r_squared(i):.5f}"
            for i in range(self.n_columns))
