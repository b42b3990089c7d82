"""ROC / AUC evaluation.

Reference analog: org.deeplearning4j.eval.ROC / ROCBinary / ROCMultiClass +
eval/curves/ (ROC.java). The
reference supports exact mode (store all scores) and thresholded mode
(fixed-number-of-bins histogram); both are provided here. AUROC by
trapezoidal rule; AUPRC likewise; exact mode matches sklearn semantics.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.classification import _flatten_masked, _host


class ROC:
    """Binary ROC. label: [N] or [N,1] in {0,1} (or [N,2] one-hot, positive
    class = column 1); prediction: P(class=1)."""

    def __init__(self, threshold_steps=0):
        """threshold_steps=0 -> exact mode; >0 -> histogram with that many bins."""
        self.exact = threshold_steps == 0
        self.steps = threshold_steps
        if self.exact:
            self._scores = []
            self._labels = []
        else:
            self._pos_hist = np.zeros(threshold_steps + 1, np.int64)
            self._neg_hist = np.zeros(threshold_steps + 1, np.int64)
        self.n_pos = 0
        self.n_neg = 0

    @staticmethod
    def _binary(labels, preds):
        labels = np.asarray(labels)
        preds = np.asarray(preds)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            preds = preds[:, 1]
        return labels.reshape(-1), preds.reshape(-1)

    def eval(self, labels, predictions, mask=None):
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds, labels = _flatten_masked(predictions, labels, mask) \
            if np.asarray(predictions).ndim == 3 else (predictions, labels)
        labels, preds = self._binary(labels, preds)
        pos = labels >= 0.5
        self.n_pos += int(pos.sum())
        self.n_neg += int((~pos).sum())
        if self.exact:
            self._scores.append(np.asarray(preds, np.float64))
            self._labels.append(pos)
        else:
            bins = np.clip((preds * self.steps).astype(np.int64), 0, self.steps)
            np.add.at(self._pos_hist, bins[pos], 1)
            np.add.at(self._neg_hist, bins[~pos], 1)

    def roc_curve(self):
        """Returns (fpr, tpr, thresholds) with descending thresholds."""
        if self.exact:
            scores = np.concatenate(self._scores) if self._scores else np.zeros(0)
            labels = np.concatenate(self._labels) if self._labels else np.zeros(0, bool)
            order = np.argsort(-scores, kind="stable")
            sorted_labels = labels[order]
            tps = np.cumsum(sorted_labels)
            fps = np.cumsum(~sorted_labels)
            # collapse ties on threshold
            distinct = np.r_[np.diff(scores[order]) != 0, True]
            tps, fps = tps[distinct], fps[distinct]
            thr = scores[order][distinct]
            tpr = np.r_[0.0, tps / max(self.n_pos, 1)]
            fpr = np.r_[0.0, fps / max(self.n_neg, 1)]
            return fpr, tpr, np.r_[np.inf, thr]
        # histogram mode: bin b holds counts with quantized score b; for
        # threshold t_b = b/steps, TPR = #pos with score >= t_b / n_pos.
        pos_above = np.cumsum(self._pos_hist[::-1])[::-1]
        neg_above = np.cumsum(self._neg_hist[::-1])[::-1]
        tpr = np.r_[0.0, (pos_above / max(self.n_pos, 1))[::-1]]  # b=steps..0
        fpr = np.r_[0.0, (neg_above / max(self.n_neg, 1))[::-1]]
        thr = np.r_[np.inf, (np.arange(self.steps + 1) / self.steps)[::-1]]
        return fpr, tpr, thr

    def auc(self):
        fpr, tpr, _ = self.roc_curve()
        return float(np.trapezoid(tpr, fpr))

    def precision_recall_curve(self):
        assert self.exact, "PR curve requires exact mode"
        scores = np.concatenate(self._scores) if self._scores else np.zeros(0)
        labels = np.concatenate(self._labels) if self._labels else np.zeros(0, bool)
        order = np.argsort(-scores, kind="stable")
        sl = labels[order]
        tps = np.cumsum(sl)
        fps = np.cumsum(~sl)
        precision = tps / np.maximum(tps + fps, 1)
        recall = tps / max(self.n_pos, 1)
        return precision, recall

    def auprc(self):
        precision, recall = self.precision_recall_curve()
        if len(recall) == 0:
            return 0.0
        precision = np.r_[precision[0], precision]  # extend flat to recall=0
        recall = np.r_[0.0, recall]
        return float(np.trapezoid(precision, recall))


class ROCBinary:
    """Independent ROC per output column (reference: eval/ROCBinary.java)."""

    def __init__(self, threshold_steps=0):
        self.steps = threshold_steps
        self._rocs = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds = np.asarray(predictions)
        labels = np.asarray(labels)
        if self._rocs is None:
            self._rocs = [ROC(self.steps) for _ in range(preds.shape[-1])]
        for i, roc in enumerate(self._rocs):
            roc.eval(labels[..., i], preds[..., i], mask)

    def auc(self, i):
        return self._rocs[i].auc()

    def average_auc(self):
        return float(np.mean([r.auc() for r in self._rocs]))


class ROCMultiClass:
    """One-vs-all ROC per class (reference: eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps=0):
        self.steps = threshold_steps
        self._rocs = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds = np.asarray(predictions)
        labels = np.asarray(labels)
        if self._rocs is None:
            self._rocs = [ROC(self.steps) for _ in range(preds.shape[-1])]
        for i, roc in enumerate(self._rocs):
            roc.eval(labels[..., i], preds[..., i], mask)

    def auc(self, i):
        return self._rocs[i].auc()

    def average_auc(self):
        return float(np.mean([r.auc() for r in self._rocs]))


def _merge_roc(self, other):
    """Combine a partial ROC (reference: ROC.merge — exact mode concatenates
    stored scores; thresholded mode adds histogram counts)."""
    if self.exact != other.exact:
        raise ValueError("cannot merge exact and thresholded ROCs")
    if self.exact:
        self._scores.extend(other._scores)
        self._labels.extend(other._labels)
    else:
        if self.steps != other.steps:
            raise ValueError("threshold_steps mismatch")
        self._pos_hist += other._pos_hist
        self._neg_hist += other._neg_hist
    self.n_pos += other.n_pos
    self.n_neg += other.n_neg


def _reset_roc(self):
    if self.exact:
        self._scores, self._labels = [], []
    else:
        self._pos_hist[:] = 0
        self._neg_hist[:] = 0
    self.n_pos = self.n_neg = 0


def _stats_roc(self):
    return f"AUC: [{self.auc():.6f}]" + \
        (f"\nAUPRC: [{self.auprc():.6f}]" if self.exact else "")


ROC.merge = _merge_roc
ROC.reset = _reset_roc
ROC.stats = _stats_roc


def _merge_multi(self, other):
    """Merge per-output/per-class ROC collections (reference:
    ROCBinary.merge / ROCMultiClass.merge)."""
    if other._rocs is None:
        return
    if self._rocs is None:
        self._rocs = [ROC(self.steps) for _ in other._rocs]
    if len(self._rocs) != len(other._rocs):
        raise ValueError("output-count mismatch")
    for mine, theirs in zip(self._rocs, other._rocs):
        mine.merge(theirs)


def _reset_multi(self):
    self._rocs = None


ROCBinary.merge = _merge_multi
ROCBinary.reset = _reset_multi
ROCMultiClass.merge = _merge_multi
ROCMultiClass.reset = _reset_multi
