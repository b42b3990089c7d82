"""Classification evaluation.

Reference analog: org.deeplearning4j.eval.Evaluation (Evaluation.java,
1627 LoC), ConfusionMatrix.java, EvaluationBinary.java, EvaluationUtils.java.
Behavior parity includes the documented edge semantics:

* single-column labels -> binary 2-class case with a decision threshold
  (Evaluation.java:324-351);
* ``binary_decision_threshold`` on 2-column predictions thresholds
  P(class=1) instead of argmax (Evaluation.java:365-372);
* ``cost_array`` -> argmax(probability * cost) (Evaluation.java:374-377);
* top-N counts a row correct when strictly-more-probable classes number
  fewer than N, i.e. ties on the true-class probability are favorable
  (Evaluation.java:436-453);
* macro averages exclude classes whose metric is the 0/0 edge case, and
  ``average_*_num_classes_excluded`` report how many (Evaluation.java:675-770);
* micro averaging sums tp/fp/fn/tn counts across classes first;
* fBeta with exactly 2 known classes uses class-1 counts (the reference's
  binary special case, Evaluation.java:1050-1060);
* gMeasure macro-averages over all classes WITHOUT 0/0 exclusion
  (Evaluation.java:1106-1117) — an asymmetry kept for parity;
* falseAlarmRate = (macro FPR + macro FNR)/2 (Evaluation.java:975-978);
* per-record prediction metadata -> prediction-error listing
  (Evaluation.java:298, 1480-1530).

The port of ``deeplearning4j_tpu/eval/classification.py``, the same
classes, edge values and ``stats()`` text. Metrics accumulate on the host
in numpy: evaluation is a streaming reduction over minibatches. Inputs are
numpy arrays or tensors; a tensor on the card comes to the host once a
batch (``_host``), never once a row.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

MACRO = "macro"
MICRO = "micro"

DEFAULT_EDGE_VALUE = 0.0

Prediction = namedtuple("Prediction", ["actual", "predicted", "meta"])


def _host(a):
    """``a`` as a host numpy array (None stays None): one copy of the
    whole batch for a tensor, bfloat16 widened to float32 first."""
    if a is None or not torch.is_tensor(a):
        return a if a is None else np.asarray(a)
    a = a.detach()
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.cpu().numpy()


def _flatten_masked(preds, labels, mask):
    """[B,C] or [B,T,C] (+[B,T] mask) -> 2-D arrays of kept rows."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    if preds.ndim == 3:
        c = preds.shape[-1]
        preds = preds.reshape(-1, c)
        labels = labels.reshape(-1, c)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            preds, labels = preds[keep], labels[keep]
    elif mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0
        preds, labels = preds[keep], labels[keep]
    return preds, labels


def _ratio(num, den, edge):
    return num / den if den else edge


class ConfusionMatrix:
    """Dense integer confusion matrix (reference: eval/ConfusionMatrix.java),
    including the CSV / HTML table exports (ConfusionMatrix.java:145,192)."""

    def __init__(self, n_classes, class_names=None):
        self.n_classes = n_classes
        self.class_names = (list(class_names) if class_names
                            else [str(i) for i in range(n_classes)])
        self.matrix = np.zeros((n_classes, n_classes), np.int64)

    def add(self, actual, predicted, count=1):
        self.matrix[actual, predicted] += count

    def add_batch(self, actual, predicted):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual, predicted):
        return int(self.matrix[actual, predicted])

    def actual_total(self, i):
        return int(self.matrix[i, :].sum())

    def predicted_total(self, i):
        return int(self.matrix[:, i].sum())

    def total(self):
        return int(self.matrix.sum())

    def merge(self, other):
        self.matrix += other.matrix

    def to_csv(self):
        """Layout parity with ConfusionMatrix.toCSV: header of predicted
        classes + Total column, one row per actual class, totals row."""
        lines = [",," + ",".join(self.class_names) + ",Total"]
        first = "Actual Class"
        for i in range(self.n_classes):
            cells = ",".join(str(int(v)) for v in self.matrix[i])
            lines.append(f"{first},{self.class_names[i]},{cells},{self.actual_total(i)}")
            first = ""
        lines.append(",Total," + ",".join(
            str(self.predicted_total(j)) for j in range(self.n_classes)) + ",")
        return "\n".join(lines) + "\n"

    def to_html(self):
        """HTML table with the reference's CSS hook classes
        (empty-space / predicted-class-header / actual-class-header /
        count-element)."""
        n = self.n_classes
        rows = ["<table>",
                '<tr><th class="empty-space" colspan="2" rowspan="2"></th>'
                f'<th class="predicted-class-header" colspan="{n + 1}">'
                "Predicted Class</th></tr>",
                "<tr>" + "".join(f'<th class="predicted-class-header">{c}</th>'
                                 for c in self.class_names)
                + '<th class="predicted-class-header">Total</th></tr>']
        for i in range(n):
            lead = ""
            if i == 0:
                lead = (f'<th class="actual-class-header" rowspan="{n}">'
                        "Actual Class</th>")
            cells = "".join(f'<td class="count-element">{int(v)}</td>'
                            for v in self.matrix[i])
            rows.append(f'<tr>{lead}<th class="actual-class-header">'
                        f"{self.class_names[i]}</th>{cells}"
                        f'<td class="count-element">{self.actual_total(i)}</td></tr>')
        rows.append('<tr><td class="empty-space" colspan="2"></td>' + "".join(
            f'<td class="count-element">{self.predicted_total(j)}</td>'
            for j in range(n)) + '<td class="empty-space"></td></tr>')
        rows.append("</table>")
        return "\n".join(rows) + "\n"

    def __str__(self):
        """Aligned text table (reference: Evaluation.confusionToString)."""
        label_w = max(max(len(s) for s in self.class_names) + 5, 10)
        col_w = max(7, max(len(str(int(v))) for v in self.matrix.flat) + 2)
        out = [" " * (3 + label_w + 3)
               + "".join(str(j).rjust(col_w) for j in range(self.n_classes))
               + "   <-- Predicted"]
        out.append("   Actual:")
        for i in range(self.n_classes):
            row = "".join(str(int(v)).rjust(col_w) for v in self.matrix[i])
            out.append(f"{i:<3}{self.class_names[i]:<{label_w}} | {row}")
        return "\n".join(out)


class Evaluation:
    """Multi-class classification metrics, streaming over minibatches.

    Parameters mirror the reference constructors (Evaluation.java:120-190):
    ``labels`` (class names), ``top_n``, ``cost_array`` (row vector, argmax
    of cost*probability), ``binary_decision_threshold``.
    """

    def __init__(self, n_classes=None, labels=None, top_n=1, cost_array=None,
                 binary_decision_threshold=None):
        self.class_names = list(labels) if labels else None
        self.n_classes = n_classes or (len(labels) if labels else None)
        self.top_n = top_n
        if cost_array is not None:
            cost_array = np.asarray(cost_array, np.float64).reshape(-1)
            if cost_array.min() < 0:
                raise ValueError("cost_array values must be >= 0")
        self.cost_array = cost_array
        self.binary_threshold = binary_decision_threshold
        self.confusion = None
        self.top_n_correct = 0
        self.top_n_total = 0
        self.total_examples = 0
        self._meta = {}  # (actual, predicted) -> [meta, ...]

    def reset(self):
        self.confusion = None
        self.top_n_correct = 0
        self.top_n_total = 0
        self.total_examples = 0
        self._meta = {}

    def _ensure(self, c):
        if self.confusion is None:
            self.n_classes = self.n_classes or c
            self.confusion = ConfusionMatrix(self.n_classes, self.class_names)
            if self.class_names is None:
                self.class_names = self.confusion.class_names

    def eval(self, labels, predictions, mask=None, record_meta_data=None):
        """labels: one-hot [B,C] (or [B,T,C]); predictions: probabilities.

        Single-column labels/predictions are the binary case: class 1 iff
        p >= binary_decision_threshold (default 0.5), two-class confusion
        (Evaluation.java:324-351).
        """
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds, labels = _flatten_masked(predictions, labels, mask)
        if preds.ndim == 1:
            preds, labels = preds[:, None], labels[:, None]
        n_cols = preds.shape[-1]
        if n_cols == 1:
            thr = 0.5 if self.binary_threshold is None else self.binary_threshold
            self._ensure(2)
            actual = (labels.reshape(-1) >= 0.5).astype(np.int64)
            predicted = (preds.reshape(-1) >= thr).astype(np.int64)
        else:
            self._ensure(n_cols)
            actual = np.argmax(labels, -1)
            if self.binary_threshold is not None:
                if n_cols != 2:
                    raise ValueError(
                        "binary_decision_threshold requires 2 columns, got %d" % n_cols)
                predicted = (preds[:, 1] >= self.binary_threshold).astype(np.int64)
            elif self.cost_array is not None:
                predicted = np.argmax(preds * self.cost_array[None, :], -1)
            else:
                predicted = np.argmax(preds, -1)
        self.confusion.add_batch(actual, predicted)
        self.total_examples += len(actual)
        if record_meta_data is not None:
            for a, p, m in zip(actual, predicted, record_meta_data):
                self._meta.setdefault((int(a), int(p)), []).append(m)
        if self.top_n > 1 and n_cols > 1:
            # correct iff the count of strictly-greater probabilities < topN
            true_prob = np.take_along_axis(preds, actual[:, None], -1)
            greater = (preds > true_prob).sum(-1)
            self.top_n_correct += int((greater < self.top_n).sum())
            self.top_n_total += len(actual)
        else:
            self.top_n_correct += int(np.sum(actual == predicted))
            self.top_n_total += len(actual)

    def eval_single(self, predicted_idx, actual_idx):
        """One prediction at a time (Evaluation.java:461)."""
        if self.confusion is None:
            if self.n_classes is None:
                raise ValueError("eval_single requires n_classes up-front")
            self._ensure(self.n_classes)
        self.confusion.add(actual_idx, predicted_idx)
        self.total_examples += 1
        self.top_n_correct += int(predicted_idx == actual_idx)
        self.top_n_total += 1

    def merge(self, other):
        """Combine a partial evaluation (BaseEvaluation.merge contract —
        used by sharded/distributed evaluation)."""
        if other.confusion is None:
            return
        if self.confusion is None:
            self._ensure(other.n_classes)
        self.confusion.merge(other.confusion)
        self.total_examples += other.total_examples
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        for k, v in other._meta.items():
            self._meta.setdefault(k, []).extend(v)

    # ---- per-class counts (derived from the confusion matrix; equal to the
    # reference's incremental tp/fp/fn/tn counters) ----

    def true_positives(self, i):
        return int(self.confusion.matrix[i, i])

    def false_positives(self, i):
        return int(self.confusion.matrix[:, i].sum() - self.confusion.matrix[i, i])

    def false_negatives(self, i):
        return int(self.confusion.matrix[i, :].sum() - self.confusion.matrix[i, i])

    def true_negatives(self, i):
        return self.total_examples - self.true_positives(i) \
            - self.false_positives(i) - self.false_negatives(i)

    _tp = true_positives
    _fp = false_positives
    _fn = false_negatives

    def class_count(self, i):
        return self.confusion.actual_total(i)

    # ---- aggregate metrics ----

    def accuracy(self):
        if self.total_examples == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / self.total_examples

    def top_n_accuracy(self):
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def _sum_counts(self):
        tp = sum(self.true_positives(i) for i in range(self.n_classes))
        fp = sum(self.false_positives(i) for i in range(self.n_classes))
        fn = sum(self.false_negatives(i) for i in range(self.n_classes))
        tn = sum(self.true_negatives(i) for i in range(self.n_classes))
        return tp, fp, fn, tn

    def _macro(self, per_class_fn):
        """Macro average excluding classes whose metric is the 0/0 edge case
        (reference NOTE on precision(EvaluationAveraging))."""
        if self.total_examples == 0:
            return 0.0
        vals = [per_class_fn(i, None) for i in range(self.n_classes)]
        vals = [v for v in vals if v is not None]
        return float(np.mean(vals)) if vals else 0.0

    def precision(self, cls=None, edge_case=DEFAULT_EDGE_VALUE, averaging=MACRO):
        if cls is not None:
            tp, fp = self.true_positives(cls), self.false_positives(cls)
            return _ratio(tp, tp + fp, edge_case)
        if averaging == MICRO:
            tp, fp, _, _ = self._sum_counts()
            return _ratio(tp, tp + fp, DEFAULT_EDGE_VALUE)
        return self._macro(lambda i, e: self.precision(i, e))

    def recall(self, cls=None, edge_case=DEFAULT_EDGE_VALUE, averaging=MACRO):
        if cls is not None:
            tp, fn = self.true_positives(cls), self.false_negatives(cls)
            return _ratio(tp, tp + fn, edge_case)
        if averaging == MICRO:
            tp, _, fn, _ = self._sum_counts()
            return _ratio(tp, tp + fn, DEFAULT_EDGE_VALUE)
        return self._macro(lambda i, e: self.recall(i, e))

    def false_positive_rate(self, cls=None, edge_case=DEFAULT_EDGE_VALUE,
                            averaging=MACRO):
        if cls is not None:
            fp, tn = self.false_positives(cls), self.true_negatives(cls)
            return _ratio(fp, fp + tn, edge_case)
        if averaging == MICRO:
            _, fp, _, tn = self._sum_counts()
            return _ratio(fp, fp + tn, DEFAULT_EDGE_VALUE)
        return self._macro(lambda i, e: self.false_positive_rate(i, e))

    def false_negative_rate(self, cls=None, edge_case=DEFAULT_EDGE_VALUE,
                            averaging=MACRO):
        if cls is not None:
            fn, tp = self.false_negatives(cls), self.true_positives(cls)
            return _ratio(fn, fn + tp, edge_case)
        if averaging == MICRO:
            tp, _, fn, _ = self._sum_counts()
            return _ratio(fn, fn + tp, DEFAULT_EDGE_VALUE)
        return self._macro(lambda i, e: self.false_negative_rate(i, e))

    def false_alarm_rate(self):
        """(FPR + FNR) / 2 (Evaluation.java:975)."""
        return (self.false_positive_rate() + self.false_negative_rate()) / 2.0

    def f_beta(self, beta, cls=None, default_value=0.0, averaging=MACRO):
        if cls is not None:
            p = self.precision(cls, None)
            r = self.recall(cls, None)
            if p is None or r is None:
                return default_value
            d = beta * beta * p + r
            return _ratio((1 + beta * beta) * p * r, d, 0.0)
        if self.total_examples == 0:
            return float("nan")
        if self.n_classes == 2:
            # binary special case: report F-beta of class 1
            tp, fp, fn = (self.true_positives(1), self.false_positives(1),
                          self.false_negatives(1))
            p = _ratio(tp, tp + fp, 0.0)
            r = _ratio(tp, tp + fn, 0.0)
            return _ratio((1 + beta * beta) * p * r, beta * beta * p + r, 0.0)
        if averaging == MICRO:
            tp, fp, fn, _ = self._sum_counts()
            p = _ratio(tp, tp + fp, 0.0)
            r = _ratio(tp, tp + fn, 0.0)
            return _ratio((1 + beta * beta) * p * r, beta * beta * p + r, 0.0)
        vals = []
        for i in range(self.n_classes):
            v = self.f_beta(beta, i, None)
            if v is not None:
                vals.append(v)
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls=None, averaging=MACRO):
        if cls is not None:
            return self.f_beta(1.0, cls)
        return self.f_beta(1.0, averaging=averaging)

    def g_measure(self, cls=None, averaging=MACRO):
        """sqrt(precision * recall). Macro averages over ALL classes without
        0/0 exclusion — reference asymmetry (Evaluation.java:1106)."""
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return float(np.sqrt(p * r))
        if averaging == MICRO:
            tp, fp, fn, _ = self._sum_counts()
            p = _ratio(tp, tp + fp, DEFAULT_EDGE_VALUE)
            r = _ratio(tp, tp + fn, DEFAULT_EDGE_VALUE)
            return float(np.sqrt(p * r))
        return float(np.mean([self.g_measure(i) for i in range(self.n_classes)]))

    def _num_excluded(self, per_class_fn):
        return sum(1 for i in range(self.n_classes)
                   if per_class_fn(i, None) is None)

    def average_precision_num_classes_excluded(self):
        return self._num_excluded(lambda i, e: self.precision(i, e))

    def average_recall_num_classes_excluded(self):
        return self._num_excluded(lambda i, e: self.recall(i, e))

    def average_f1_num_classes_excluded(self):
        return sum(1 for i in range(self.n_classes)
                   if self.f_beta(1.0, i, None) is None)

    average_fbeta_num_classes_excluded = average_f1_num_classes_excluded

    def micro_precision(self):
        return self.precision(averaging=MICRO)

    def micro_recall(self):
        return self.recall(averaging=MICRO)

    def matthews_correlation(self, cls=None, averaging=MACRO):
        if cls is not None:
            tp, fp, fn = (self.true_positives(cls), self.false_positives(cls),
                          self.false_negatives(cls))
            tn = self.true_negatives(cls)
            denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            return (tp * tn - fp * fn) / denom if denom else 0.0
        if averaging == MICRO:
            tp, fp, fn, tn = self._sum_counts()
            denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            return (tp * tn - fp * fn) / denom if denom else 0.0
        return float(np.mean([self.matthews_correlation(i)
                              for i in range(self.n_classes)]))

    # ---- prediction metadata (Evaluation.java:1480-1530) ----

    def get_prediction_errors(self):
        """All misclassified Prediction records; requires eval(...,
        record_meta_data=...)."""
        out = []
        for (a, p), metas in sorted(self._meta.items()):
            if a != p:
                out.extend(Prediction(a, p, m) for m in metas)
        return out

    def get_predictions_by_actual_class(self, cls):
        out = []
        for (a, p), metas in sorted(self._meta.items()):
            if a == cls:
                out.extend(Prediction(a, p, m) for m in metas)
        return out

    def get_predictions_by_predicted_class(self, cls):
        out = []
        for (a, p), metas in sorted(self._meta.items()):
            if p == cls:
                out.extend(Prediction(a, p, m) for m in metas)
        return out

    def get_predictions(self, actual, predicted):
        return [Prediction(actual, predicted, m)
                for m in self._meta.get((actual, predicted), [])]

    # ---- reporting ----

    def confusion_to_string(self):
        return str(self.confusion)

    def stats(self, suppress_warnings=False):
        name = lambda i: (self.class_names[i] if self.class_names else str(i))
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes: {self.n_classes}",
                 f" Accuracy: {self.accuracy():.4f}",
                 f" Precision: {self.precision():.4f}",
                 f" Recall: {self.recall():.4f}",
                 f" F1 Score: {self.f1():.4f}"]
        if self.n_classes > 2:
            lines.append("Precision, recall & F1: macro-averaged (equally "
                         "weighted avg. of %d classes)" % self.n_classes)
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        if not suppress_warnings:
            for metric, n_ex in (
                    ("precision", self.average_precision_num_classes_excluded()),
                    ("recall", self.average_recall_num_classes_excluded())):
                if n_ex > 0:
                    lines.append(f" Warning: {n_ex} class(es) excluded from "
                                 f"average {metric} (0/0 edge case)")
        lines.append("\n=========================Confusion Matrix=========================")
        lines.append(str(self.confusion))
        lines.append("Per-class: " + ", ".join(
            f"{name(i)}: P={self.precision(i):.3f} R={self.recall(i):.3f} F1={self.f1(i):.3f}"
            for i in range(self.n_classes)))
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output independent binary evaluation for multi-label sigmoid
    outputs (reference: eval/EvaluationBinary.java), with optional decision
    threshold per output and per-output label names."""

    def __init__(self, n_outputs=None, thresholds=None, labels=None,
                 roc_binary_steps=None):
        """``roc_binary_steps``: when set (0 = exact mode, N = thresholded),
        a ROCBinary tracks per-output AUC alongside the counts — mirroring
        EvaluationBinary(int, Integer rocBinarySteps)."""
        self.n_outputs = n_outputs
        self.thresholds = thresholds
        self.labels = list(labels) if labels else None
        self.tp = None
        self.fp = None
        self.tn = None
        self.fn = None
        self._roc = None
        self._roc_steps = roc_binary_steps

    def _ensure(self, c):
        if self.tp is None:
            self.n_outputs = self.n_outputs or c
            z = lambda: np.zeros(self.n_outputs, np.int64)
            self.tp, self.fp, self.tn, self.fn = z(), z(), z(), z()

    def reset(self):
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions, mask = _host(labels), _host(predictions), _host(mask)
        preds, labels = _flatten_masked(predictions, labels, mask)
        self._ensure(preds.shape[-1])
        thr = self.thresholds if self.thresholds is not None else 0.5
        p = (preds >= thr).astype(np.int64)
        l = (labels >= 0.5).astype(np.int64)
        self.tp += ((p == 1) & (l == 1)).sum(0)
        self.fp += ((p == 1) & (l == 0)).sum(0)
        self.tn += ((p == 0) & (l == 0)).sum(0)
        self.fn += ((p == 0) & (l == 1)).sum(0)
        if self._roc_steps is not None:
            if self._roc is None:
                from deeplearning4j_tpu_torch.eval.roc import ROCBinary
                self._roc = ROCBinary(self._roc_steps)
            self._roc.eval(labels, preds)

    def auc(self, i):
        """Per-output AUC; requires roc_binary_steps at construction."""
        if self._roc is None:
            raise ValueError("construct with roc_binary_steps= to track AUC")
        return self._roc.auc(i)

    def average_auc(self):
        if self._roc is None:
            raise ValueError("construct with roc_binary_steps= to track AUC")
        return self._roc.average_auc()

    def merge(self, other):
        if other.tp is None:
            return
        self._ensure(other.n_outputs)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        if self._roc is not None and other._roc is not None:
            self._roc.merge(other._roc)

    def total_count(self, i):
        return int(self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i])

    def accuracy(self, i):
        tot = self.total_count(i)
        return float(self.tp[i] + self.tn[i]) / tot if tot else 0.0

    def precision(self, i):
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i]) / d if d else 0.0

    def recall(self, i):
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i]) / d if d else 0.0

    def false_positive_rate(self, i):
        d = self.fp[i] + self.tn[i]
        return float(self.fp[i]) / d if d else 0.0

    def false_negative_rate(self, i):
        d = self.fn[i] + self.tp[i]
        return float(self.fn[i]) / d if d else 0.0

    def f_beta(self, beta, i):
        p, r = self.precision(i), self.recall(i)
        d = beta * beta * p + r
        return (1 + beta * beta) * p * r / d if d else 0.0

    def f1(self, i):
        return self.f_beta(1.0, i)

    def g_measure(self, i):
        return float(np.sqrt(self.precision(i) * self.recall(i)))

    def matthews_correlation(self, i):
        tp, fp, fn, tn = (int(self.tp[i]), int(self.fp[i]),
                          int(self.fn[i]), int(self.tn[i]))
        denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (tp * tn - fp * fn) / denom if denom else 0.0

    def average_accuracy(self):
        return float(np.mean([self.accuracy(i) for i in range(self.n_outputs)]))

    def average_f1(self):
        return float(np.mean([self.f1(i) for i in range(self.n_outputs)]))

    def average_precision(self):
        return float(np.mean([self.precision(i) for i in range(self.n_outputs)]))

    def average_recall(self):
        return float(np.mean([self.recall(i) for i in range(self.n_outputs)]))

    def stats(self):
        name = lambda i: (self.labels[i] if self.labels else f"out {i}")
        return "\n".join(
            f"{name(i)}: acc={self.accuracy(i):.3f} P={self.precision(i):.3f} "
            f"R={self.recall(i):.3f} F1={self.f1(i):.3f} "
            f"(tp={int(self.tp[i])} fp={int(self.fp[i])} "
            f"fn={int(self.fn[i])} tn={int(self.tn[i])})"
            for i in range(self.n_outputs))
