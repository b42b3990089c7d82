"""CSV record readers: the DataVec CSVRecordReader family's role, the
port's copy of ``deeplearning4j_tpu/datasets/records.py``.

``read_csv_records`` and ``csv_dataset`` read one column-labelled CSV (the
RecordReaderDataSetIterator contract: a label column, one-hot with
``n_classes``); ``CSVSequenceRecordReader`` and ``sequence_dataset`` read
one sequence a file and pad a batch to the longest with explicit [B, T]
masks (the SequenceRecordReaderDataSetIterator contract, ALIGN_END as
``align="end"``). numpy on the host.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def read_csv_records(path, *, skip_lines=0, delimiter=","):
    """[N, C] float array from one CSV file (CSVRecordReader)."""
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip_lines:
                continue
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(delimiter)])
    if not rows:
        raise ValueError(f"{path}: no data rows "
                         f"(skip_lines={skip_lines} consumed everything?)")
    return np.asarray(rows, np.float32)


def csv_dataset(path, *, label_column=-1, n_classes=None, skip_lines=0,
                delimiter=","):
    """(features [N, F], labels) from a column-labelled CSV — the
    RecordReaderDataSetIterator(reader, batch, labelIdx, numClasses)
    contract. Integer labels one-hot when ``n_classes`` is given."""
    arr = read_csv_records(path, skip_lines=skip_lines, delimiter=delimiter)
    if label_column is None:
        return arr, None
    lab = arr[:, label_column]
    feats = np.delete(arr, label_column, axis=1)
    if n_classes:
        lab = _one_hot(lab, n_classes, path)
    return feats, lab


def _one_hot(values, n_classes, source):
    ids = np.asarray(values).astype(int).reshape(-1)
    if ids.min(initial=0) < 0 or ids.max(initial=0) >= n_classes:
        bad = ids[(ids < 0) | (ids >= n_classes)][0]
        raise ValueError(f"{source}: label {bad} outside [0, {n_classes})")
    return np.eye(n_classes, dtype=np.float32)[ids]


class CSVSequenceRecordReader:
    """One sequence per file: [T, C] float arrays
    (CSVSequenceRecordReader(numLinesToSkip, delimiter))."""

    def __init__(self, skip_lines=0, delimiter=","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def read(self, path):
        return read_csv_records(path, skip_lines=self.skip_lines,
                                delimiter=self.delimiter)

    def read_all(self, paths_or_glob):
        if isinstance(paths_or_glob, str):
            paths = sorted(glob.glob(paths_or_glob)) \
                if any(ch in paths_or_glob for ch in "*?[") else \
                sorted(glob.glob(os.path.join(paths_or_glob, "*")))
        else:
            paths = list(paths_or_glob)
        return [self.read(p) for p in paths]


def sequence_dataset(feature_files, label_files, *, n_classes=None,
                     skip_lines=0, delimiter=",",
                     regression=False, align="equal"):
    """(features [B, T, F], labels [B, T, C], feature_mask [B, T],
    label_mask [B, T]) from parallel per-sequence feature/label file
    lists — the SequenceRecordReaderDataSetIterator contract (features
    file i pairs with labels file i). Classification labels (one int per
    timestep) one-hot; ``regression=True`` keeps raw label columns.

    ``align``:
    * ``"equal"`` — every pair must have matching lengths (the
      reference's default; mismatch is an error);
    * ``"end"`` — shorter label sequences align to the END of their
      features (AlignmentMode.ALIGN_END — many-to-one sequence
      classification; the reference's csvsequencelabelsShort fixtures
      pair with csvsequence exactly this way), label_mask marking only
      the aligned steps.
    Variable-length sequences pad to the longest with mask=0 past each
    end."""
    if align not in ("equal", "end"):
        raise ValueError(f"unknown align {align!r}")
    if not regression and not n_classes:
        raise ValueError("n_classes is required for classification labels "
                         "(or pass regression=True)")
    rr = CSVSequenceRecordReader(skip_lines, delimiter)
    feats = rr.read_all(feature_files)
    labs = rr.read_all(label_files)
    if not feats:
        raise ValueError(f"no feature sequences found for {feature_files!r}")
    if len(feats) != len(labs):
        raise ValueError(f"{len(feats)} feature sequences vs "
                         f"{len(labs)} label sequences")
    for i, (x, y) in enumerate(zip(feats, labs)):
        if align == "equal" and len(x) != len(y):
            raise ValueError(f"sequence {i}: {len(x)} feature steps vs "
                             f"{len(y)} label steps (use align='end' for "
                             "many-to-one label files)")
        if len(y) > len(x):
            raise ValueError(f"sequence {i}: more label steps ({len(y)}) "
                             f"than feature steps ({len(x)})")
    b = len(feats)
    t_max = max(len(x) for x in feats)
    f_dim = feats[0].shape[1]
    x_out = np.zeros((b, t_max, f_dim), np.float32)
    feat_mask = np.zeros((b, t_max), np.float32)
    y_dim = labs[0].shape[1] if regression else n_classes
    y_out = np.zeros((b, t_max, y_dim), np.float32)
    lab_mask = np.zeros((b, t_max), np.float32)
    for i, (x, y) in enumerate(zip(feats, labs)):
        t = len(x)
        x_out[i, :t] = x
        feat_mask[i, :t] = 1.0
        start = t - len(y)  # 0 under align="equal"
        yy = y if regression else _one_hot(y[:, 0], n_classes,
                                           f"sequence {i}")
        y_out[i, start:t] = yy
        lab_mask[i, start:t] = 1.0
    return x_out, y_out, feat_mask, lab_mask
