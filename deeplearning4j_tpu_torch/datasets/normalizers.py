"""Dataset normalizers: the ND4J DataNormalization family, the port's copy
of ``deeplearning4j_tpu/datasets/normalizers.py``.

``NormalizerStandardize`` (per-feature z-score), ``NormalizerMinMaxScaler``
(per-feature affine to [lo, hi]) and ``ImagePreProcessingScaler`` (fixed
0-255 pixel scaling). Fitting is numpy on the host, one streaming pass
over a DataSetIterator (a numerically stable merge of per-batch moments,
Chan et al., in float64); ``transform``/``revert`` are elementwise numpy
and run in the input pipeline. Statistics are computed over ALL leading axes (batch,
time, spatial), per trailing feature channel: per column for 2-d data,
per channel for NHWC images. A fitted normalizer rides inside a
checkpoint zip as ``normalizer.json`` (``utils/serialization.py
add_normalizer_to_model``), the JAX package's entry, so a zip written by
either package restores its normalizer in the other.
"""

from __future__ import annotations

import json

import numpy as np


class _FittedNormalizer:
    """Shared fit-over-iterator plumbing + serde."""

    _KIND = None  # subclass tag for serde

    def fit_iterator(self, iterator):
        """One pass over a DataSetIterator-style iterable of (x, y) (or
        objects with .features/.labels), like DataNormalization.fit(iter)."""
        for batch in iterator:
            x = getattr(batch, "features", None)
            if x is None:
                x = batch[0]
            self.partial_fit(np.asarray(x))
        return self

    # --- serde (JSON — see utils/serialization.add_normalizer_to_model) ---
    def to_json(self):
        return json.dumps({"kind": self._KIND, **self._state()})

    @staticmethod
    def from_json(s):
        d = json.loads(s)
        kinds = {c._KIND: c for c in
                 (NormalizerStandardize, NormalizerMinMaxScaler,
                  ImagePreProcessingScaler)}
        cls = kinds[d.pop("kind")]
        return cls._from_state(d)


class NormalizerStandardize(_FittedNormalizer):
    """Per-feature z-score: (x - mean) / std.

    Reference: org.nd4j.linalg.dataset.api.preprocessor
    .NormalizerStandardize — streaming fit, transform, revert. Batches
    merge by Chan's parallel-Welford update on (n, mean, M2): the naive
    sumsq/n - mean^2 form catastrophically cancels for large-offset
    features (a timestamp column ~1.7e9 with std ~1 would zero out)."""

    _KIND = "standardize"

    def __init__(self):
        self._n = 0
        self._mean = None   # running per-feature mean (float64)
        self._m2 = None     # running per-feature sum of squared deviations
        self.mean = None
        self.std = None

    def fit(self, x):
        self._n, self._mean, self._m2 = 0, None, None
        self.partial_fit(x)
        return self

    def partial_fit(self, x):
        flat = np.asarray(x, np.float64).reshape(-1, np.shape(x)[-1])
        n_b = flat.shape[0]
        mean_b = flat.mean(0)
        m2_b = ((flat - mean_b) ** 2).sum(0)
        if self._mean is None:
            self._n, self._mean, self._m2 = n_b, mean_b, m2_b
        else:
            n_ab = self._n + n_b
            delta = mean_b - self._mean
            self._mean = self._mean + delta * (n_b / n_ab)
            self._m2 = (self._m2 + m2_b
                        + delta * delta * (self._n * n_b / n_ab))
            self._n = n_ab
        self.mean = self._mean.astype(np.float32)
        # the reference floors std to avoid divide-by-zero on constant cols
        self.std = np.sqrt(self._m2 / self._n).astype(np.float32)
        self.std = np.where(self.std < 1e-7, 1.0, self.std)
        return self

    def transform(self, x):
        return (x - self.mean) / self.std

    def revert(self, x):
        return x * self.std + self.mean

    def _state(self):
        return {"mean": self.mean.tolist(), "std": self.std.tolist(),
                "n": self._n,
                "running_mean": np.asarray(self._mean).tolist(),
                "m2": np.asarray(self._m2).tolist()}

    @classmethod
    def _from_state(cls, d):
        self = cls()
        self.mean = np.asarray(d["mean"], np.float32)
        self.std = np.asarray(d["std"], np.float32)
        self._n = d["n"]
        self._mean = np.asarray(d["running_mean"], np.float64)
        self._m2 = np.asarray(d["m2"], np.float64)
        return self


class NormalizerMinMaxScaler(_FittedNormalizer):
    """Per-feature affine map of the observed [min, max] onto [lo, hi]
    (default [0, 1]). Reference: NormalizerMinMaxScaler."""

    _KIND = "minmax"

    def __init__(self, lo=0.0, hi=1.0):
        self.lo, self.hi = float(lo), float(hi)
        self.data_min = None
        self.data_max = None

    def fit(self, x):
        self.data_min = self.data_max = None
        self.partial_fit(x)
        return self

    def partial_fit(self, x):
        x = np.asarray(x, np.float64)
        flat = x.reshape(-1, x.shape[-1])
        mn, mx = flat.min(0), flat.max(0)
        if self.data_min is None:
            self.data_min, self.data_max = mn, mx
        else:
            self.data_min = np.minimum(self.data_min, mn)
            self.data_max = np.maximum(self.data_max, mx)
        return self

    def _scale(self):
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        return ((self.hi - self.lo) / rng).astype(np.float32)

    def transform(self, x):
        return (x - self.data_min.astype(np.float32)) * self._scale() + self.lo

    def revert(self, x):
        return (x - self.lo) / self._scale() + self.data_min.astype(np.float32)

    def _state(self):
        return {"lo": self.lo, "hi": self.hi,
                "min": np.asarray(self.data_min).tolist(),
                "max": np.asarray(self.data_max).tolist()}

    @classmethod
    def _from_state(cls, d):
        self = cls(d["lo"], d["hi"])
        self.data_min = np.asarray(d["min"], np.float64)
        self.data_max = np.asarray(d["max"], np.float64)
        return self


class ImagePreProcessingScaler(_FittedNormalizer):
    """Fixed pixel scaling 0-255 -> [lo, hi] (default [0, 1]); no fit
    needed. Reference: ImagePreProcessingScaler (maxBits=8)."""

    _KIND = "image"

    def __init__(self, lo=0.0, hi=1.0, max_pixel=255.0):
        self.lo, self.hi = float(lo), float(hi)
        self.max_pixel = float(max_pixel)

    def fit(self, x):  # stateless — parity with the reference's no-op fit
        return self

    def partial_fit(self, x):
        return self

    def transform(self, x):
        return x / self.max_pixel * (self.hi - self.lo) + self.lo

    def revert(self, x):
        return (x - self.lo) / (self.hi - self.lo) * self.max_pixel

    def _state(self):
        return {"lo": self.lo, "hi": self.hi, "max_pixel": self.max_pixel}

    @classmethod
    def _from_state(cls, d):
        return cls(d["lo"], d["hi"], d["max_pixel"])
