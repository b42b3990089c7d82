"""Time-series and masking helpers: the port of
``deeplearning4j_tpu/utils/timeseries.py`` (reference: TimeSeriesUtils.java
and MaskedReductionUtil.java).

Time series are [batch, time, features] and images NHWC, as everywhere
in the port. Inputs may be numpy arrays or tensors; results are tensors
(on the input's device). Masked max pooling ignores masked steps even
when every value is negative.
"""

from __future__ import annotations

import torch

_NEG_INF = -3.4e38  # below any f32/bf16 activation


def _t(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def moving_average(x, n):
    """Trailing moving average over the last axis of a 1-D or 2-D array;
    the output is n - 1 shorter (TimeSeriesUtils.movingAverage)."""
    c = torch.cumsum(_t(x).to(torch.float32), dim=-1)
    return torch.cat([c[..., n - 1:n], c[..., n:] - c[..., :-n]], dim=-1) / n


def reshape_3d_to_2d(x):
    """[B, T, F] -> [B*T, F]"""
    b, t, f = x.shape
    return _t(x).reshape(b * t, f)


def reshape_2d_to_3d(x, minibatch_size):
    """[B*T, F] -> [B, T, F]"""
    n, f = x.shape
    return _t(x).reshape(minibatch_size, n // minibatch_size, f)


def reshape_time_series_mask_to_vector(mask):
    """[B, T] -> [B*T], row-major as ``reshape_3d_to_2d``."""
    return _t(mask).reshape(-1)


def reshape_vector_to_time_series_mask(vec, minibatch_size):
    """[B*T] -> [B, T]"""
    v = _t(vec)
    return v.reshape(minibatch_size, v.shape[0] // minibatch_size)


def _last_valid(m):
    """[B] index of each row's last nonzero step (0 for an empty row)."""
    t = m.shape[1]
    first_from_end = torch.argmax((m.flip(1) > 0).to(torch.int32), dim=1)
    return torch.clamp(t - 1 - first_from_end, min=0)


def pull_last_time_step(x, mask=None):
    """[B, T, F] -> [B, F]: each example's last unmasked step."""
    x = _t(x)
    if mask is None:
        return x[:, -1]
    idx = _last_valid(_t(mask).to(x.device))
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


def reverse_time_series(x, mask=None):
    """Reverse along time; with a mask each example's valid prefix reverses
    in place and the padding stays at the tail."""
    x = _t(x)
    if mask is None:
        return x.flip(1)
    m = _t(mask).to(x.device) > 0
    lengths = m.sum(dim=1).to(torch.int64)[:, None]           # [B, 1]
    pos = torch.arange(x.shape[1], device=x.device)[None, :]  # [1, T]
    src = torch.where(pos < lengths, lengths - 1 - pos, pos)  # [B, T]
    return torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[2]))


def _masked_pool(pooling_type, x, m, dims):
    if pooling_type == "max":
        return torch.amax(torch.where(m, x, torch.full_like(x, _NEG_INF)), dim=dims)
    if pooling_type == "sum":
        return torch.sum(torch.where(m, x, torch.zeros_like(x)), dim=dims)
    if pooling_type == "avg":
        s = torch.sum(torch.where(m, x, torch.zeros_like(x)), dim=dims)
        return s / torch.clamp(m.sum(dim=dims), min=1)
    if pooling_type == "pnorm":
        p = 2.0
        s = torch.sum(torch.where(m, x.abs() ** p, torch.zeros_like(x)), dim=dims)
        return s ** (1.0 / p)
    raise ValueError(f"Unknown pooling type {pooling_type!r}")


def masked_pooling_time_series(pooling_type, x, mask):
    """[B, T, F] + [B, T] -> [B, F] (MaskedReductionUtil
    .maskedPoolingTimeSeries: sum, avg, max, pnorm with p = 2)."""
    x = _t(x)
    return _masked_pool(pooling_type, x, (_t(mask).to(x.device) > 0)[..., None], (1,))


def masked_pooling_convolution(pooling_type, x, mask):
    """[B, H, W, C] + [B, H, W] -> [B, C] (maskedPoolingConvolution)."""
    x = _t(x)
    return _masked_pool(pooling_type, x, (_t(mask).to(x.device) > 0)[..., None], (1, 2))
