"""Per-kernel config spaces of the Hopper kernels, with static pruning.

The port of ``deeplearning4j_tpu/tuning/space.py``. A config is the set of
``plan()`` fields a compiled library takes at run time, so a candidate is
a launch plan and tuning never rebuilds a library. Nothing of the TPU
carries over (no (8, 128) tile rule, no VMEM budget); the spaces are the
libraries' own:

* ``conv_matmul`` / ``conv3x3`` (``csrc/conv_stats.cu``): the tile
  ``(bm, bn)`` among the variant's compiled ones (``compiled()`` in the
  source; ``ops/conv_stats.TILES``) and the persistent grid's
  ``blocks_per_sm``. The variant follows dtype and alignment, as
  ``plan()`` says.
* ``lstm`` (``csrc/lstm_seq.cu``): ``persistent`` at rows per lane ``rt``
  in ``P_ROWS_PER_LANE``, or ``step_cluster`` at cluster size ``split``.
* ``attention`` (``csrc/flash_attn.cu``): the variant among those the
  dtype has, and ``{"backend": "plain"}``, the naive path, as the measured
  alternative to the kernel (the JAX package's ``{"backend": "xla"}``).

``validate`` rejects, each with its reason (the ops modules'
``configured``): a tile or size the library has not compiled; shared
memory above ``SMEM_LIMIT``; blocks an SM beyond its shared memory; for
``persistent``, a grid that cannot be co-resident (the cooperative launch
refuses one: ``occupancy`` on the card, ``plan()``'s arithmetic on the
CPU); a variant whose alignment or stride rule the call breaks; a split
that leaves a rank no work. ``prune`` also drops a config that launches as
another one does (a conv grid that clamps to the same tiles), keeping the
default's. Every default ``plan()`` validates, so nothing that can fault
reaches a launch.
"""

from __future__ import annotations

import itertools

import torch

from deeplearning4j_tpu_torch.ops import _plans

#: shared memory one block may take on sm_90 (bytes)
SMEM_LIMIT = 232_448

#: searchable dimensions per kernel id; a config is one combination
SPACES = {
    "conv_matmul": {"bm": (64, 128), "bn": (64, 128), "blocks_per_sm": (0, 1, 2, 4)},
    "conv3x3": {"bm": (64, 128), "bn": (64, 128), "blocks_per_sm": (0, 1, 2, 4)},
    "lstm": {"persistent": {"rt": (1, 2, 4)}, "step_cluster": {"split": (1, 2, 4, 8)}},
    "attention": {"variant": ("f32_3xtf32_wgmma", "f32_3xtf32", "f32_3xtf32_unaligned",
                              "bf16_wgmma", "bf16_unaligned")},
}


def as_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _plans.DTYPES[_plans.dtype_name(getattr(dtype, "name", dtype))]


def enumerate_space(kernel):
    """Every candidate config dict in ``kernel``'s space. ``attention``
    adds ``{"backend": "plain"}``, the naive path."""
    if kernel == "lstm":
        return [{"variant": v, **dict(zip(dims, vals))}
                for v, dims in SPACES["lstm"].items()
                for vals in itertools.product(*dims.values())]
    if kernel == "attention":
        return ([{"backend": "flash", "variant": v} for v in SPACES["attention"]["variant"]]
                + [{"backend": "plain"}])
    dims = SPACES[kernel]
    keys = sorted(dims)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(dims[k] for k in keys))]


def _plan(kernel, config, shape, dtype, *, aligned=True, strides=None, sms=None,
          occupancy=None):
    """The plan ``config`` gives at ``shape`` (a NamedTuple), ``None`` for
    the attention space's ``plain`` backend, or the reason string."""
    dtype = as_torch_dtype(dtype)
    shape = tuple(int(d) for d in shape)
    if kernel in ("conv_matmul", "conv3x3"):
        from deeplearning4j_tpu_torch.ops import conv_stats as _cs
        m = shape[0] if kernel == "conv_matmul" else shape[0] * shape[1] * shape[2]
        return _cs.configured(m, shape[-2], shape[-1], dtype, aligned,
                              sms or _cs.H100_SMS, config)
    if kernel == "lstm":
        from deeplearning4j_tpu_torch.ops import lstm_seq as _ls
        _t, b, h = shape
        return _ls.configured(b, h, dtype, sms or _ls.H100_SMS, config, occupancy)
    if kernel == "attention":
        if isinstance(config, dict) and config.get("backend") == "plain":
            return None
        from deeplearning4j_tpu_torch.ops import attention as _at
        return _at.configured(shape, dtype, strides, aligned, config)
    raise KeyError(f"unknown kernel {kernel!r}; known: {sorted(SPACES)}")


def validate(kernel, config, shape, dtype, *, aligned=True, strides=None, sms=None,
             occupancy=None):
    """None when ``config`` may launch at ``shape``/``dtype``; otherwise
    the human-readable rejection reason. ``aligned`` (16-byte pointers),
    ``strides`` (attention's three (batch, time, head) stride triples),
    ``sms`` and ``occupancy`` (rt -> resident persistent blocks an SM, the
    card's) describe the call; their defaults are a contiguous call on an
    H100 with ``plan()``'s arithmetic."""
    out = _plan(kernel, config, shape, dtype, aligned=aligned, strides=strides, sms=sms,
                occupancy=occupancy)
    return out if isinstance(out, str) else None


def default_config(kernel, shape, dtype, *, aligned=True, strides=None, sms=None):
    """The config of the hand-picked ``plan()`` at this call."""
    dtype = as_torch_dtype(dtype)
    shape = tuple(int(d) for d in shape)
    if kernel in ("conv_matmul", "conv3x3"):
        from deeplearning4j_tpu_torch.ops import conv_stats as _cs
        if kernel == "conv_matmul":
            n, cin, cout = shape
            pl = _cs.plan(1, (n, 1, 1, cin), cout, (1, 1), dtype, sms or _cs.H100_SMS, aligned)
        else:
            b, h, w, cin, cout = shape
            pl = _cs.plan(3, (b, h, w, cin), cout, (1, 1), dtype, sms or _cs.H100_SMS, aligned)
        return _cs.config_of(pl)
    if kernel == "lstm":
        from deeplearning4j_tpu_torch.ops import lstm_seq as _ls
        _t, b, h = shape
        return _ls.config_of(_ls.plan(b, h, dtype, sms or _ls.H100_SMS))
    if kernel == "attention":
        from deeplearning4j_tpu_torch.ops import attention as _at
        return _at.config_of(_at.plan(shape, dtype, strides, aligned))
    raise KeyError(f"unknown kernel {kernel!r}; known: {sorted(SPACES)}")


def _launches_as(kernel, pl):
    """What a plan hands the launch: two configs with equal values launch
    alike (a conv grid clamped to the tiles whatever blocks an SM)."""
    if pl is None:
        return ("plain",)
    if kernel in ("conv_matmul", "conv3x3"):
        return (pl.variant, pl.bm, pl.bn, pl.stages, pl.grid)
    return tuple(pl)


def prune(kernel, configs, shape, dtype, *, keep=None, **call):
    """Split ``configs`` into (valid, rejected), rejected carrying
    ``(config, reason)`` pairs: ``validate``'s refusals, and configs that
    launch as an earlier valid one does (``keep``, the default config,
    stands for its group wherever it is listed). ``call``: ``validate``'s
    keywords."""
    planned = [(cfg, _plan(kernel, cfg, shape, dtype, **call)) for cfg in configs]
    rep = {}
    if keep is not None:
        pl = _plan(kernel, keep, shape, dtype, **call)
        if not isinstance(pl, str):
            rep[_launches_as(kernel, pl)] = keep
    valid, rejected = [], []
    for cfg, pl in planned:
        if isinstance(pl, str):
            rejected.append((cfg, pl))
            continue
        first = rep.setdefault(_launches_as(kernel, pl), cfg)
        if first is not cfg and first != cfg:
            rejected.append((cfg, f"redundant: launches as {first}"))
        else:
            valid.append(cfg)
    return valid, rejected
