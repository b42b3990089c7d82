"""Collectives of the data-parallel tier, and the batch group.

Tensor collectives over ``torch.distributed`` that the parallel trainers
and the TrainingMasters share: ``all_reduce_`` (in place), ``reduce_scatter``
and ``all_gather`` of flat buffers, and ``AllReduceSum``, a differentiable
all-reduce whose backward all-reduces the cotangent. Gloo carries CPU
tensors only: on a gloo group a CUDA tensor goes through a pinned host
buffer (chosen by backend, never by catching an error); NCCL carries it
directly.

The batch group: while a ``sync_batch(group)`` block is active, the ranks
of ``group`` hold the rows of one global batch, rank r the r-th equal
slice, and the ops whose result depends on the whole batch compute it over
the whole batch:

* batch statistics (``batch_moments``, and the fused conv's statistics in
  ``ops/conv_stats.py``) sum their per-rank partials across the group;
* a masked loss divides by the global count of valid rows
  (``masked_denominator``);
* random draws over a batch hash each element's global flat index
  (``row_offset``), so world N draws what world 1 draws.

Gradients follow one scaling: rank r differentiates its own loss, the mean
over its rows (N times its share of the global mean), the collectives'
backwards sum cotangents across the group, and the trainer averages the
parameter gradients across the group. The result is the gradient of the
global loss. ``ParallelTrainer`` opens the block around its forward and
backward at world > 1; the TrainingMasters never do (their workers keep
per-worker statistics).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch
import torch.distributed as dist


# ---------------------------------------------------------------------------
# tensor collectives
# ---------------------------------------------------------------------------

# the flat-buffer collectives under their newer names where torch has them
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def host_staged(x, group=None):
    """Whether ``x`` goes through host memory: a CUDA tensor on gloo."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _pinned(x):
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def all_reduce_(x, group=None, op=dist.ReduceOp.SUM):
    """``x`` all-reduced over ``group`` in place (``x`` contiguous);
    returns ``x``."""
    if host_staged(x, group):
        h = _pinned(x)
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h, non_blocking=True)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def reduce_scatter(flat, group=None):
    """[N * c] -> [c]: the sum over the group's ranks of their ``flat``
    buffers' chunk ``rank``."""
    n = dist.get_world_size(group)
    staged = host_staged(flat, group)
    send = _pinned(flat) if staged else flat.contiguous()
    out = torch.empty(send.numel() // n, dtype=send.dtype, device=send.device,
                      pin_memory=staged)
    _REDUCE_SCATTER(out, send, group=group)
    return out.to(flat.device, non_blocking=True) if staged else out


def all_gather(flat, group=None):
    """[c] -> [N * c]: the ranks' ``flat`` buffers in rank order."""
    n = dist.get_world_size(group)
    staged = host_staged(flat, group)
    send = _pinned(flat) if staged else flat.contiguous()
    out = torch.empty(n * send.numel(), dtype=send.dtype, device=send.device,
                      pin_memory=staged)
    _ALL_GATHER(out, send, group=group)
    return out.to(flat.device, non_blocking=True) if staged else out


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``; the backward sums the cotangent
    over the group (every rank's loss depends on every rank's ``x``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone().contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone().contiguous(), ctx.group), None


# ---------------------------------------------------------------------------
# the batch group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchGroup:
    """The ranks of ``group`` hold one global batch; this one is ``rank``
    of ``world`` and holds rows ``[rank * b, (rank + 1) * b)``."""

    group: object
    rank: int
    world: int


_ACTIVE = contextvars.ContextVar("batch_group", default=None)


def active():
    """The active ``BatchGroup``, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sync_batch(bg):
    """Run the block with ``bg`` (a ``BatchGroup`` or None: no group) as the
    active batch group."""
    token = _ACTIVE.set(bg)
    try:
        yield bg
    finally:
        _ACTIVE.reset(token)


def sum_over_batch(t, bg=None):
    """``t`` (a per-rank partial sum) summed over the active batch group,
    differentiably; ``t`` itself without one."""
    bg = bg or active()
    return t if bg is None else AllReduceSum.apply(t, bg.group)


def batch_moments(x, axes):
    """(mean, biased variance) of ``x`` over ``axes``, over the global
    batch when a batch group is active (two all-reduces: the mean, then the
    centred squares), else ``x.mean``/``x.var`` as before."""
    bg = active()
    if bg is None:
        return x.mean(dim=axes), x.var(dim=axes, correction=0)
    n = 1
    for a in axes:
        n *= x.shape[a]
    n *= bg.world
    mean = sum_over_batch(x.sum(dim=axes), bg) / n
    d = x - mean
    return mean, sum_over_batch((d * d).sum(dim=axes), bg) / n


def masked_denominator(count):
    """A masked loss's denominator, ``max(count, 1)`` for the local count
    of valid rows; with a batch group, ``max(global count, 1) / world``, so
    the mean over ranks of the ranks' losses is the global masked mean."""
    bg = active()
    if bg is None:
        return count.clamp_min(1.0)
    c = all_reduce_(count.detach().clone().contiguous(), bg.group)
    return c.clamp_min(1.0) / bg.world


def row_offset(x):
    """The flat index of this rank's first element of the batch-leading
    tensor ``x`` in the global batch (0 without a batch group)."""
    bg = active()
    return 0 if bg is None else bg.rank * x.numel()


# ---------------------------------------------------------------------------
# the model group (tensor and expert parallelism)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelGroup:
    """The ranks of ``group`` hold the same activations and each holds one
    slice of the split parameters: ``split`` maps ``id`` of a local
    parameter tensor to the dim it is split on, and ``apply(layer, params,
    state, x, mg, split=, train=, **kwargs)`` runs a layer whose leaves
    ``split`` ({key: dim}, ``split_of``) are split
    (``parallel/tensor_parallel.py tp_apply``). With ``timed`` (eager
    steps only: it synchronizes the card) the milliseconds of the forward
    collectives accumulate in ``spent_ms`` under their kind."""

    group: object
    rank: int
    world: int
    split: dict = dataclasses.field(default_factory=dict)
    apply: object = None
    timed: bool = False
    spent_ms: dict = dataclasses.field(default_factory=dict)

    def split_of(self, params):
        """{key: split dim} of the leaves of ``params`` (a layer's dict)
        split here; empty when none is (a nested sub-dict never is)."""
        if not hasattr(params, "items"):
            return {}
        return {k: self.split[id(t)] for k, t in params.items()
                if not hasattr(t, "items") and id(t) in self.split}

    def timed_call(self, kind, fn, x):
        if not self.timed:
            return fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.spent_ms[kind] = self.spent_ms.get(kind, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out


_MODEL = contextvars.ContextVar("model_group", default=None)


def active_model():
    """The active ``ModelGroup``, or None."""
    return _MODEL.get()


@contextlib.contextmanager
def sync_model(mg):
    """Run the block with ``mg`` (a ``ModelGroup`` or None) as the active
    model group."""
    token = _MODEL.set(mg)
    try:
        yield mg
    finally:
        _MODEL.reset(token)


def gather_dim(x, dim, group):
    """The ranks' ``x`` concatenated on ``dim`` in rank order (one
    all-gather)."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    flat = all_gather(moved.reshape(-1), group).view((n,) + tuple(moved.shape))
    return flat.reshape((n * moved.shape[0],) + tuple(moved.shape[1:])).movedim(0, dim)


def local_slice(x, dim, rank, world):
    c = x.shape[dim] // world
    return x.narrow(dim, rank * c, c)


class PsumIdBwd(torch.autograd.Function):
    """``g`` of the Megatron pair: the forward sums the ranks' partial
    ``x`` over ``group``; the backward passes the cotangent through (every
    rank holds the same downstream cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone().contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class IdPsumBwd(torch.autograd.Function):
    """``f`` of the Megatron pair: the forward is the identity on a
    replicated activation; the backward sums the ranks' partial cotangents
    over ``group`` (each rank saw only its own columns, heads or
    experts)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone().contiguous(), ctx.group), None


class GatherSliceBwd(torch.autograd.Function):
    """The ranks' slices of a tensor gathered whole on ``dim``; the
    backward takes this rank's slice of the cotangent (the same on every
    rank, so summing it would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.world = dim, dist.get_rank(group), dist.get_world_size(group)
        return gather_dim(x.detach(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.rank, ctx.world).contiguous(), None, None
