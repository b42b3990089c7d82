"""Sequence/context parallelism: ring and Ulysses attention over
``torch.distributed``.

The port of ``deeplearning4j_tpu/parallel/sequence.py``. A sequence is
sharded over the ranks of a process group on the time axis ([B, T/P, H, D]
a rank) and attention is computed exactly:

* ``ring_self_attention``: K/V blocks rotate around the ring (Liu et al.,
  ring attention) and each rank combines its query block's attention to
  every K/V block by log-sum-exp. A block is ``ops.attention.
  flash_attention_block`` (the flash kernel on CUDA tensors, its plain
  version on CPU tensors) or the naive ``_naive_block``; the diagonal block
  comes first and is the only one with an intra-block causal mask, while an
  off-diagonal block under causal masking is all or nothing (visible iff it
  came from an earlier rank).
* ``ulysses_self_attention``: an all-to-all gathers the time axis and
  scatters the heads (DeepSpeed-Ulysses), each rank attends over the whole
  T for H/P heads (``dot_product_attention``, so the flash kernel from
  ``MIN_SEQ``), and the inverse all-to-all brings the time shards back.
* ``make_ring_attention_fn(mesh)``: the JAX function's ``shard_map`` form.
  It takes the full [B, T, H, D] q, k, v (the same on every rank of the
  mesh's ``seq`` group), runs the ring on this rank's T/P slice, and
  returns the full output, gathered. Its gradients are the replicated
  ones: every rank gets the full dq, dk, dv of the (same) loss.

The backward is autograd through the loop, as JAX differentiates through
``fori_loop`` + ``ppermute``: the blocks' backward with their lse cotangent,
the combine, and two differentiable collectives written here, which
``torch.distributed`` lacks: ``ppermute`` (``dist.batch_isend_irecv``; its
backward is the inverse permutation) and ``all_to_all``
(``dist.all_to_all_single``; its backward is the inverse all-to-all). K and
V travel as one stacked message, so no two collectives of a step can be
matched out of order between ranks. Gloo carries CPU tensors only: on a
gloo group, CUDA tensors go through pinned host buffers (by backend, never
by catching an error); NCCL carries them directly. The attention itself
never leaves the tensors' device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.layers.attention import dot_product_attention
from deeplearning4j_tpu_torch.ops import attention as _flash
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes

_INF = math.inf


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block_attn(q, k, v, *, scale, block_mask=None):
    """Blockwise logits and numerator for the online softmax. q: [B,Tq,H,D],
    k, v: [B,Tk,H,D]. Returns (m [B,H,Tq] the block's row max, 0 on a fully
    masked row; num [B,Tq,H,D]; den [B,H,Tq]). Products in the compute
    dtype with the accumulation dtype's sums."""
    cd, ad = _dtypes.compute_dtypes_for(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(cd).to(ad), k.to(cd).to(ad)) * scale
    if block_mask is not None:
        logits = torch.where(block_mask, logits, -_INF)
    m_blk = logits.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m_blk), m_blk, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isfinite(logits), p, 0.0)
    den = p.sum(dim=-1)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(cd).to(ad), v.to(cd).to(ad))
    return m_safe, num, den


def _naive_block(q, k, v, scale, block_mask):
    """(out_b [B,Tq,H,D] f32, lse_b [B,H,Tq]) of one block pair through the
    materialized logits; a fully masked row has out 0 and lse -inf."""
    m_safe, num, den = _block_attn(q, k, v, scale=scale, block_mask=block_mask)
    den_safe = den.clamp_min(1e-30)
    out = num.float() / den_safe.transpose(1, 2)[..., None]
    lse = torch.where(den > 0, m_safe + torch.log(den_safe), -_INF)
    return out, lse


def _use_flash_blocks(q):
    """The JAX package's rule: flash blocks wherever the kernel runs (a
    CUDA tensor) and takes the shape. No length threshold: on an H100 the
    flash block's forward + backward against the naive block's (B=2, H=8,
    D=64, f32) was 1.48x as fast at T_local = 256, 0.96x at 1024 and 1.32x
    at 4096 (chip_smoke's ``sequence.blocks``, PERF.md)."""
    return q.is_cuda and _flash.supported(tuple(q.shape), q.dtype)


def _combine(acc, lse_run, out_b, lse_b):
    """(acc, lse) after adding block (out_b, lse_b) to the running pair by
    log-sum-exp. An lse of -inf is an absent block (weight 0); the kernel's
    ``NEG_INF`` sentinel of a fully masked row is a finite lse whose block
    output is 0, which adds nothing either. Every -inf is kept out of the
    arithmetic with ``where`` on both sides, so no gradient turns NaN
    (``torch.logaddexp(-inf, -inf)``'s would)."""
    fin_run, fin_b = torch.isfinite(lse_run), torch.isfinite(lse_b)
    neither = ~(fin_run | fin_b)
    lse_new = torch.where(neither, -_INF, torch.logaddexp(torch.where(neither, 0.0, lse_run),
                                                          torch.where(neither, 0.0, lse_b)))
    safe_new = torch.where(neither, 0.0, lse_new)
    w_old = torch.where(fin_run, torch.exp(torch.where(fin_run, lse_run, 0.0) - safe_new), 0.0)
    w_new = torch.where(fin_b, torch.exp(torch.where(fin_b, lse_b, 0.0) - safe_new), 0.0)
    acc = acc * w_old.transpose(1, 2)[..., None] + out_b * w_new.transpose(1, 2)[..., None]
    return acc, lse_new


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

def _host_staged(x, group):
    """Whether ``x`` goes through host memory: a CUDA tensor on gloo."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _buffer(like, staged):
    """An empty contiguous tensor of ``like``'s shape and dtype: in pinned
    host memory when staged, else on ``like``'s device."""
    if staged:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _pinned(x):
    return _buffer(x, True).copy_(x)


def _global_rank(group, r):
    return dist.get_process_group_ranks(group or dist.group.WORLD)[r]


def _permute(x, perm, group):
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if dst == [me]:
        return x.clone()
    staged = _host_staged(x, group)
    send = _pinned(x) if staged else x.contiguous()
    recv = _buffer(send, staged)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send, _global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, _global_rank(group, src[0]), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    if not src:  # nothing arrives: zeros, as lax.ppermute gives
        return torch.zeros_like(x)
    return recv.to(x.device, non_blocking=True) if staged else recv


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


def ppermute(x, perm, group=None):
    """``jax.lax.ppermute`` over ``group``: rank ``s`` (the rank in the
    group) sends ``x`` to ``d`` for each pair ``(s, d)`` of ``perm`` and
    returns what it receives (zeros where nothing arrives). Every rank of
    the group must call it with the same ``perm``. Differentiable: the
    backward sends the cotangent back along the inverse permutation."""
    return _PPermute.apply(x, [tuple(p) for p in perm], group)


def _all_to_all(x, split_axis, concat_axis, group):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    staged = _host_staged(x, group)
    if staged:
        send = _pinned(send)
    recv = _buffer(send, staged)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device, non_blocking=True)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, concat_axis, split_axis, ctx.group), None, None, None


def all_to_all(x, split_axis, concat_axis, group=None):
    """``jax.lax.all_to_all(..., tiled=True)`` over ``group``: ``x`` split
    into P chunks on ``split_axis``, chunk j sent to rank j, and the chunks
    received concatenated on ``concat_axis`` in rank order. Differentiable:
    the backward is the inverse all-to-all (the axes swapped)."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def _gather(x, dim, group):
    n = dist.get_world_size(group)
    staged = _host_staged(x, group)
    send = _pinned(x) if staged else x.contiguous()
    parts = [_buffer(send, staged) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device, non_blocking=True) if staged else out


def _local(x, dim, group):
    n, me = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, me * size, size).contiguous()


class _Shard(torch.autograd.Function):
    """This rank's slice of a replicated tensor; the backward gathers the
    slices' cotangents into the replicated cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _local(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _Unshard(torch.autograd.Function):
    """The slices gathered into the replicated tensor; the backward takes
    this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.dim, ctx.group), None, None


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def ring_self_attention(q, k, v, *, group=None, causal=False, scale=None, use_flash=None):
    """Exact self-attention over q, k, v sharded on the time axis over
    ``group`` (None: the default group), rank i holding the i-th slice:
    [B, T/P, H, D] a rank in, the same out. ``use_flash`` None takes the
    flash blocks wherever the kernel runs. Blocks combine by log-sum-exp:
    the total is sum_b out_b * exp(lse_b - logsumexp_b lse_b)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    t_local = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if use_flash is None:
        use_flash = _use_flash_blocks(q)

    def block(k_blk, v_blk, causal_diag):
        if use_flash:
            out, lse = _flash.flash_attention_block(q, k_blk, v_blk, causal_diag, scale)
            return out.float(), lse
        mask = None
        if causal_diag:
            pos = torch.arange(t_local, device=q.device)
            mask = (pos[:, None] >= pos[None, :])[None, None]
        return _naive_block(q, k_blk, v_blk, scale, mask)

    acc, lse_run = block(k, v, causal)
    kv = torch.stack((k, v))
    perm = [(j, (j + 1) % n) for j in range(n)]
    for i in range(1, n):  # the hop after the last block would be dead: none is made
        kv = ppermute(kv, perm, group)
        out_b, lse_b = block(kv[0], kv[1], False)
        if causal and not (me - i) % n < me:
            # a block from this rank or a later one is masked whole: lse
            # -inf weighs it 0, and its gradients come out exactly 0
            lse_b = torch.full_like(lse_b, -_INF)
        acc, lse_run = _combine(acc, lse_run, out_b, lse_b)
    return acc.to(q.dtype)


def ulysses_self_attention(q, k, v, *, group=None, causal=False, scale=None):
    """All-to-all head-parallel attention (DeepSpeed-Ulysses): [B, T/P, H, D]
    a rank -> [B, T, H/P, D] by all-to-all, full attention over those heads
    (``dot_product_attention``: the flash kernel from ``MIN_SEQ``), and the
    inverse all-to-all back to [B, T/P, H, D]. H must divide by P."""
    q2, k2, v2 = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    out = dot_product_attention(q2, k2, v2, causal=causal, scale=scale)
    return all_to_all(out, 1, 2, group)


def make_ring_attention_fn(mesh, *, causal=False, seq_axis="seq", use_flash=None):
    """Ring attention over ``mesh``'s ``seq_axis`` group as a function of the
    full [B, T, H, D] q, k, v, the same on every rank of the group: each
    rank takes its T/P slice, runs ``ring_self_attention`` and returns the
    full output, all-gathered (the JAX function's ``out_specs``). Gradients
    follow the replicated contract: with the same loss on every rank, each
    gets the full dq, dk, dv (the slices' cotangents are all-gathered)."""
    group = mesh.group(seq_axis)
    n = mesh.shape[seq_axis]

    def fn(q, k, v):
        if q.shape[1] % n:
            raise ValueError(f"T = {q.shape[1]} does not split over the {n} ranks of "
                             f"{seq_axis!r}")
        ql, kl, vl = _Shard.apply(torch.stack((q, k, v)), 2, group).unbind(0)
        out = ring_self_attention(ql, kl, vl, group=group, causal=causal,
                                  use_flash=use_flash)
        return _Unshard.apply(out, 1, group)

    return fn
