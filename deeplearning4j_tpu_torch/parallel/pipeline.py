"""Pipeline parallelism over the mesh's ``stage`` axis: the GPipe and 1F1B
schedules and ``PipelineParallelLM``.

The port of ``deeplearning4j_tpu/parallel/pipeline.py``. The JAX package
runs one SPMD program: a ``lax.scan`` over ticks inside ``shard_map``, with
the backward derived by differentiating the scan and its ``ppermute``
hops (GPipe), or an explicit-VJP tick loop (1F1B). Here each rank of a
``stage`` group runs its own stage and the schedule is written out:

* ``StageLink``: point-to-point hops to the neighbouring stages
  (``dist.batch_isend_irecv``; on gloo a CUDA tensor goes through a pinned
  host buffer). A step's first activation carries a small header with its
  shape and dtype; the others reuse it.
* ``gpipe_schedule``: every microbatch forward (each stage keeps every
  microbatch's graph), the loss of all of them on the last stage, then
  every microbatch backward.
* ``one_f_one_b_schedule``: the non-interleaved 1F1B order of Megatron-LM
  (Narayanan et al. 2021): stage s runs min(S - s - 1, M) forwards, then
  alternates one forward and one backward, then drains; its pairs of hops
  go out as one batch, so no two neighbours wait on each other. A stage
  holds at most S - s microbatches' activations (GPipe holds M). The loss
  is the sum of the microbatches' scaled losses, as the JAX 1F1B head.

Both return the last stage's loss, and on stage 0 the cotangent of each
microbatch's input; parameter gradients accumulate in ``.grad``. Every rank
of the stage group must call a schedule with the same number of
microbatches. The stage inputs are leaves, so a stage's own graph is all a
backward walks.

``PipelineParallelLM`` is the JAX class: embedding, ``n_layers``
``TransformerBlock``s split evenly over the stages, and a vocab head; the
embedding and the head run outside the pipelined region (stage 0 and the
last stage), their parameters replicated on every rank and their gradients
summed over the stage group. With a ``data`` axis each data rank pipelines
its rows of the global batch, and every gradient and the loss also sum
over ``data`` (each rank's loss is its tokens' NLL over the global token
count). Attention in each block takes ``flash_attn`` from
``nn/layers/attention.MIN_SEQ`` on a card.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.layers import EmbeddingSequenceLayer, TransformerBlock
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.data_parallel import _Plan
from deeplearning4j_tpu_torch.utils import collectives as C
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


# ---------------------------------------------------------------------------
# stage-to-stage hops
# ---------------------------------------------------------------------------

class StageLink:
    """This rank's place on the ``stage`` axis of ``mesh`` and its hops to
    the neighbouring stages. With ``timed`` (eager steps only: it
    synchronizes the card) the milliseconds spent waiting in hops
    accumulate in ``wait_ms``."""

    def __init__(self, mesh):
        self.group = mesh.group("stage")
        self.n = mesh.shape["stage"]
        self.s = mesh.coords["stage"]
        ranks = mesh.ranks("stage")
        self.prev = ranks[self.s - 1] if self.s > 0 else None
        self.next = ranks[self.s + 1] if self.s < self.n - 1 else None
        self.first, self.last = self.prev is None, self.next is None
        self.timed = False
        self.wait_ms = 0.0
        self.begin_step()

    def begin_step(self):
        """Forget the activation header: the step's first hop sends one."""
        self._in_meta = None
        self._out_sent = False

    def _ops(self, sends, recvs):
        """Post every send (tensor, peer) and receive (shape, dtype, device,
        peer) as one batch and wait for all; returns the received
        tensors on their devices."""
        gloo = dist.get_backend(self.group) == dist.Backend.GLOO
        ops, outs = [], []
        for t, peer in sends:
            t = t.detach().contiguous()
            if gloo and t.is_cuda:
                t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            ops.append(dist.P2POp(dist.isend, t, peer, self.group))
        for shape, dtype, device, peer in recvs:
            staged = gloo and device.type == "cuda"
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
                   else torch.empty(shape, dtype=dtype, device=device))
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group))
            outs.append((buf, device, staged))
        if not ops:
            return []
        dev = next((d for _, _, d, _ in recvs), None) or next(
            (t.device for t, _ in sends), None)
        if self.timed and dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.timed:
            self.wait_ms += 1e3 * (time.perf_counter() - t0)
        return [b.to(d, non_blocking=True) if staged else b for b, d, staged in outs]

    @staticmethod
    def _header(t):
        h = torch.zeros(8, dtype=torch.int64)
        h[0], h[1] = t.dim(), _DTYPES.index(t.dtype)
        h[2:2 + t.dim()] = torch.tensor(t.shape)
        return h

    def send_fwd(self, y):
        if self.last:
            return
        if not self._out_sent:
            self._ops([(self._header(y), self.next)], [])
            self._out_sent = True
        self._ops([(y, self.next)], [])

    def recv_fwd(self, device):
        if self.first:
            return None
        if self._in_meta is None:
            h = self._ops([], [((8,), torch.int64, torch.device("cpu"), self.prev)])[0]
            nd = int(h[0])
            self._in_meta = (tuple(int(v) for v in h[2:2 + nd]), _DTYPES[int(h[1])])
        shape, dtype = self._in_meta
        return self._ops([], [(shape, dtype, device, self.prev)])[0]

    def send_fwd_recv_bwd(self, y):
        """Send ``y`` on and receive its cotangent, in one batch."""
        if self.last:
            return None
        return self._ops([(y, self.next)], [(y.shape, y.dtype, y.device, self.next)])[0]

    def send_bwd_recv_fwd(self, dx, device):
        """Send ``dx`` back and receive the next microbatch's input."""
        if self.first:
            return None
        shape, dtype = self._in_meta
        return self._ops([(dx, self.prev)], [(shape, dtype, device, self.prev)])[0]

    def recv_bwd(self, like):
        if self.last:
            return None
        return self._ops([], [(like.shape, like.dtype, like.device, self.next)])[0]

    def send_bwd(self, dx):
        if not self.first:
            self._ops([(dx, self.prev)], [])


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

class ScheduleResult:
    """A schedule's outcome on this rank: ``loss`` (last stage: the summed
    scaled losses, else None), ``dxs`` (stage 0: each microbatch input's
    cotangent, else None) and ``peak_stash`` (the most microbatches whose
    activations this stage held at once)."""

    def __init__(self, loss, dxs, peak_stash):
        self.loss, self.dxs, self.peak_stash = loss, dxs, peak_stash


def _leaf(x, grad):
    return x.detach().requires_grad_(grad)


def gpipe_schedule(link, n_micro, stage_fn, *, source=None, head=None, want_dx=False,
                   device=None, backward=True):
    """GPipe on this rank: ``stage_fn(m, x) -> y`` runs the stage on
    microbatch m (stage 0 takes ``source(m)``), ``head(ys) -> loss`` the
    last stage's loss of all microbatches' outputs. With ``want_dx`` stage
    0's inputs take gradients; without ``backward`` only the forwards and
    the loss run. Returns a ``ScheduleResult``."""
    xs, ys = [], []
    for m in range(n_micro):
        x = source(m) if link.first else link.recv_fwd(device)
        x = _leaf(x, backward and (want_dx or not link.first))
        y = stage_fn(m, x)
        link.send_fwd(y)
        xs.append(x)
        ys.append(y)
    loss = head(ys) if link.last else None
    if not backward:
        return ScheduleResult(None if loss is None else loss.detach(), None, n_micro)
    if link.last:
        loss.backward()
    dxs = [] if link.first else None
    for m in range(n_micro):
        if not link.last:
            dy = link.recv_bwd(ys[m])
            if ys[m].requires_grad:
                torch.autograd.backward(ys[m], dy)
        dx = xs[m].grad if xs[m].grad is not None else torch.zeros_like(xs[m])
        if link.first:
            dxs.append(dx)
        else:
            link.send_bwd(dx)
    return ScheduleResult(None if loss is None else loss.detach(), dxs, n_micro)


def one_f_one_b_schedule(link, n_micro, stage_fn, *, source=None, head_mb=None, want_dx=False,
                         device=None):
    """1F1B on this rank (see the module docstring): ``stage_fn(m, x) -> y``
    as for GPipe, ``head_mb(m, y) -> scaled loss`` of one microbatch on the
    last stage, whose backward starts at once. Returns a
    ``ScheduleResult`` whose loss is the sum of the microbatches'."""
    n, s = link.n, link.s
    warm = min(n - s - 1, n_micro)
    rest = n_micro - warm
    xs, outs = {}, {}
    state = {"fm": 0, "bm": 0, "peak": 0, "loss": None}
    dxs = [None] * n_micro if link.first else None

    def forward(x):
        m = state["fm"]
        state["fm"] += 1
        x = _leaf(source(m) if link.first else x, want_dx or not link.first)
        y = stage_fn(m, x)
        if link.last:
            lm = head_mb(m, y)
            state["loss"] = lm.detach() if state["loss"] is None else state["loss"] + lm.detach()
            outs[m] = lm
        else:
            outs[m] = y
        xs[m] = x
        state["peak"] = max(state["peak"], len(xs))
        return y

    def backward(dy):
        m = state["bm"]
        state["bm"] += 1
        out = outs.pop(m)
        if link.last:
            out.backward()
        elif out.requires_grad:
            torch.autograd.backward(out, dy)
        x = xs.pop(m)
        dx = x.grad if x.grad is not None else torch.zeros_like(x)
        if link.first:
            dxs[m] = dx
        return dx

    for _ in range(warm):
        link.send_fwd(forward(link.recv_fwd(device)))
    x = link.recv_fwd(device) if rest > 0 else None
    for i in range(rest):
        y = forward(x)
        dy = link.send_fwd_recv_bwd(y)
        dx = backward(dy)
        if i == rest - 1:
            link.send_bwd(dx)
            x = None
        else:
            x = link.send_bwd_recv_fwd(dx, device)
    for _ in range(warm):
        dy = link.recv_bwd(outs[state["bm"]])
        link.send_bwd(backward(dy))
    return ScheduleResult(state["loss"], dxs, state["peak"])


def run_schedule(schedule, link, n_micro, stage_fn, *, source=None, head=None, head_mb=None,
                 want_dx=False, device=None, backward=True):
    """``gpipe_schedule`` (with ``head``) or ``one_f_one_b_schedule`` (with
    ``head_mb``) by name; without ``backward``, GPipe's forwards alone."""
    link.begin_step()
    if schedule == "gpipe" or not backward:
        return gpipe_schedule(link, n_micro, stage_fn, source=source, head=head,
                              want_dx=want_dx, device=device, backward=backward)
    if schedule == "1f1b":
        return one_f_one_b_schedule(link, n_micro, stage_fn, source=source, head_mb=head_mb,
                                    want_dx=want_dx, device=device)
    raise ValueError(f"schedule {schedule!r}: 'gpipe' or '1f1b'")


# ---------------------------------------------------------------------------
# helpers shared by the pipelined models
# ---------------------------------------------------------------------------

def stack_blocks(blocks):
    """Per-block parameter trees stacked into one tree with a leading block
    axis (the JAX slab layout, used to carry weights across)."""
    return tree_like(blocks[0], iter([torch.stack(ts) for ts in
                                      zip(*(list(tree_leaves(b)) for b in blocks))]))


def unstack_blocks(stacked, n):
    """The inverse of ``stack_blocks``: ``n`` per-block trees."""
    leaves = list(tree_leaves(stacked))
    return [tree_like(stacked, iter([t[i] for t in leaves])) for i in range(n)]


def lm_head_loss(scale):
    """One microbatch's LM head loss: the sum of its token NLLs times
    ``scale`` (1 / the global token count, so the sum over microbatches and
    ranks is the batch mean)."""
    def head_loss(hp, h, lab):
        logits = h @ hp["W"] + hp["b"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, lab[..., None].long()).sum() * scale
    return head_loss


def _as_tensor(a):
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def _grads_zero(tensors):
    for t in tensors:
        t.grad = None
        t.requires_grad_(True)


def _grads_take(tensors):
    out = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tensors]
    for t in tensors:
        t.grad = None
        t.requires_grad_(False)
    return out


def sum_flat(tensors, group):
    """Every tensor summed over ``group`` in one all-reduce a dtype (in
    place into new tensors); returns them in order."""
    if group is None or dist.get_world_size(group) == 1 or not tensors:
        return list(tensors)
    out = [None] * len(tensors)
    by = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.dtype, []).append(i)
    for idx in by.values():
        flat = C.all_reduce_(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        off = 0
        for i in idx:
            out[i] = flat[off:off + tensors[i].numel()].view(tensors[i].shape)
            off += tensors[i].numel()
    return out


def _to_tensor_tree(tree, device, dtype=None):
    if hasattr(tree, "items"):
        return {k: _to_tensor_tree(v, device, dtype) for k, v in tree.items()}
    t = tree if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))
    return t.to(device=device, dtype=dtype or t.dtype).clone()


def _by_block(tree, s0, n_blocks):
    """A params-shaped tree with its local ``blocks`` list keyed by the
    blocks' global indices."""
    if not hasattr(tree, "items"):
        return tree
    if "blocks" in tree and isinstance(tree["blocks"], list) \
            and len(tree["blocks"]) == n_blocks:
        return {**tree, "blocks": {s0 + i: b for i, b in enumerate(tree["blocks"])}}
    return {k: _by_block(v, s0, n_blocks) for k, v in tree.items()}


def lm_checkpoint_leaves(lm, suffix):
    """The named leaves of a pipelined LM: its parameters and updater
    state with the blocks keyed by global index, ``suffix`` on every name
    (a model or data slice's coordinates)."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree
    s0 = lm.link.s * lm.per_stage
    out = {}
    for part, tree in (("params", lm.params), ("opt_state", lm.opt_state)):
        for k, t in flatten_tree(_by_block(tree, s0, lm.per_stage), part).items():
            if torch.is_tensor(t):
                out[k + suffix] = t
    return out


def load_named(mine, named):
    """Copy ``named`` tensors into ``mine`` (same names) in place."""
    with torch.no_grad():
        for name, t in mine.items():
            if name not in named:
                raise KeyError(f"checkpoint has no leaf {name}")
            t.copy_(named[name].to(t.device, t.dtype))


class PipelineParallelLM:
    """Decoder-only transformer LM trained with pipeline parallelism (see
    the module docstring). ids and labels are [B, T] integers, the same
    global batch on every rank; B divides into ``n_microbatches`` times the
    data-axis size, and ``n_layers`` by the stage-axis size.

    ``ComposedParallelLM`` (``parallel/composed.py``) is this class with
    head-split blocks over ``model`` and the time axis over ``seq``: the
    hooks ``_init_block``, ``_block``, ``BLOCK_SPLIT`` and the two groups."""

    #: the dim each block leaf splits on over 'model' (None: this class's
    #: blocks are whole)
    BLOCK_SPLIT = None

    def __init__(self, *, vocab_size, n_layers, d_model, n_heads, seq_len, mesh,
                 n_microbatches=4, mlp_ratio=4, updater=None, seed=12345, remat=False,
                 schedule="gpipe", shard_optimizer_state=False, device="cuda"):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule {schedule!r}: 'gpipe' or '1f1b'")
        self.vocab_size, self.n_layers, self.d_model = vocab_size, n_layers, d_model
        self.n_heads, self.seq_len, self.mlp_ratio = n_heads, seq_len, mlp_ratio
        self.mesh = mesh
        self.n_micro = n_microbatches
        self.n_stages, self.dp = mesh.shape["stage"], mesh.shape["data"]
        self.tp, self.sp = mesh.shape["model"], mesh.shape["seq"]
        if n_layers % self.n_stages:
            raise ValueError(f"{n_layers} layers not divisible into {self.n_stages} stages")
        self.per_stage = n_layers // self.n_stages
        self.link = StageLink(mesh)
        self.data_group = mesh.group("data")
        self.model_group = self.seq_group = None
        self.embed = EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model, add_positional=True)
        self.block = TransformerBlock(n_out=d_model, n_heads=n_heads, mlp_ratio=mlp_ratio,
                                      causal=True)
        self.updater = updater or U.Adam(learning_rate=3e-4)
        self.seed, self.remat, self.schedule = seed, remat, schedule
        self.shard_optimizer_state = shard_optimizer_state
        self.device = resolve_device(device)
        self.params = None
        self.opt_state = None
        self.iteration = 0
        #: the last step's ``ScheduleResult.peak_stash``; with ``timing``,
        #: each step's milliseconds waiting in hops
        self.last_peak_stash = None
        self.timing = False
        self.wait_ms = []

    # -- the block (the composed LM overrides these) --------------------------
    def _init_block(self, g):
        return self.block.init(g, I.RecurrentType(self.d_model, self.seq_len))

    def _block(self, bp, h):
        return self.block.apply(bp, {}, h, train=True)[0]

    def _local_block(self, bp):
        """This model rank's slice of a whole block."""
        if self.BLOCK_SPLIT is None:
            return bp
        r = self.mesh.coords["model"]
        return {k: (C.local_slice(t, self.BLOCK_SPLIT[k], r, self.tp)
                    if self.BLOCK_SPLIT[k] is not None else t) for k, t in bp.items()}

    # -- init ------------------------------------------------------------
    def init(self, generator=None, from_params=None):
        """Random weights from ``seed`` (every rank draws the whole model and
        keeps its blocks, cut to its model slice) or ``from_params``: the
        JAX layout ``{"embed", "blocks" (stacked [L, ...]), "head"}`` of
        arrays. With ``shard_optimizer_state`` the updater state of each
        leaf is split over ``data`` on its ZeRO-1 dim
        (``mesh.zero1_sharding``)."""
        if from_params is None:
            g = generator or torch.Generator().manual_seed(self.seed)
            embed = self.embed.init(g, I.RecurrentType(1, self.seq_len))
            blocks = [self._init_block(g) for _ in range(self.n_layers)]
            head = {"W": torch.randn((self.d_model, self.vocab_size), generator=g)
                    / np.sqrt(self.d_model), "b": torch.zeros(self.vocab_size)}
        else:
            embed, head = from_params["embed"], from_params["head"]
            blocks = unstack_blocks(_to_tensor_tree(from_params["blocks"], "cpu"),
                                    self.n_layers)
        s0 = self.link.s * self.per_stage
        dt = _dtypes.get_policy().param_dtype
        self.params = {"embed": _to_tensor_tree(embed, self.device, dt),
                       "blocks": [_to_tensor_tree(self._local_block(b), self.device, dt)
                                  for b in blocks[s0:s0 + self.per_stage]],
                       "head": _to_tensor_tree(head, self.device, dt)}
        self._zero_plan = None
        state_of = self.params
        if self.shard_optimizer_state and self.dp > 1:
            leaves = list(tree_leaves(self.params))
            dims = []
            for t in leaves:
                spec = _mesh.zero1_sharding(self.mesh, _mesh.P(), t)
                dims.append(next((i for i, e in enumerate(spec)
                                  if "data" in _mesh._axes(e)), None))
            self._zero_plan = _Plan(dims, [t.shape for t in leaves], self.data_group, self.dp,
                                    self.mesh.coords["data"])
            state_of = tree_like(self.params, iter([self._zero_plan.shard(j, t)
                                                    for j, t in enumerate(leaves)]))
        self.opt_state = self.updater.init(state_of)
        return self

    def num_params(self):
        """The whole model's parameter count."""
        split = self.BLOCK_SPLIT or {}
        block = sum((self.tp if split.get(k) is not None else 1)
                    * sum(t.numel() for t in tree_leaves(v))
                    for k, v in self.params["blocks"][0].items())
        rest = sum(t.numel() for t in tree_leaves({"e": self.params["embed"],
                                                   "h": self.params["head"]}))
        return int(rest + block * self.n_layers)

    # -- the step ----------------------------------------------------------
    def _stage_fn(self):
        blocks = self.params["blocks"]

        def stage_fn(m, x):
            h = x
            for bp in blocks:
                h = (torch.utils.checkpoint.checkpoint(self._block, bp, h, use_reentrant=False)
                     if self.remat else self._block(bp, h))
            return h
        return stage_fn

    def _local(self, a):
        """This rank's rows (data) and time slice (seq) of [B, T, ...]."""
        t = _mesh.ensure_data_sharded(self.mesh, _as_tensor(a))
        if self.sp > 1 and t.dim() >= 2:
            t = C.local_slice(t, 1, self.mesh.coords["seq"], self.sp)
        return t.to(self.device)

    def _loss_and_grads(self, ids, labels, mask=None):
        """Run the schedule on this rank's rows; returns (the loss summed over
        the mesh, grads like ``self.params`` summed where they are
        replicated: blocks over data and seq, the embedding and the head
        also over stage, since one stage computed each)."""
        p = self.params
        ids_l = _mesh.ensure_data_sharded(self.mesh, _as_tensor(ids)).to(self.device)
        labels_l = self._local(labels)
        b, t = labels_l.shape
        mb = b // self.n_micro
        if mask is not None:
            m = _as_tensor(mask)
            m = self._local((m if m.dim() == 2 else m[:, None].expand(-1, self.seq_len)).float())
            count = sum_flat(sum_flat([m.sum().reshape(1)], self.data_group), self.seq_group)
            count = count[0][0].clamp_min(1.0)
        else:
            m, count = None, float(b * self.dp * t * self.sp)
        leaves = list(tree_leaves(p))
        _grads_zero(leaves)
        link = self.link
        emb = None
        if link.first:
            emb, _ = self.embed.apply(p["embed"], {}, ids_l, train=True)
            if self.sp > 1:
                emb = C.local_slice(emb, 1, self.mesh.coords["seq"], self.sp)

        def head_loss(h, lab, mk):
            logits = h @ p["head"]["W"] + p["head"]["b"]
            nll = -torch.log_softmax(logits.float(), dim=-1).gather(-1, lab[..., None].long())
            nll = nll[..., 0] if mk is None else nll[..., 0] * mk
            return nll.sum() / count

        rows = (lambda a, i: None if a is None else a[i * mb:(i + 1) * mb])  # noqa: E731
        link.timed, link.wait_ms = self.timing, 0.0
        res = run_schedule(
            self.schedule, link, self.n_micro, self._stage_fn(),
            source=lambda i: emb[i * mb:(i + 1) * mb],
            head=lambda ys: head_loss(torch.cat(ys), labels_l, m),
            head_mb=lambda i, y: head_loss(y, rows(labels_l, i), rows(m, i)),
            want_dx=link.first, device=self.device)
        if link.first:
            torch.autograd.backward(emb, torch.cat(res.dxs))
        self.last_peak_stash = res.peak_stash
        if self.timing:
            self.wait_ms.append(link.wait_ms)
        g_tree = tree_like(p, iter(_grads_take(leaves)))
        loss = (res.loss if res.loss is not None
                else torch.zeros((), dtype=torch.float32, device=self.device))
        outer = list(tree_leaves({"e": g_tree["embed"], "h": g_tree["head"]}))
        inner = list(tree_leaves(g_tree["blocks"]))
        outer = sum_flat(outer + [loss.reshape(1).double()], link.group)
        summed = sum_flat(sum_flat(outer + inner, self.data_group), self.seq_group)
        n_out = len(outer) - 1
        it = iter(summed[:n_out])
        g_tree["embed"] = tree_like(g_tree["embed"], it)
        g_tree["head"] = tree_like(g_tree["head"], it)
        g_tree["blocks"] = tree_like(g_tree["blocks"], iter(summed[n_out + 1:]))
        return summed[n_out][0], g_tree

    def _update(self, grads):
        plan = self._zero_plan
        if plan is None:
            self.updater.update_(self.params, grads, self.opt_state, self.iteration)
            return
        leaves = list(tree_leaves(self.params))
        views = [plan.shard(j, t) for j, t in enumerate(leaves)]
        g_views = [plan.shard(j, g) for j, g in enumerate(tree_leaves(grads))]
        self.updater.update_(tree_like(self.params, iter(views)),
                             tree_like(self.params, iter(g_views)), self.opt_state,
                             self.iteration)
        split = [j for j, d in enumerate(plan.dims) if d is not None]
        if split:
            plan.gather(split, [views[j] for j in split], outs=[leaves[j].data for j in split])

    def step(self, ids, labels, mask=None):
        """One update on the global batch; ``mask`` ([B] or [B, T], 1 real, 0
        padding; GPipe only) makes the loss the mean over the valid tokens.
        Returns the global loss."""
        if self.params is None:
            self.init()
        if mask is not None and self.schedule != "gpipe":
            raise ValueError("masked (bucketed/padded) batches need the gpipe schedule")
        with _dtypes.policy_precision():
            loss, grads = self._loss_and_grads(ids, labels, mask)
            self._update(grads)
        self.iteration += 1
        return loss

    # -- checkpoints (``utils/sharded_checkpoint``) ------------------------------
    def checkpoint_leaves(self):
        """{global name: tensor} of the parameters and updater state this
        rank holds (blocks by their index in the model), each name tagged
        with the rank's model and data coordinates: a restore goes to the
        same mesh shape."""
        c = self.mesh.coords
        return lm_checkpoint_leaves(self, f"@model{c['model']}@data{c['data']}")

    def load_checkpoint_leaves(self, named):
        load_named(self.checkpoint_leaves(), named)

    # -- whole-model views ---------------------------------------------------
    def all_blocks(self):
        """Every block's whole parameters (L trees, the JAX layout) on every
        rank: the model slices and the stages gathered."""
        local = stack_blocks(self.params["blocks"])
        split = self.BLOCK_SPLIT or {}

        def whole(k, t):
            if split.get(k) is not None and self.tp > 1:
                t = C.gather_dim(t, split[k] + 1, self.model_group)
            return C.gather_dim(t, 0, self.link.group) if self.n_stages > 1 else t
        out = {k: (whole(k, v) if torch.is_tensor(v) else
                   tree_like(v, iter([whole(None, t) for t in tree_leaves(v)])))
               for k, v in local.items()}
        return unstack_blocks(out, self.n_layers)

    def loss_reference(self, ids, labels):
        """The sequential forward with the same parameters on this rank,
        without the pipeline (every rank calls it: it gathers the blocks).
        Returns the mean token NLL."""
        blocks = self.all_blocks()
        p = self.params
        ids, labels = (_as_tensor(a).to(self.device) for a in (ids, labels))
        with torch.no_grad(), _dtypes.policy_precision():
            h, _ = self.embed.apply(p["embed"], {}, ids)
            for bp in blocks:
                h = self._reference_block(bp, h)
            return lm_head_loss(1.0 / labels.numel())(p["head"], h, labels)

    def _reference_block(self, bp, h):
        return self.block.apply(bp, {}, h)[0]
