"""SequenceVectors / Word2Vec: skip-gram and CBOW with negative sampling and
hierarchical softmax.

The port of ``deeplearning4j_tpu/text/word2vec.py`` (reference analog:
models/sequencevectors/SequenceVectors.java, SkipGram.java, CBOW.java,
InMemoryLookupTable.java in the reference's deeplearning4j-nlp module).
The host pipeline (vocab, corpus encoding, subsampling, dynamic windows,
pairs, permutations) is the JAX package's, draw for draw from the same
``numpy.random.RandomState`` streams. On the device:

* Steps. ``_sgns_math``, ``_hs_math`` and ``_cbow_math`` are plain
  functions on tensors: each gathers every row it needs, computes both
  tables' gradients and the loss from the tables as they were, then
  updates syn0 and syn1 in place and returns the loss.
* The update. ``_scatter_mean_update`` applies ``-lr`` times the per-row
  mean of the gradients at the touched rows only, through zeroed scratch
  buffers (``new_scratch``): summed into with ``index_add_``, read at the
  rows, written back with ``index_copy_`` (duplicates write one value) and
  zeroed at the rows again. An untouched row keeps its bits, as the JAX
  package's dense form leaves it (``t - lr*0/1 = t``), and no step reads
  or writes the whole table.
* Chunks. ``_run_batched`` runs each full group of ``SCAN_CHUNK`` batches
  (the JAX package's scanned jit call) as one unit: on a card one replay
  of a ``torch.cuda.CUDAGraph`` captured once per model and shape, over
  static index buffers, a device learning-rate scalar and a
  ``[SCAN_CHUNK]`` loss buffer; on the CPU the same steps run eagerly
  over the same buffers. The epoch's index arrays reach the card in one
  pinned, non-blocking copy each. Leftover full batches and the ragged
  tail run one step at a time. A CUDA model never runs a chunk eagerly:
  a refused capture raises.
* Negatives are drawn on the device by the alias method from a
  ``torch.Generator`` seeded with ``seed``, in fixed ``_NEG_CHUNK``-row
  chunks: the method and the distribution are the JAX package's, the bits
  are not (JAX draws threefry).

Over a mesh (``mesh=``, the port's ``parallel/mesh.py`` mesh, one process
a rank of its ``data`` axis; the JAX package's ``_dist_fns`` and
``_dist_fns_table_sharded``):

* replicated tables (SGNS, CBOW, HS): every rank holds both tables whole
  and takes its equal share of the rows of each global batch (each rank is
  handed the same epoch: the host pipeline and the negatives are drawn from
  the same seeds everywhere). A step all-gathers every rank's (indices,
  gradients, loss) first, one collective a dtype, and applies the
  scatter-mean of the global batch, so every rank applies the one-device
  update of that batch, at O(batch x dim) traffic a step; the loss is the
  mean over the ranks. The ragged tail is
  cut to a multiple of the axis (``examples_dropped``: at most n - 1 pairs
  an epoch). ``batch_size`` must divide by the axis.
* ``shard_tables=True`` (SGNS only): the vocabulary is padded to a
  multiple of the axis and each rank holds V/n consecutive rows of syn0 and
  syn1neg; the batches are whole on every rank, the step's row gathers are
  masked local reads summed over the group in one all-reduce, and each
  rank applies the update to its own rows only.

A chunk over NCCL is captured into its CUDA graph with its collectives
(held on an H100 at world 1 only, by ``chip_smoke.py``'s word2vec phase;
across cards it has not been run); gloo cannot be captured, so over gloo
the chunk runs eagerly. With
telemetry on, a chunk engine's captures count into ``compiles_total`` and
``recompiles_total`` (site ``word2vec.<update function>``).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry as _telemetry
from deeplearning4j_tpu_torch.telemetry import devices as _devices
from deeplearning4j_tpu_torch.text.vocab import (VocabCache, VocabConstructor,
                                                 flatten_corpus)
from deeplearning4j_tpu_torch.utils import collectives as _C
from deeplearning4j_tpu_torch.utils.device import as_device, resolve_device
from deeplearning4j_tpu_torch.utils.hostsync import fetch_losses

__all__ = ["AliasTable", "SequenceVectors", "Word2Vec", "tables_from_numpy", "new_scratch"]

#: warm-up runs of a chunk before its capture (learning rate 0: no-ops)
WARMUP_RUNS = 2


class AliasTable:
    """Walker's alias method: O(n) build, O(1) sampling from a discrete
    distribution (the host-side analog of the reference's precomputed
    negative-sampling table, InMemoryLookupTable.java table/makeTable)."""

    def __init__(self, probs):
        probs = np.asarray(probs, np.float64)
        n = len(probs)
        scaled = probs * n / probs.sum()
        self.prob = np.zeros(n, np.float64)
        self.alias = np.zeros(n, np.int64)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s, l = small.pop(), large.pop()
            self.prob[s] = scaled[s]
            self.alias[s] = l
            scaled[l] -= 1.0 - scaled[s]
            (small if scaled[l] < 1.0 else large).append(l)
        for i in small + large:
            self.prob[i] = 1.0

    def draw(self, rs, shape):
        idx = rs.randint(0, len(self.prob), size=shape)
        accept = rs.random_sample(np.shape(idx)) < self.prob[idx]
        return np.where(accept, idx, self.alias[idx]).astype(np.int32)


def _alias_draw_chunk(prob, alias, generator, shape):
    """Device-side alias draw (the method of ``AliasTable.draw``) of
    ``shape`` int32 indices from ``generator``."""
    idx = torch.randint(0, prob.shape[0], shape, generator=generator, device=prob.device)
    accept = torch.rand(shape, generator=generator, device=prob.device) < prob[idx]
    return torch.where(accept, idx, alias[idx]).to(torch.int32)


def new_scratch(rows, dim, dtype=torch.float32, device="cpu"):
    """Zeroed ``(num [rows, dim], cnt [rows])`` buffers for
    ``_scatter_mean_update`` on tables of up to ``rows`` rows; every update
    leaves them zeroed again."""
    return (torch.zeros((rows, dim), dtype=dtype, device=device),
            torch.zeros(rows, dtype=dtype, device=device))


def _scatter_mean_update(table, idx, grads, lr, scratch=None):
    """``table[r] -= lr * (mean of the grads at r)`` for each row r in
    ``idx``, in place. With unique indices this is per-pair SGD; under
    collisions (small vocab, large batch) the mean stays stable where a raw
    scatter-add would multiply the step by the collision count (the
    reference's Hogwild applies pairs one at a time).

    Reads and writes the touched rows only (see the module docstring);
    ``scratch`` is ``new_scratch`` of at least the table's rows, zeroed
    again on return (None: fresh buffers). The value is the JAX package's
    ``table - lr * num / max(cnt, 1)``, evaluated in that order."""
    idx = idx.reshape(-1).long()
    num, cnt = scratch if scratch is not None else new_scratch(
        table.shape[0], table.shape[1], table.dtype, table.device)
    num.index_add_(0, idx, grads)
    cnt.index_add_(0, idx, torch.ones(idx.shape, dtype=grads.dtype, device=grads.device))
    rows = table.index_select(0, idx) - lr * num.index_select(0, idx) \
        / cnt.index_select(0, idx).clamp_min(1.0)[:, None]
    table.index_copy_(0, idx, rows)
    num.index_fill_(0, idx, 0.0)
    cnt.index_fill_(0, idx, 0.0)


def _rows(table, idx):
    """``table[idx]`` for an index tensor of any shape: ``[*idx.shape, D]``."""
    return table.index_select(0, idx.reshape(-1).long()).reshape(*idx.shape, table.shape[1])


def _gathered(group, tensors):
    """``tensors`` (one dtype) all-gathered over ``group`` in one
    collective: each ``[world * n, ...]``, the ranks' rows in rank order
    (the JAX package's tiled ``all_gather`` of each)."""
    world = _C.dist.get_world_size(group)
    flat = _C.all_gather(torch.cat([t.reshape(-1) for t in tensors]), group).view(world, -1)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[:, off:off + n].reshape((world * t.shape[0],) + tuple(t.shape[1:])))
        off += n
    return out


def _exchanged(group, idx, vals):
    """A replicated-table update's exchange over ``group`` (None: none):
    every rank's index tensors ``idx`` and float tensors ``vals`` (the
    gradients, and the loss last) gathered in rank order, two collectives
    a step; the loss comes back as the mean over the ranks (the JAX
    ``pmean``)."""
    if group is None:
        return list(idx), list(vals)
    idx = _gathered(group, [i.reshape(-1).long() for i in idx])
    vals = _gathered(group, [v for v in vals[:-1]] + [vals[-1].reshape(1)])
    return idx, vals[:-1] + [vals[-1].mean()]


def _ns_loss(s_pos, s_neg):
    """-mean(log σ(v·u+) + Σ log σ(-v·u-)), clipped as the JAX package does."""
    return -torch.mean(torch.log(s_pos.clamp(1e-9, 1.0))
                       + torch.sum(torch.log((1.0 - s_neg).clamp(1e-9, 1.0)), dim=1))


def _sgns_rows(syn0, syn1neg, centers, contexts, negatives):
    """The rows an SGNS batch reads: (v [B,D], u+ [B,D], u- [B,K,D])."""
    return _rows(syn0, centers), _rows(syn1neg, contexts), _rows(syn1neg, negatives)


def _sgns_core(syn0, syn1neg, centers, contexts, negatives, rows=_sgns_rows):
    """Closed-form gradients and loss of one skip-gram negative-sampling
    batch, -log σ(v·u+) - Σ log σ(-v·u-), from the tables as they are (no
    writes): ``(grad_v [B,D], u_idx [B(1+K)], u_grads [B(1+K),D], loss)``.
    ``rows`` reads the batch's rows (``_sgns_rows``; a row-sharded table's
    gather)."""
    v, u_pos, u_neg = rows(syn0, syn1neg, centers, contexts, negatives)
    s_pos = torch.sigmoid(torch.sum(v * u_pos, dim=1))                    # [B]
    s_neg = torch.sigmoid(torch.bmm(u_neg, v.unsqueeze(2)).squeeze(2))   # [B,K]
    g_pos = (s_pos - 1.0)[:, None]
    grad_v = g_pos * u_pos + torch.bmm(s_neg.unsqueeze(1), u_neg).squeeze(1)
    grad_u_neg = s_neg[..., None] * v[:, None, :]
    u_idx = torch.cat([contexts.reshape(-1), negatives.reshape(-1)])
    u_grads = torch.cat([g_pos * v, grad_u_neg.reshape(-1, v.shape[1])])
    return grad_v, u_idx, u_grads, _ns_loss(s_pos, s_neg)


def _sgns_math(syn0, syn1neg, centers, contexts, negatives, lr, scratch=None, group=None):
    """One batched skip-gram negative-sampling update, in place.

    centers [B], contexts [B], negatives [B,K]; returns the loss. With
    ``group`` the batch is this rank's share of the global one
    (``_exchanged``)."""
    grad_v, u_idx, u_grads, loss = _sgns_core(syn0, syn1neg, centers, contexts, negatives)
    (centers, u_idx), (grad_v, u_grads, loss) = _exchanged(group, (centers, u_idx),
                                                           (grad_v, u_grads, loss))
    _scatter_mean_update(syn0, centers, grad_v, lr, scratch)
    _scatter_mean_update(syn1neg, u_idx, u_grads, lr, scratch)
    return loss


class TableShard:
    """This rank's ``rows`` consecutive rows, from ``lo``, of tables split
    over ``group``."""

    def __init__(self, group, lo, rows):
        self.group, self.lo, self.rows = group, lo, rows

    def _local(self, idx):
        local = idx.long() - self.lo
        ok = (local >= 0) & (local < self.rows)
        return local.clamp(0, self.rows - 1), ok

    def _held(self, table_l, idx):
        safe, ok = self._local(idx)
        return _rows(table_l, safe) * ok[..., None].to(table_l.dtype)

    def sgns_rows(self, syn0_l, syn1_l, centers, contexts, negatives):
        """``_sgns_rows`` of the whole tables: each rank's reads of the
        rows it holds (zeros elsewhere), summed over the group in one
        all-reduce."""
        parts = [self._held(syn0_l, centers), self._held(syn1_l, contexts),
                 self._held(syn1_l, negatives)]
        flat = _C.all_reduce_(torch.cat([p.reshape(-1) for p in parts]), self.group)
        out, off = [], 0
        for p in parts:
            out.append(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        return tuple(out)

    def scatter_mean(self, table_l, idx, grads, lr, scratch):
        """The scatter-mean update of the rows held here (the others'
        gradients masked out of both the sums and the counts)."""
        safe, ok = self._local(idx.reshape(-1))
        okf = ok.to(grads.dtype)
        num, cnt = scratch
        num.index_add_(0, safe, grads * okf[:, None])
        cnt.index_add_(0, safe, okf)
        # a masked index clamped onto a held row computes that row's own new
        # value (its sums hold only the held gradients), so every duplicate
        # writes the same value
        rows = table_l.index_select(0, safe) - lr * num.index_select(0, safe) \
            / cnt.index_select(0, safe).clamp_min(1.0)[:, None]
        table_l.index_copy_(0, safe, rows)
        num.index_fill_(0, safe, 0.0)
        cnt.index_fill_(0, safe, 0.0)


def _sgns_math_table_sharded(syn0_l, syn1_l, centers, contexts, negatives, lr, scratch=None,
                             shard=None):
    """One SGNS update with row-sharded tables (``shard``: a
    ``TableShard``) and the batch whole on every rank: the gathers sum the
    ranks' masked reads, each rank updates its own rows. Returns the loss
    (the same on every rank)."""
    grad_v, u_idx, u_grads, loss = _sgns_core(syn0_l, syn1_l, centers, contexts, negatives,
                                              rows=shard.sgns_rows)
    shard.scatter_mean(syn0_l, centers, grad_v, lr, scratch)
    shard.scatter_mean(syn1_l, u_idx, u_grads, lr, scratch)
    return loss


def _hs_math(syn0, syn1, centers, points, codes, path_mask, lr, scratch=None, group=None):
    """Hierarchical-softmax skip-gram update, in place.

    points/codes/path_mask: [B, L] padded Huffman paths. Loss:
    -Σ log σ((1-2*code) * v·u_point); returns it."""
    v = _rows(syn0, centers)                       # [B,D]
    u = _rows(syn1, points)                        # [B,L,D]
    sign = 1.0 - 2.0 * codes                       # code 0 -> +1, 1 -> -1
    dot = torch.bmm(u, v.unsqueeze(2)).squeeze(2)  # [B,L]
    s = torch.sigmoid(sign * dot)
    g = (s - 1.0) * sign * path_mask               # [B,L]
    grad_v = torch.bmm(g.unsqueeze(1), u).squeeze(1)
    grad_u = g[..., None] * v[:, None, :]
    loss = -torch.sum(torch.log(s.clamp(1e-9, 1.0)) * path_mask) \
        / torch.sum(path_mask).clamp_min(1.0)
    (centers, points), (grad_v, grad_u, loss) = _exchanged(
        group, (centers, points), (grad_v, grad_u.reshape(-1, v.shape[1]), loss))
    _scatter_mean_update(syn0, centers, grad_v, lr, scratch)
    _scatter_mean_update(syn1, points, grad_u, lr, scratch)
    return loss


def _cbow_math(syn0, syn1neg, context_idx, context_mask, targets, negatives, lr,
               scratch=None, group=None):
    """CBOW-NS: the mean of the context vectors predicts the target
    (reference: CBOW.java); in place, returns the loss. Padded context slots
    point at row 0 with a zero gradient and count in its mean, as in the
    JAX package."""
    ctx = _rows(syn0, context_idx)                 # [B,W,D]
    m = context_mask[..., None]
    h = torch.sum(ctx * m, dim=1) / torch.sum(m, dim=1).clamp_min(1.0)  # [B,D]
    u_pos = _rows(syn1neg, targets)
    u_neg = _rows(syn1neg, negatives)
    s_pos = torch.sigmoid(torch.sum(h * u_pos, dim=1))
    s_neg = torch.sigmoid(torch.bmm(u_neg, h.unsqueeze(2)).squeeze(2))
    g_pos = (s_pos - 1.0)[:, None]
    grad_h = g_pos * u_pos + torch.bmm(s_neg.unsqueeze(1), u_neg).squeeze(1)
    counts = torch.sum(context_mask, dim=1, keepdim=True).clamp_min(1.0)
    grad_ctx = (grad_h[:, None, :] / counts[..., None]) * m
    u_idx = torch.cat([targets.reshape(-1), negatives.reshape(-1)])
    u_grads = torch.cat([g_pos * h, (s_neg[..., None] * h[:, None, :]).reshape(-1, h.shape[1])])
    loss = _ns_loss(s_pos, s_neg)
    (context_idx, u_idx), (grad_ctx, u_grads, loss) = _exchanged(
        group, (context_idx, u_idx), (grad_ctx.reshape(-1, h.shape[1]), u_grads, loss))
    _scatter_mean_update(syn0, context_idx, grad_ctx, lr, scratch)
    _scatter_mean_update(syn1neg, u_idx, u_grads, lr, scratch)
    return loss


class _ChunkSteps:
    """``k`` batches of one update function over static buffers: one replay
    of a CUDA graph on a card (captured at the first call, and again when
    the model's tables or scratch are other tensors than those captured),
    the same steps run eagerly on the CPU and, with ``eager``, on a card
    (collectives over gloo cannot be captured). Calling it with a chunk's
    arrays (``[k * B, ...]`` each, on the model's device) returns the
    ``[k]`` losses."""

    def __init__(self, math_fn, k, arrays, device, eager=False):
        self.math_fn = math_fn
        self.k = k
        self.device = device
        self.eager = eager or device.type != "cuda"
        # index arrays as int64 (what the index ops take), the rest as given
        self.bufs = [torch.zeros((k, a.shape[0] // k, *a.shape[1:]),
                                 dtype=a.dtype if a.is_floating_point() else torch.int64,
                                 device=device) for a in arrays]
        self.graph = None
        self.out = None
        self.ptrs = None
        self.captures = 0
        self.replays = 0

    def _steps(self, model):
        return torch.stack([
            self.math_fn(model.syn0, model.syn1, *(b[i] for b in self.bufs), model._lr,
                         scratch=model._scratch, **model._math_kw)
            for i in range(self.k)])

    def _ptrs(self, model):
        return tuple(t.data_ptr() for t in (model.syn0, model.syn1, *model._scratch, model._lr))

    def __call__(self, model, chunk):
        for buf, a in zip(self.bufs, chunk):
            buf.copy_(a.reshape(buf.shape))
        if self.eager:
            return self._steps(model)
        if self.graph is None or self.ptrs != self._ptrs(model):
            self._capture(model)
        self.graph.replay()
        self.replays += 1
        return self.out.clone()  # the next replay overwrites the graph's output

    def _capture(self, model):
        """Warm up on a side stream with the learning rate at 0 (the updates
        rewrite each touched row with its own value), then capture."""
        cur = torch.cuda.current_stream(self.device)
        lr = model._lr.clone()
        model._lr.zero_()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._steps(model)
        cur.wait_stream(side)
        model._lr.copy_(lr)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._steps(model)
        self.graph, self.out, self.ptrs = graph, out, self._ptrs(model)
        self.captures += 1


def _host(t):
    """A table as a numpy array on the host."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class SequenceVectors:
    """Generic embedding trainer over element sequences (reference:
    SequenceVectors.java — Word2Vec, DeepWalk walks, ParagraphVectors all
    run through this). ``device`` defaults to the card and raises without
    one; pass ``device="cpu"`` to train on the CPU."""

    def __init__(self, *, vector_size=100, window=5, min_count=5, negative=5,
                 learning_rate=0.025, min_learning_rate=1e-4, epochs=1,
                 batch_size=2048, subsample=1e-3, use_hierarchic_softmax=False,
                 algorithm="skipgram", seed=123, mesh=None,
                 shard_tables=False, device="cuda"):
        # mesh: the port's Mesh (parallel/mesh.py); its 'data' axis splits
        # the batches (replicated tables) or the tables' rows (shard_tables)
        if shard_tables and mesh is None:
            raise ValueError("shard_tables=True requires mesh= (the tables "
                             "shard over the mesh 'data' axis)")
        if shard_tables and (use_hierarchic_softmax or algorithm != "skipgram"):
            raise ValueError("shard_tables supports skipgram-negative-"
                             "sampling only")
        if mesh is not None and not shard_tables and batch_size % mesh.shape["data"]:
            raise ValueError(
                f"batch_size {batch_size} must divide by the mesh data "
                f"axis size {mesh.shape['data']}")
        self.mesh = mesh
        self.shard_tables = bool(shard_tables)
        self.examples_dropped = 0
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window = window
        self.min_count = min_count
        self.negative = negative
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.subsample = subsample
        self.use_hs = use_hierarchic_softmax
        self.algorithm = algorithm
        self.seed = seed
        self.vocab: VocabCache | None = None
        self.syn0 = None
        self.syn1 = None
        self._scratch = None
        self._rs = np.random.RandomState(seed)
        # the learning rate the chunks' graphs read (written before each run)
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._chunk_steps = {}
        #: keywords every update takes: the data group of a replicated-table
        #: mesh, or the TableShard of a sharded one (set in build_vocab)
        self._math_kw = {}
        self._group = mesh.group("data") if mesh is not None else None

    # ---- vocab + tables ----

    def build_vocab(self, sequences, _flat=None):
        ctor = VocabConstructor(self.min_count, build_huffman=self.use_hs)
        if _flat is not None:
            self.vocab = ctor.build_from_counts(_flat.uniq, _flat.counts)
        else:
            self.vocab = ctor.build(sequences)
        v, d = len(self.vocab), self.vector_size
        rs = np.random.RandomState(self.seed)
        syn0_host = (rs.rand(v, d).astype(np.float32) - 0.5) / d
        rows = v if not self.use_hs else max(v - 1, 1)
        if self.shard_tables:
            # rows padded to the shard count; V/n of each table here
            nd, r = self.mesh.shape["data"], self.mesh.coords["data"]
            vp = -(-v // nd) * nd
            self._rows_per_shard = rows = vp // nd
            syn0_host = np.pad(syn0_host, ((0, vp - v), (0, 0)))[r * rows:(r + 1) * rows]
            self._math_kw = {"shard": TableShard(self._group, r * rows, rows)}
        elif self.mesh is not None:
            self._math_kw = {"group": self._group}
        self.syn0 = torch.from_numpy(np.ascontiguousarray(syn0_host)).to(self.device)
        self.syn1 = torch.zeros((rows, d), dtype=torch.float32, device=self.device)
        self._scratch = new_scratch(max(self.syn0.shape[0], rows), d, device=self.device)
        counts = self.vocab.counts().astype(np.float64)
        probs = counts ** 0.75
        self._neg_table = (probs / probs.sum()).astype(np.float64)
        self._neg_alias = AliasTable(self._neg_table)
        # device copies for on-device negative drawing (see _draw_negatives)
        self._neg_prob_dev = torch.as_tensor(self._neg_alias.prob, dtype=torch.float32,
                                             device=self.device)
        self._neg_alias_dev = torch.as_tensor(self._neg_alias.alias, dtype=torch.int64,
                                              device=self.device)
        self._neg_gen = torch.Generator(device=self.device)
        self._neg_gen.manual_seed(self.seed)
        total = counts.sum()
        freq = counts / total
        self._keep_prob = np.minimum(1.0, np.sqrt(self.subsample / np.maximum(freq, 1e-12))
                                     + self.subsample / np.maximum(freq, 1e-12))
        if self.use_hs:
            self._max_code = max((len(w.codes) for w in self.vocab._by_index), default=1)
            # whole-vocab Huffman path tables: batch lookup = one fancy index
            L = self._max_code
            self._hs_pts = np.zeros((v, L), np.int32)
            self._hs_codes = np.zeros((v, L), np.float32)
            self._hs_mask = np.zeros((v, L), np.float32)
            for r, vw in enumerate(self.vocab._by_index):
                k = len(vw.codes)
                self._hs_pts[r, :k] = vw.points
                self._hs_codes[r, :k] = vw.codes
                self._hs_mask[r, :k] = 1.0
        return self

    # ---- pair generation (host side, whole-array numpy) ----

    def _encode(self, seq):
        idx = [self.vocab.index_of(t) for t in seq]
        return [i for i in idx if i >= 0]

    def _encode_corpus(self, sequences, _flat=None):
        """Flatten to (flat_idx [N], seq_id [N]); computed once per fit.
        Token->index mapping runs through one np.unique pass over the whole
        corpus and one dict lookup per distinct token; falls back to
        per-token dict lookups for token types np.unique cannot order."""
        corpus = _flat if _flat is not None else flatten_corpus(sequences)
        if corpus is None:  # exotic token types: dict path
            enc = [self._encode(s) for s in sequences]
            flat = np.asarray([i for e in enc for i in e], np.int32)
            seq_id = np.repeat(np.arange(len(enc), dtype=np.int32),
                               [len(e) for e in enc])
            return flat, seq_id
        lut = np.fromiter((self.vocab.index_of(t) for t in corpus.uniq),
                          np.int32, len(corpus.uniq))
        flat_all = lut[corpus.inverse] if len(corpus.inverse) else \
            np.zeros(0, np.int32)
        seq_id_all = np.repeat(
            np.arange(len(corpus.lens), dtype=np.int32), corpus.lens)
        keep = flat_all >= 0  # drop out-of-vocab tokens
        return flat_all[keep].astype(np.int32), seq_id_all[keep]

    def _subsampled(self, flat, seq_id):
        """Per-epoch frequent-word subsampling (word2vec p_keep)."""
        if self.subsample <= 0 or len(flat) == 0:
            return flat, seq_id
        keep = self._rs.random_sample(len(flat)) < self._keep_prob[flat]
        return flat[keep], seq_id[keep]

    def _pairs_from_corpus(self, flat, seq_id):
        """All (center, context) skip-gram pairs with per-center dynamic
        window b ~ U[1, window], as O(window) shifted array ops."""
        n = len(flat)
        if n < 2:
            z = np.zeros((0,), np.int32)
            return z, z
        b = self._rs.randint(1, self.window + 1, size=n)
        centers, contexts = [], []
        for off in range(1, self.window + 1):
            same = seq_id[:-off] == seq_id[off:]
            # center at pos, context at pos+off (window of the center rules)
            m = same & (b[:-off] >= off)
            centers.append(flat[:-off][m]); contexts.append(flat[off:][m])
            # center at pos+off, context at pos
            m = same & (b[off:] >= off)
            centers.append(flat[off:][m]); contexts.append(flat[:-off][m])
        return (np.concatenate(centers).astype(np.int32),
                np.concatenate(contexts).astype(np.int32))

    # rows per device draw call: the draws of the first rows do not depend
    # on how many rows an epoch asks for
    _NEG_CHUNK = 1 << 17

    def _draw_negatives(self, shape):
        """Negative samples [n, k] (int32) drawn on the model's device, in
        fixed-size chunks from the model's generator. The result stays on
        the device; _run_batched slices it like any other batch array."""
        n, k = shape
        if n == 0:
            return torch.zeros((0, k), dtype=torch.int32, device=self.device)
        chunks = [_alias_draw_chunk(self._neg_prob_dev, self._neg_alias_dev, self._neg_gen,
                                    (self._NEG_CHUNK, k))
                  for _ in range(-(-n // self._NEG_CHUNK))]
        negs = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return negs[:n]

    def _cbow_windows_from_corpus(self, flat, seq_id):
        """Padded CBOW windows as one gather: positions [N,1] + offsets
        [1,2W], masked where out-of-sequence or beyond the dynamic window."""
        W = 2 * self.window
        n = len(flat)
        if n == 0:
            z = np.zeros((0, W), np.int32)
            return z, np.zeros((0, W), np.float32), np.zeros((0,), np.int32)
        b = self._rs.randint(1, self.window + 1, size=n)
        offs = np.concatenate([np.arange(-self.window, 0),
                               np.arange(1, self.window + 1)])  # [2W]
        pos = np.arange(n)[:, None]                              # [N,1]
        j = pos + offs[None, :]                                  # [N,2W]
        jc = np.clip(j, 0, n - 1)
        valid = ((j >= 0) & (j < n)
                 & (seq_id[jc] == seq_id[:, None])
                 & (np.abs(offs)[None, :] <= b[:, None]))
        has_ctx = valid.any(axis=1)
        ctx = np.where(valid, flat[jc], 0).astype(np.int32)[has_ctx]
        mask = valid.astype(np.float32)[has_ctx]
        return ctx, mask, flat[has_ctx]

    # ---- training ----

    def fit(self, sequences):
        """sequences: iterable (re-iterable) of token lists.

        Losses stay on the device until the fit ends (one fetch), so the
        host prepares the next epoch while the card runs this one."""
        seq_list = [list(s) for s in sequences]
        self.examples_dropped = 0
        flat = flatten_corpus(seq_list)  # ONE pass feeds vocab + encoding
        if self.vocab is None:
            self.build_vocab(seq_list, _flat=flat)
        corpus = self._encode_corpus(seq_list, _flat=flat)  # once, not per epoch
        total_steps = max(self.epochs, 1)
        losses = []
        for epoch in range(self.epochs):
            frac = epoch / total_steps
            lr = max(self.learning_rate * (1 - frac), self.min_learning_rate)
            if self.algorithm == "cbow" and not self.use_hs:
                ctx, cmask, targets = self._cbow_windows_from_corpus(
                    *self._subsampled(*corpus))
                perm = self._rs.permutation(len(targets))
                ctx, cmask, targets = ctx[perm], cmask[perm], targets[perm]
                negs = self._draw_negatives((len(targets), self.negative))
                losses += self._run_batched(_cbow_math, (ctx, cmask, targets, negs), lr)
                continue
            centers, contexts = self._pairs_from_corpus(
                *self._subsampled(*corpus))
            perm = self._rs.permutation(len(centers))
            centers, contexts = centers[perm], contexts[perm]
            if self.use_hs:
                pts, codes, mask = self._huffman_batch(contexts)
                losses += self._run_batched(_hs_math, (centers, pts, codes, mask), lr)
            else:
                negs = self._draw_negatives((len(centers), self.negative))
                losses += self._run_batched(_sgns_math, (centers, contexts, negs), lr)
        self.loss_history = fetch_losses(losses)
        return self

    # batches per chunk (one CUDA-graph replay on a card); fixed so one
    # capture serves every epoch and corpus of a model
    SCAN_CHUNK = 32

    def _chunk_engine(self, math_fn, chunk):
        key = (math_fn.__name__,) + tuple((tuple(a.shape[1:]), a.dtype) for a in chunk)
        if key not in self._chunk_steps:
            # collectives over gloo cannot be captured into a CUDA graph
            gloo = (self._group is not None
                    and _C.dist.get_backend(self._group) == _C.dist.Backend.GLOO)
            self._chunk_steps[key] = _ChunkSteps(math_fn, self.SCAN_CHUNK, chunk, self.device,
                                                 eager=gloo)
        return self._chunk_steps[key]

    def _mine(self, a, k):
        """This rank's rows of each of the ``k`` global batches stacked in
        ``a`` (replicated tables over a mesh: the r-th equal share of each,
        as the JAX ``P('data')`` split); ``a`` itself otherwise."""
        if self.mesh is None or self.shard_tables:
            return a
        nd, r = self.mesh.shape["data"], self.mesh.coords["data"]
        b = a.shape[0] // k // nd
        return a.reshape(k, nd * b, *a.shape[1:])[:, r * b:(r + 1) * b].reshape(
            k * b, *a.shape[1:])

    def _run_batched(self, math_fn, arrays, lr):
        """Split aligned arrays into SCAN_CHUNK-sized groups of [B, ...]
        full batches, each group run as one chunk (one CUDA-graph replay on
        a card); leftover full batches and the ragged tail run one step at
        a time. Returns the list of (device) per-batch losses.

        Over a mesh the batches split over the ``data`` axis, the ragged
        tail cut to a multiple of it (``examples_dropped``); with
        ``shard_tables`` the tables' rows split instead."""
        if self.shard_tables:
            math_fn = _sgns_math_table_sharded
        elif self.mesh is not None:
            nd = self.mesh.shape["data"]
            n_keep = (len(arrays[0]) // nd) * nd
            self.examples_dropped += len(arrays[0]) - n_keep
            arrays = tuple(a[:n_keep] for a in arrays)
        arrays = tuple(as_device(a, self.device) for a in arrays)
        n = len(arrays[0])
        bs = self.batch_size
        ck = self.SCAN_CHUNK
        self._lr.fill_(lr)
        losses = []
        i = 0
        while n - i >= ck * bs:
            chunk = tuple(self._mine(a[i:i + ck * bs], ck) for a in arrays)
            engine = self._chunk_engine(math_fn, chunk)
            losses += list(engine(self, chunk))
            if _telemetry.enabled():
                # the chunk's CUDA-graph captures (a recapture storm shows here)
                _devices.note_jit_cache(f"word2vec.{math_fn.__name__}", engine)
            i += ck * bs
        while i < n:
            losses.append(math_fn(self.syn0, self.syn1,
                                  *(self._mine(a[i:i + bs], 1) for a in arrays),
                                  self._lr, scratch=self._scratch, **self._math_kw))
            i += bs
        return losses

    def whole_tables(self):
        """(syn0, syn1) whole, as numpy arrays: under ``shard_tables`` the
        ranks' rows all-gathered (every rank of the mesh calls it) and cut
        back to the vocabulary."""
        if not self.shard_tables:
            return _host(self.syn0), _host(self.syn1)
        v = len(self.vocab)
        return tuple(_host(_C.gather_dim(t.contiguous(), 0, self._group))[:v]
                     for t in (self.syn0, self.syn1))

    def _huffman_batch(self, targets):
        """Padded Huffman paths for a batch — one fancy index into the
        precomputed whole-vocab tables (built in build_vocab)."""
        return (self._hs_pts[targets], self._hs_codes[targets],
                self._hs_mask[targets])

    # ---- query API (reference: WordVectors interface); numpy out ----

    def get_word_vector(self, word):
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return self.whole_tables()[0][i] if self.shard_tables else _host(self.syn0[i])

    def has_word(self, word):
        return self.vocab is not None and word in self.vocab

    def similarity(self, w1, w2):
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        if a is None or b is None:
            return float("nan")
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    def words_nearest(self, word, top_n=10):
        i = self.vocab.index_of(word)
        if i < 0:
            return []
        m = self.whole_tables()[0]
        norms = m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12)
        sims = norms @ norms[i]
        order = np.argsort(-sims)
        return [(self.vocab.word_for(j), float(sims[j]))
                for j in order if j != i][:top_n]


class Word2Vec(SequenceVectors):
    """(reference: models/word2vec/Word2Vec.java — SequenceVectors over
    tokenized sentences)."""

    def __init__(self, *, tokenizer_factory=None, **kwargs):
        super().__init__(**kwargs)
        from deeplearning4j_tpu_torch.text.tokenization import \
            default_tokenizer_factory
        self.tokenizer_factory = tokenizer_factory or \
            default_tokenizer_factory()

    def fit_sentences(self, sentences):
        seqs = [self.tokenizer_factory.create(s).get_tokens() for s in sentences]
        return self.fit(seqs)

    def fit_iterator(self, sentence_iterator):
        """Train from any corpus SentenceIterator (reference:
        Word2Vec.Builder.iterate(SentenceIterator) — the front door of
        text/corpus.py). The iterator is consumed once; the epochs replay
        the materialized sequences."""
        return self.fit_sentences(list(sentence_iterator))


def tables_from_numpy(model, syn0, syn1):
    """Install host tables (say a JAX model's ``np.asarray(sv.syn0)`` and
    ``np.asarray(sv.syn1)``) into ``model``, whose vocab was built from the
    same corpus. They are copied into the model's own tensors, so its
    captured chunks stay valid. Returns the model."""
    if model.syn0 is None:
        raise ValueError("tables_from_numpy: build the model's vocab first "
                         "(build_vocab or fit)")
    for name, table, src in (("syn0", model.syn0, syn0), ("syn1", model.syn1, syn1)):
        src = np.asarray(src)
        if tuple(src.shape) != tuple(table.shape):
            raise ValueError(f"tables_from_numpy: {name} has shape {src.shape}, the "
                             f"model's {tuple(table.shape)}")
        table.copy_(torch.tensor(src, dtype=table.dtype))
    return model
