"""dp x tp x pp (x sp) from one mesh: ``ComposedParallelLM`` and
``ComposedTrainer``.

The port of ``deeplearning4j_tpu/parallel/composed.py``. One ``MeshSpec``
(``data`` x ``model`` x ``seq`` x ``stage``) trains a ``transformer_lm``
architecture with all of them at once:

* ``stage``: the blocks split evenly over the stages and run under
  ``parallel/pipeline.py``'s GPipe or 1F1B schedule;
* ``model``: Megatron head/column splits inside each block
  (``tp_block_forward``): ``Wqkv`` is stored head-major [d, 3, H, dh] and
  split on H, so a rank attends over its own heads exactly (through
  ``dot_product_attention``, so ``flash_attn`` from ``MIN_SEQ`` on a card);
  ``Wo`` and ``W2`` are row-parallel with one sum each; ``W1``/``b1`` are
  column-parallel; the LayerNorms and the ``bo``/``b2`` biases are whole.
  The boundaries are the conjugate pair ``id_psum_bwd`` (f: identity
  forward, the ranks' partial cotangents summed backward) at a column
  entry and ``psum_id_bwd`` (g: the partial outputs summed forward, the
  cotangent passed through backward) at a row exit, so no gradient is
  counted once a rank (the trap the JAX module names);
* ``seq``: the activations' time axis splits too and attention runs as
  ``ring_self_attention`` over the ``seq`` group;
* ``data``: each data rank pipelines its rows of the global batch.

Each rank's loss is its tokens' NLL over the global token count (or over
the global count of valid tokens with a mask), and the gradients sum over
``data`` and ``seq`` (the embedding's and the head's over ``stage`` too:
stage 0 and the last stage compute them); the model ranks hold identical
copies of everything that is not split. ``shard_optimizer_state`` keeps
the updater state of each leaf split over ``data`` on the ZeRO-1 dim
(``mesh.zero1_sharding``): the update runs on the shard and one
all-gather a dtype makes the parameters whole again.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.layers.attention import dot_product_attention
from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallelLM
from deeplearning4j_tpu_torch.parallel.sequence import ring_self_attention
from deeplearning4j_tpu_torch.utils import collectives as C


def psum_id_bwd(y, group):
    """g: the sum of ``y`` over ``group``; the backward passes the
    cotangent through."""
    return C.PsumIdBwd.apply(y, group)


def id_psum_bwd(y, group):
    """f: ``y`` itself; the backward sums the cotangent over ``group``."""
    return C.IdPsumBwd.apply(y, group)


def _ln(x, g, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


#: the split dim of each block leaf over 'model' (None: whole)
BLOCK_SPLIT = {"ln1_g": None, "ln1_b": None, "ln2_g": None, "ln2_b": None,
               "Wqkv": 2, "bqkv": 1, "Wo": 0, "bo": None,
               "W1": 1, "b1": 0, "W2": 0, "b2": None}


def tp_block_forward(bp, h, *, model_group=None, seq_group=None, activation="gelu"):
    """One tensor-parallel pre-norm block on this rank's shard ``bp`` (see
    ``BLOCK_SPLIT``); ``h`` [B, T(/sp), d] whole over the model group. With
    no model group the same math runs on the whole block."""
    def f(y):
        return y if model_group is None else id_psum_bwd(y, model_group)

    def g(y):
        return y if model_group is None else psum_id_bwd(y, model_group)

    x = h
    hn = f(_ln(x, bp["ln1_g"], bp["ln1_b"]))
    qkv = torch.einsum("btd,dghe->btghe", hn, bp["Wqkv"]) + bp["bqkv"]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if seq_group is not None:
        attn = ring_self_attention(q, k, v, group=seq_group, causal=True)
    else:
        attn = dot_product_attention(q, k, v, causal=True)
    y = torch.einsum("bthe,hed->btd", attn.to(x.dtype), bp["Wo"])
    x = x + g(y) + bp["bo"]
    hn = f(_ln(x, bp["ln2_g"], bp["ln2_b"]))
    m = _act.get(activation)(torch.einsum("btd,df->btf", hn, bp["W1"]) + bp["b1"])
    m = g(torch.einsum("btf,fd->btd", m, bp["W2"])) + bp["b2"]
    return (x + m).to(h.dtype)


class ComposedParallelLM(PipelineParallelLM):
    """Decoder-only LM trained with dp x tp x pp x sp from one mesh (see
    the module docstring): ``PipelineParallelLM`` with head-major blocks
    split over ``model`` (``BLOCK_SPLIT``, ``tp_block_forward``) and the
    time axis split over ``seq``. Requirements: n_layers % stage == 0,
    n_heads % model == 0, (mlp_ratio * d_model) % model == 0,
    batch % (n_microbatches * data) == 0, seq_len % seq == 0."""

    BLOCK_SPLIT = BLOCK_SPLIT

    def __init__(self, *, vocab_size, n_layers, d_model, n_heads, seq_len, mesh,
                 n_microbatches=2, mlp_ratio=4, updater=None, seed=12345, remat=False,
                 shard_optimizer_state=False, schedule="gpipe", device="cuda"):
        super().__init__(vocab_size=vocab_size, n_layers=n_layers, d_model=d_model,
                         n_heads=n_heads, seq_len=seq_len, mesh=mesh,
                         n_microbatches=n_microbatches, mlp_ratio=mlp_ratio, updater=updater,
                         seed=seed, remat=remat, schedule=schedule,
                         shard_optimizer_state=shard_optimizer_state, device=device)
        if n_heads % self.tp or (mlp_ratio * d_model) % self.tp:
            raise ValueError(f"n_heads {n_heads} and the MLP width {mlp_ratio * d_model} must "
                             f"divide by the model axis ({self.tp})")
        if seq_len % self.sp:
            raise ValueError(f"seq_len {seq_len} must divide by the seq axis ({self.sp})")
        self.model_group = mesh.group("model") if self.tp > 1 else None
        self.seq_group = mesh.group("seq") if self.sp > 1 else None

    def _init_block(self, g):
        """The JAX block's initialization distribution, head-major."""
        d, hd = self.d_model, self.n_heads
        dh, hid = d // hd, d * self.mlp_ratio
        wqkv = _init.init_weight("xavier", g, (d, 3 * d), d, 3 * d, torch.float32)
        wo = _init.init_weight("xavier", g, (d, d), d, d, torch.float32)
        return {"ln1_g": torch.ones(d), "ln1_b": torch.zeros(d),
                "ln2_g": torch.ones(d), "ln2_b": torch.zeros(d),
                "Wqkv": wqkv.reshape(d, 3, hd, dh), "bqkv": torch.zeros(3, hd, dh),
                "Wo": wo.reshape(hd, dh, d), "bo": torch.zeros(d),
                "W1": _init.init_weight("xavier", g, (d, hid), d, hid, torch.float32),
                "b1": torch.zeros(hid),
                "W2": _init.init_weight("xavier", g, (hid, d), hid, d, torch.float32),
                "b2": torch.zeros(d)}

    def _block(self, bp, h):
        return tp_block_forward(bp, h, model_group=self.model_group, seq_group=self.seq_group)

    def _reference_block(self, bp, h):
        return tp_block_forward(bp, h)


class ComposedTrainer:
    """``fit`` over a ``ComposedParallelLM`` (gpipe): every batch is
    bucketed to ``batch_size`` (default the first batch's) and a ragged
    tail pads with masked rows, so the masked loss equals the unpadded
    batch's."""

    def __init__(self, lm):
        if lm.schedule != "gpipe":
            raise ValueError("ComposedTrainer buckets+masks ragged batches, which needs the "
                             "gpipe schedule (the 1f1b head loss cannot take a mask)")
        self.lm = lm
        self.mesh = lm.mesh
        self.score_value = None

    @property
    def iteration(self):
        return self.lm.iteration

    @property
    def params(self):
        return self.lm.params

    @property
    def opt_state(self):
        return self.lm.opt_state

    def step(self, ids, labels, mask=None):
        loss = self.lm.step(ids, labels, mask)
        self.score_value = loss
        return loss

    def fit(self, x, y=None, *, epochs=1, batch_size=None):
        """Train on arrays, an (x, y) pair or an iterator of batches (the
        same on every rank); returns the last loss."""
        from deeplearning4j_tpu_torch.datasets.iterator import iter_batches

        if self.lm.params is None:
            self.lm.init()
        chunk = self.lm.n_micro * self.mesh.shape["data"]
        feats = x[0] if (y is None and isinstance(x, (tuple, list))) else x
        bucket = batch_size if batch_size is not None else (
            feats.shape[0] if hasattr(feats, "shape") else None)
        loss = None
        for _ in range(epochs):
            steps = 0
            for bx, by, bm in iter_batches(x, y, batch_size, pad_to=bucket or True):
                if bx.shape[0] % chunk:
                    raise ValueError(f"bucketed batch size {bx.shape[0]} not divisible by "
                                     f"n_microbatches*data = {self.lm.n_micro}*"
                                     f"{self.mesh.shape['data']} = {chunk}")
                loss = self.step(bx, by, bm)
                steps += 1
            if steps == 0:
                raise ValueError("no trainable batches: empty input (or a non-resettable "
                                 "iterator on a later epoch)")
        return loss

