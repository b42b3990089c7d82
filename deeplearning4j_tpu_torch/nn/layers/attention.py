"""Attention layers and layer normalization.

The same configs, parameters and math as
``deeplearning4j_tpu/nn/layers/attention.py``. ``dot_product_attention``
keeps that module's dispatch seam: ``resolve_attention`` sends
self-attention at ``T >= MIN_SEQ`` (or where a bound tuning DB says so)
to ``ops.attention.flash_attention``
(the Hopper kernel on CUDA tensors, its plain version on CPU tensors) and
everything else to the naive path, which holds the [B,H,T,T] scores.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer
from deeplearning4j_tpu_torch.nn.layers.core import matmul
from deeplearning4j_tpu_torch.ops import attention as _flash
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.serde import register_config

#: the sequence length from which the kernel path beats the naive path on
#: an H100 (forward + backward, B=4, H=8, D=64, causal, f32), since the
#: backward is a kernel too: 1.40x and 1.75x at T=256, 1.58x and 1.49x at
#: 1024, 2.72x at 4096 in two runs of chip_smoke's crossover sweep, whose
#: shortest length is 256 (PERF.md). ``DL4J_TPU_FUSED_ATTENTION_MIN_SEQ``
#: or ``min_seq=`` override it, as in the JAX package.
MIN_SEQ = 256
#: the largest head width the kernel takes
MAX_HEAD_DIM = 128


@register_config
@dataclasses.dataclass(frozen=True)
class LayerNormalization(ParamLayer):
    """Per-feature layer norm (gamma/beta over the last axis)."""

    eps: float = 1e-5
    activation: object = dataclasses.field(default="identity", kw_only=True)

    input_family = None

    WEIGHT_KEYS = ("gamma",)
    BIAS_KEYS = ("beta",)

    def _nfeat(self, input_type):
        """The normalized axis' width: channels for a convolutional input."""
        if isinstance(input_type, _inputs.ConvolutionalType):
            return input_type.channels
        return input_type.size

    def output_type(self, input_type):
        return input_type

    def init(self, generator, input_type, dtype=torch.float32):
        n = self._nfeat(input_type)
        dev = generator.device
        return {"gamma": torch.ones((n,), dtype=dtype, device=dev),
                "beta": torch.zeros((n,), dtype=dtype, device=dev)}

    def apply(self, params, state, x, *, train=False):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)  # biased, as jnp.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = y * params["gamma"] + params["beta"]
        return self.activation_fn()(y), state


def resolve_attention(q_shape, k_shape, mask, dtype, *, min_seq=None):
    """Whether ``dot_product_attention`` takes the flash path. Structural
    gates first (self-attention shapes only, head_dim <= 128, the kernel's
    float dtypes, a mask only as [B, Tk] key padding), then the length
    crossover: a bound tuning DB's verdict for the [B, T, H, D] bucket
    (``{"backend": "plain"}`` is the naive path; ``tuning/tune.py`` times
    it as a candidate), else ``T >= min_seq`` (default ``MIN_SEQ``, or the
    ``DL4J_TPU_FUSED_ATTENTION_MIN_SEQ`` environment variable). An explicit
    ``min_seq`` is the caller's decision and skips the DB, as in the JAX
    package."""
    if mask is not None and tuple(mask.shape) != (q_shape[0], k_shape[1]):
        return False
    if tuple(q_shape) != tuple(k_shape) or q_shape[-1] > MAX_HEAD_DIM:
        return False
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if min_seq is None:
        cfg = _flash.tuned_config(q_shape, dtype)
        if cfg is not None:
            return cfg.get("backend", "flash") == "flash"
        try:
            min_seq = int(os.environ.get("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", MIN_SEQ))
        except ValueError:  # malformed override: keep the measured default
            min_seq = MIN_SEQ
    return q_shape[1] >= min_seq


def dot_product_attention(q, k, v, *, mask=None, causal=False, scale=None, min_seq=None):
    """q, k, v [B, T, H, D] -> [B, T, H, D]. Products in the compute dtype
    with f32 accumulation, f32 softmax; a fully masked row gives 0 on both
    paths. The flash path sees q, k, v as they come (f32 even under the
    bf16 policy, since the projection returns the accumulation dtype), as
    in the JAX package."""
    if resolve_attention(q.shape, k.shape, mask, q.dtype, min_seq=min_seq):
        return _flash.flash_attention(q, k, v, mask=mask, causal=causal, scale=scale)
    cd, ad = _dtypes.compute_dtypes_for(q.dtype)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(cd).to(ad), k.to(cd).to(ad)) * scale
    # filled on the device: no host copy, so the path captures into a CUDA graph
    neg_inf = torch.full((), -math.inf, dtype=logits.dtype, device=logits.device)
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        logits = torch.where(keep, logits, neg_inf)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg_inf)
        # fully masked rows: a finite row before the softmax, 0 after it
        any_valid = (logits > -math.inf).any(dim=-1, keepdim=True)
        logits = torch.where(any_valid, logits, torch.zeros_like(logits))
        weights = torch.softmax(logits, dim=-1)
        weights = torch.where(any_valid, weights, torch.zeros_like(weights))
    else:
        weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(cd).to(ad), v.to(cd).to(ad))


@register_config
@dataclasses.dataclass(frozen=True)
class MultiHeadAttention(ParamLayer):
    """Self-attention over [B,T,F] with a fused QKV projection."""

    n_out: int = 0
    n_heads: int = 4
    causal: bool = False
    weight_init: object = dataclasses.field(default="xavier", kw_only=True)

    input_family = _inputs.RecurrentType

    WEIGHT_KEYS = ("Wqkv", "Wo")
    BIAS_KEYS = ("bqkv", "bo")

    def output_type(self, input_type):
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = input_type.size
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} is not a multiple of n_heads {self.n_heads}")
        dev = generator.device
        return {
            "Wqkv": _init.init_weight(self.weight_init, generator, (n_in, 3 * self.n_out),
                                      n_in, 3 * self.n_out, dtype),
            "bqkv": torch.zeros((3 * self.n_out,), dtype=dtype, device=dev),
            "Wo": _init.init_weight(self.weight_init, generator, (self.n_out, self.n_out),
                                    self.n_out, self.n_out, dtype),
            "bo": torch.zeros((self.n_out,), dtype=dtype, device=dev),
        }

    def heads(self, params, x):
        """Project to q, k, v [B,T,H,D] (views of one [B,T,3,H,D] tensor)."""
        b, t, _ = x.shape
        h, d = self.n_heads, self.n_out // self.n_heads
        qkv = matmul(x.reshape(b * t, -1), params["Wqkv"]) + params["bqkv"]
        qkv = qkv.reshape(b, t, 3, h, d)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def out_proj(self, params, attn):
        b, t, h, d = attn.shape
        y = matmul(attn.reshape(b * t, h * d), params["Wo"]) + params["bo"]
        return y.reshape(b, t, h * d)

    def apply(self, params, state, x, *, train=False, mask=None):
        q, k, v = self.heads(params, x)
        attn = dot_product_attention(q, k, v, mask=mask, causal=self.causal)
        y = self.out_proj(params, attn)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state


@register_config
@dataclasses.dataclass(frozen=True)
class TransformerBlock(Layer):
    """Pre-norm transformer block: LN -> MHA -> residual, LN -> MLP ->
    residual. Parameters nest as the JAX package's: ``ln1``, ``mha``,
    ``ln2`` sub-dicts and ``mlp_W1``/``mlp_b1``/``mlp_W2``/``mlp_b2``."""

    n_out: int = 0
    n_heads: int = 4
    mlp_ratio: int = 4
    causal: bool = False
    activation: object = "gelu"

    input_family = _inputs.RecurrentType

    def _parts(self):
        return (LayerNormalization(),
                MultiHeadAttention(n_out=self.n_out, n_heads=self.n_heads, causal=self.causal),
                LayerNormalization())

    def output_type(self, input_type):
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        if input_type.size != self.n_out:
            raise ValueError("TransformerBlock requires input size == n_out (residual)")
        ln1, mha, ln2 = self._parts()
        hidden = self.n_out * self.mlp_ratio
        it = _inputs.RecurrentType(self.n_out, input_type.timesteps)
        dev = generator.device
        return {
            "ln1": ln1.init(generator, it, dtype),
            "mha": mha.init(generator, it, dtype),
            "ln2": ln2.init(generator, it, dtype),
            "mlp_W1": _init.init_weight("xavier", generator, (self.n_out, hidden),
                                        self.n_out, hidden, dtype),
            "mlp_b1": torch.zeros((hidden,), dtype=dtype, device=dev),
            "mlp_W2": _init.init_weight("xavier", generator, (hidden, self.n_out),
                                        hidden, self.n_out, dtype),
            "mlp_b2": torch.zeros((self.n_out,), dtype=dtype, device=dev),
        }

    def apply(self, params, state, x, *, train=False, mask=None):
        ln1, mha, ln2 = self._parts()
        h, _ = ln1.apply(params["ln1"], {}, x)
        attn, _ = mha.apply(params["mha"], {}, h, mask=mask)
        x = x + attn
        h, _ = ln2.apply(params["ln2"], {}, x)
        b, t, f = h.shape
        m = _act.get(self.activation)(matmul(h.reshape(b * t, f), params["mlp_W1"])
                                      + params["mlp_b1"])
        m = matmul(m, params["mlp_W2"]) + params["mlp_b2"]
        return x + m.reshape(b, t, f), state
