"""Mixture-of-Experts transformer block.

The port of ``deeplearning4j_tpu/nn/layers/moe.py``, with its config,
parameters and math: pre-norm LN -> MHA -> residual, then LN -> MoE-MLP
-> residual, where the MLP is ``n_experts`` expert MLPs behind a top-1
router (Switch Transformer, Fedus et al. 2021):

* each token goes to the argmax of its f32 router probabilities (the first
  maximum on a tie, as ``jnp.argmax``); an expert takes at most
  C = int(ceil(N / E) * capacity_factor) tokens (at least 1), in token
  order; the overflow contributes 0 and passes on the residual;
* the expert's output is scaled by the token's router probability, so the
  router learns through that gate (and the aux term);
* the Switch load-balancing loss E * sum_e f_e * p_e (f_e the share of
  tokens routed to e, p_e the mean probability of e) times
  ``aux_loss_weight`` is stashed in the state under ``"aux_loss"`` in
  train mode only, where the network's loss pops it
  (``nn/layers/base.py pop_aux_losses``);
* router, dispatch, experts and combine run in f32 whatever the dtype
  policy; the result is cast back to the input's dtype.

The JAX package dispatches and combines with dense einsums against an
[N, E, C] one-hot tensor. Each (expert, slot) pair holds at most one token,
so here the einsums are a scatter and a gather by slot index
(``e * C + position``, dropped tokens on one spare slot that is cut off):
the same sums without the N x E x C tensor (1.34 GB and ~343 GFLOP an
einsum at N = 16,384, E = 8, C = 2,560). The experts run as batched
products over [E, C, d]. Every shape is a function of N alone and nothing
reads a value back to the host, so the block runs inside a captured CUDA
graph (``nn/fused.py``). The forward's parts run under the profiler ranges
``moe.router``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``.

A token's capacity slot depends on the tokens before it in the same call,
so a row's output depends on the batch it came in (as in the JAX package):
a served answer equals ``output`` on the same batch.

Under an active batch group (``utils/collectives.py``: a data-parallel
step, rank r holding the r-th contiguous block of the global batch) the
block routes the global batch, as the JAX trainer's one global program
does: the capacity comes from the global N, each rank's queue positions
are offset by the per-expert counts of the lower ranks (one all-gather of
an [E] integer vector a block, no host read), a token is kept while its
global position is below the capacity, and f_e and p_e of the aux term are
global means (``sum_over_batch``: p_e's gradient summed over the group).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.attention import LayerNormalization, MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.utils import collectives as _collectives
from deeplearning4j_tpu_torch.utils.serde import register_config


class Routing(NamedTuple):
    """The router's decisions for N tokens: ``probs`` [N, E] f32, ``top``
    [N] the chosen expert, ``routed`` [N, E] bool (``top`` one-hot),
    ``keep`` [N] bool (within the expert's capacity), ``slot`` [N] the
    token's row in the [E * C + 1] dispatch buffer (E * C: dropped), and
    ``gate`` [N] the chosen expert's probability."""
    probs: torch.Tensor
    top: torch.Tensor
    routed: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    gate: torch.Tensor


@register_config
@dataclasses.dataclass(frozen=True)
class MoETransformerBlock(Layer):
    """Pre-norm block: LN -> MHA -> residual, LN -> MoE-MLP -> residual.
    Parameters nest as the JAX package's: ``ln1``, ``mha``, ``ln2``
    sub-dicts, ``router_W`` [d, E], and the experts stacked on a leading
    axis: ``expert_W1`` [E, d, h], ``expert_b1`` [E, h], ``expert_W2``
    [E, h, d], ``expert_b2`` [E, d]."""

    n_out: int = 0
    n_heads: int = 4
    n_experts: int = 4
    mlp_ratio: int = 4
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
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
            raise ValueError("MoETransformerBlock requires input size == n_out (residual)")
        ln1, mha, ln2 = self._parts()
        d, e = self.n_out, self.n_experts
        hidden = d * self.mlp_ratio
        it = _inputs.RecurrentType(d, input_type.timesteps)
        dev = generator.device

        def expert_stack(shape, fan_in, fan_out):
            return torch.stack([_init.init_weight("xavier", generator, shape, fan_in, fan_out,
                                                  dtype) for _ in range(e)])

        return {
            "ln1": ln1.init(generator, it, dtype),
            "mha": mha.init(generator, it, dtype),
            "ln2": ln2.init(generator, it, dtype),
            "router_W": _init.init_weight("xavier", generator, (d, e), d, e, dtype),
            "expert_W1": expert_stack((d, hidden), d, hidden),
            "expert_b1": torch.zeros((e, hidden), dtype=dtype, device=dev),
            "expert_W2": expert_stack((hidden, d), hidden, d),
            "expert_b2": torch.zeros((e, d), dtype=dtype, device=dev),
        }

    def capacity(self, n):
        """Slots an expert for ``n`` tokens (the JAX package's rule)."""
        return int(-(-n // self.n_experts) * self.capacity_factor) or 1

    @staticmethod
    def routed_tokens(n):
        """The N the queues are counted over: ``n`` local tokens times the
        active batch group's world (the global batch), else ``n``."""
        bg = _collectives.active()
        return n if bg is None else n * bg.world

    def route(self, params, x2d):
        """The ``Routing`` of ``x2d`` [N, d]: top-1 on the f32 softmax."""
        probs = torch.softmax(x2d.float() @ params["router_W"].float(), dim=-1)
        return self.assign(probs, probs.argmax(dim=-1))

    def assign(self, probs, top):
        """The ``Routing`` of N tokens with router probabilities ``probs``
        [N, E] sent to experts ``top`` [N]: each token's position in its
        expert's queue is the running count of the tokens sent there before
        it (``jnp.cumsum`` in the JAX package, exact in integers), taken
        along the contiguous token axis of an [E, N] one-hot."""
        e, n = self.n_experts, top.shape[0]
        bg = _collectives.active()
        cap = self.capacity(self.routed_tokens(n))
        onehot = top[None, :] == torch.arange(e, device=top.device)[:, None]
        counts = onehot.long().cumsum(1)
        pos = counts.gather(0, top[None, :])[0] - 1
        if bg is not None:
            # the lower ranks' tokens come first in the global order
            per_rank = _collectives.all_gather(counts[:, -1].contiguous(), bg.group).view(-1, e)
            pos = pos + per_rank[:bg.rank].sum(0).gather(0, top)
        keep = pos < cap
        slot = torch.where(keep, top * cap + pos, e * cap)
        gate = probs.gather(1, top[:, None])[:, 0]
        return Routing(probs, top, onehot.t(), keep, slot, gate)

    def moe_mlp(self, params, x2d):
        """x2d [N, d] -> (y [N, d] in x2d's dtype, aux loss f32 scalar).

        Expert parallelism: when the ``expert_*`` leaves hold E/m experts
        (this rank's slice of an active model group of m ranks, which all
        hold the same tokens), the rank runs its own experts' products on
        its slots of the dispatch buffer and the combine sums the ranks'
        partial outputs over the group (each token's expert lives on one
        rank, so the sum adds zeros elsewhere and equals the replicated
        combine). The dispatched tokens and the gates enter through
        ``IdPsumBwd`` (the ranks' partial cotangents sum) and the combine
        leaves through ``PsumIdBwd``; routing, capacity, dropping and the
        aux loss are computed whole on every rank, as without the group."""
        n, d = x2d.shape
        e, cap = self.n_experts, self.capacity(self.routed_tokens(n))
        el = params["expert_W1"].shape[0]
        mg = _collectives.active_model() if el != e else None
        if el != e and (mg is None or el * mg.world != e):
            raise ValueError(f"MoETransformerBlock: {el} of {e} experts here and no model "
                             "group that splits them")
        with record_function("moe.router"):
            r = self.route(params, x2d)
        with record_function("moe.dispatch"):
            xf = x2d.float()
            gate = r.gate
            if mg is not None:
                xf = _collectives.IdPsumBwd.apply(xf, mg.group)
                gate = _collectives.IdPsumBwd.apply(gate, mg.group)
            xe = xf.new_zeros((e * cap + 1, d)).index_add(0, r.slot, xf)[:e * cap]
            e0 = 0 if mg is None else mg.rank * el
            xe = xe[e0 * cap:(e0 + el) * cap]
        with record_function("moe.experts"):
            act = _act.get(self.activation)
            h = act(torch.bmm(xe.view(el, cap, d), params["expert_W1"].float())
                    + params["expert_b1"].float()[:, None])
            ye = torch.bmm(h, params["expert_W2"].float()) + params["expert_b2"].float()[:, None]
        with record_function("moe.combine"):
            ye = torch.cat([ye.new_zeros((e0 * cap, d)), ye.reshape(el * cap, d),
                            ye.new_zeros(((e - e0 - el) * cap + 1, d))])
            y = ye.index_select(0, r.slot) * gate[:, None]
            if mg is not None:
                y = mg.timed_call("ep_combine",
                                  lambda t: _collectives.PsumIdBwd.apply(t, mg.group), y)
        if _collectives.active() is None:
            frac, mean_p = r.routed.float().mean(dim=0), r.probs.mean(dim=0)
        else:  # global means; p_e's cotangent sums over the group
            n_all = self.routed_tokens(n)
            frac = _collectives.sum_over_batch(r.routed.float().sum(dim=0)) / n_all
            mean_p = _collectives.sum_over_batch(r.probs.sum(dim=0)) / n_all
        aux = e * (frac * mean_p).sum()
        return y.to(x2d.dtype), aux

    def mlp_input(self, params, x, mask=None):
        """(x after the attention residual, the MoE-MLP's input ``ln2(x)``)."""
        ln1, mha, ln2 = self._parts()
        h, _ = ln1.apply(params["ln1"], {}, x)
        attn, _ = mha.apply(params["mha"], {}, h, mask=mask)
        x = x + attn
        h, _ = ln2.apply(params["ln2"], {}, x)
        return x, h

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x, h = self.mlp_input(params, x, mask=mask)
        b, t, d = h.shape
        y, aux = self.moe_mlp(params, h.reshape(b * t, d))
        out_state = state
        if train:
            # an input-dependent loss term, stashed for one step: the
            # network's loss pops it, so the state keeps its structure
            out_state = dict(state)
            out_state["aux_loss"] = self.aux_loss_weight * aux
        return x + y.reshape(b, t, d), out_state
