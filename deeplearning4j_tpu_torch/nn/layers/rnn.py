"""Recurrent layers: LSTM, GravesLSTM (peepholes) and RnnOutputLayer.

Data layout: [batch, time, features]; the recurrence runs time-major.
A [batch, time] mask (1 = valid) freezes h and c at padded steps and zeroes
the output there. Gate order in the fused 4H axis: i | f | g | o.

With sigmoid gates and a tanh activation, ``LSTM.apply`` hands the whole
sequence to ``ops.lstm_seq.lstm_seq`` (the Hopper kernel on CUDA tensors,
its plain version on CPU tensors); other activations take the ``_step``
time loop, as the JAX package's scan path does.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import ParamLayer
from deeplearning4j_tpu_torch.nn.layers.core import matmul
from deeplearning4j_tpu_torch.ops import lstm_seq as _lstm_seq
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.serde import register_config


@register_config
@dataclasses.dataclass(frozen=True)
class LSTM(ParamLayer):
    """params: Wx [nIn,4H], Wh [H,4H], b [4H] (+ Wp [3,H] with peepholes)."""

    n_out: int = 0
    forget_gate_bias: float = 1.0
    gate_activation: object = "sigmoid"
    activation: object = dataclasses.field(default="tanh", kw_only=True)
    peephole: bool = False

    input_family = _inputs.RecurrentType

    WEIGHT_KEYS = ("Wx", "Wh", "Wp")
    BIAS_KEYS = ("b",)

    def output_type(self, input_type):
        if not isinstance(input_type, _inputs.RecurrentType):
            raise TypeError(f"{type(self).__name__} needs RNN input, got {input_type}")
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in, h = input_type.size, self.n_out
        b = torch.zeros((4 * h,), dtype=dtype, device=generator.device)
        b[h:2 * h] = self.forget_gate_bias  # forget-gate slice
        p = {
            "Wx": _init.init_weight(self.weight_init, generator, (n_in, 4 * h), n_in, h, dtype),
            "Wh": _init.init_weight(self.weight_init, generator, (h, 4 * h), h, h, dtype),
            "b": b,
        }
        if self.peephole:
            # diagonal peephole weights for i, f, o gates (GravesLSTM)
            p["Wp"] = 0.1 * torch.randn((3, h), generator=generator, dtype=dtype,
                                        device=generator.device)
        return p

    def _step(self, params, carry, xz_t, mask_t):
        """One time step. xz_t: precomputed x-projection [B, 4H]."""
        h_prev, c_prev = carry
        z = xz_t + matmul(h_prev, params["Wh"])
        zi, zf, zg, zo = z.split(self.n_out, dim=-1)
        gate = _act.get(self.gate_activation)
        act = self.activation_fn()
        if self.peephole:
            wp = params["Wp"]
            zi = zi + wp[0] * c_prev
            zf = zf + wp[1] * c_prev
        i, f = gate(zi), gate(zf)
        g = act(zg)
        c = f * c_prev + i * g
        if self.peephole:
            zo = zo + params["Wp"][2] * c
        o = gate(zo)
        h = o * act(c)
        if mask_t is not None:
            m = mask_t[:, None].to(h.dtype)
            h = m * h + (1 - m) * h_prev
            c = m * c + (1 - m) * c_prev
        return (h, c), h

    def _sequence_op(self):
        """Whether the sequence goes to ``lstm_seq`` (the kernel's
        contract is sigmoid gates with tanh cell/output activations)."""
        return (self.gate_activation, self.activation) == ("sigmoid", "tanh")

    def apply(self, params, state, x, *, train=False, mask=None,
              initial_state=None):
        b, t, _ = x.shape
        hsz = self.n_out
        # one matmul for every timestep's input projection
        xz = matmul(x.reshape(b * t, -1), params["Wx"]) + params["b"]
        xz = xz.reshape(b, t, 4 * hsz).transpose(0, 1)  # time-major
        mask_tm = None if mask is None else mask.transpose(0, 1)
        if initial_state is None:
            h0 = torch.zeros((b, hsz), dtype=xz.dtype, device=xz.device)
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = initial_state

        if self._sequence_op():
            # the sequence op runs in the COMPUTE dtype (bf16 under the
            # mixed policy); h and c stay f32 inside it
            cd, _ = _dtypes.compute_dtypes_for(x.dtype)
            wp = params.get("Wp")
            hs, _, _, _ = _lstm_seq.lstm_seq(
                xz.to(cd).contiguous(), params["Wh"].to(cd).contiguous(),
                h0.to(cd), c0.to(cd),
                wp=None if wp is None else wp.to(cd).contiguous(),
                mask=None if mask_tm is None else mask_tm.contiguous())
        else:
            carry, hs = (h0, c0), []
            for step in range(t):
                carry, h = self._step(params, carry, xz[step],
                                      None if mask_tm is None else mask_tm[step])
                hs.append(h)
            hs = torch.stack(hs)
        y = hs.transpose(0, 1)  # back to batch-major
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state

    def step_stateful(self, params, h_c, x_t):
        """Single-step inference API (reference: RecurrentLayer.rnnTimeStep)."""
        xz = matmul(x_t, params["Wx"]) + params["b"]
        return self._step(params, h_c, xz, None)


@register_config
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference: GravesLSTM.java, after
    Graves 2013)."""

    peephole: bool = True


@register_config
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(ParamLayer):
    """Per-timestep dense head: [B,T,F] x [F,O] as one flattened matmul,
    scored per timestep by its loss (a [B,T] mask drops padded steps)."""

    n_out: int = 0
    loss: object = "mcxent"
    activation: object = dataclasses.field(default="softmax", kw_only=True)

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = input_type.size
        return {"W": _init.init_weight(self.weight_init, generator, (n_in, self.n_out),
                                       n_in, self.n_out, dtype),
                "b": torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)}

    def apply(self, params, state, x, *, train=False):
        b, t, f = x.shape
        z = matmul(x.reshape(b * t, f), params["W"]) + params["b"]
        return self.activation_fn()(z.reshape(b, t, self.n_out)), state

    def compute_loss(self, predictions, labels, mask=None):
        return _losses.get(self.loss)(predictions, labels, mask)
