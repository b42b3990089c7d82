"""Recurrent layers: LSTM, GravesLSTM (peepholes), SimpleRnn, Bidirectional,
GravesBidirectionalLSTM, the RNN output/loss heads and LastTimeStep.

Data layout: [batch, time, features]; the recurrence runs time-major.
A [batch, time] mask (1 = valid) freezes h and c at padded steps and zeroes
the output there. Gate order in the fused 4H axis: i | f | g | o.

With sigmoid gates and a tanh activation, ``LSTM.apply`` and
``LSTM.apply_with_carry`` hand the whole sequence to
``ops.lstm_seq.lstm_seq`` (the Hopper kernel on CUDA tensors, its plain
version on CPU tensors; its backward is ``lstm_seq_bwd`` on both); other
activations take the ``_step`` time loop, as the JAX package's scan path
does. ``apply_with_carry`` is the TBPTT and ``rnn_time_step`` building
block: it starts from a carried (h, c) and returns the final one, kept in
f32 (the kernel's own state), so a bf16 run does not round the cell state
at a chunk boundary. The JAX package scans there; under f32 the two agree
to the kernel's tolerance.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer
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

    def _project(self, params, x, mask):
        """One matmul for every timestep's input projection: xz [T,B,4H]
        and the mask time-major."""
        b, t, _ = x.shape
        xz = matmul(x.reshape(b * t, -1), params["Wx"]) + params["b"]
        xz = xz.reshape(b, t, 4 * self.n_out).transpose(0, 1)
        return xz, None if mask is None else mask.transpose(0, 1)

    def _run(self, params, xz, h0, c0, mask_tm, x_dtype):
        """The recurrence from (h0, c0): (hs [T,B,H], final (h, c))."""
        if self._sequence_op():
            # the sequence op runs in the COMPUTE dtype (bf16 under the
            # mixed policy); h and c stay f32 inside it, and the final
            # state comes back in f32
            cd, _ = _dtypes.compute_dtypes_for(x_dtype)
            wp = params.get("Wp")
            out = _lstm_seq.lstm_seq(
                xz.to(cd).contiguous(), params["Wh"].to(cd).contiguous(), h0, c0,
                wp=None if wp is None else wp.to(cd).contiguous(),
                mask=None if mask_tm is None else mask_tm.contiguous())
            return out.hs, (out.h_state, out.c_state)
        carry, hs = (h0, c0), []
        for step in range(xz.shape[0]):
            carry, h = self._step(params, carry, xz[step],
                                  None if mask_tm is None else mask_tm[step])
            hs.append(h)
        return torch.stack(hs), carry

    def apply(self, params, state, x, *, train=False, mask=None,
              initial_state=None):
        b = x.shape[0]
        xz, mask_tm = self._project(params, x, mask)
        if initial_state is None:
            h0 = torch.zeros((b, self.n_out), dtype=xz.dtype, device=xz.device)
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = initial_state
        if self._sequence_op():
            cd, _ = _dtypes.compute_dtypes_for(x.dtype)
            h0, c0 = h0.to(cd), c0.to(cd)
        hs, _ = self._run(params, xz, h0, c0, mask_tm, x.dtype)
        y = hs.transpose(0, 1)  # back to batch-major
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state

    def step_stateful(self, params, h_c, x_t):
        """Single-step inference API (reference: RecurrentLayer.rnnTimeStep)."""
        xz = matmul(x_t, params["Wx"]) + params["b"]
        return self._step(params, h_c, xz, None)

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z)

    def apply_with_carry(self, params, carry, x, *, mask=None):
        """Sequence apply from a carried (h, c) (None: zeros) that also
        returns the final (h, c): the TBPTT building block (reference:
        rnnActivateUsingStoredState / doTruncatedBPTT at
        MultiLayerNetwork.java:1252-1254). The carry is kept in f32 (f64
        for f64 inputs)."""
        if carry is None:
            carry = self.zero_carry(x.shape[0], torch.promote_types(x.dtype, torch.float32),
                                    x.device)
        xz, mask_tm = self._project(params, x, mask)
        hs, final = self._run(params, xz, carry[0], carry[1], mask_tm, x.dtype)
        y = hs.transpose(0, 1)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, final


@register_config
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference: GravesLSTM.java, after
    Graves 2013)."""

    peephole: bool = True


@register_config
@dataclasses.dataclass(frozen=True)
class SimpleRnn(ParamLayer):
    """Vanilla tanh RNN. params: Wx [nIn,H], Wh [H,H], b [H]."""

    n_out: int = 0
    activation: object = dataclasses.field(default="tanh", kw_only=True)

    input_family = _inputs.RecurrentType

    WEIGHT_KEYS = ("Wx", "Wh")
    BIAS_KEYS = ("b",)

    def output_type(self, input_type):
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in, h = input_type.size, self.n_out
        return {
            "Wx": _init.init_weight(self.weight_init, generator, (n_in, h), n_in, h, dtype),
            "Wh": _init.init_weight(self.weight_init, generator, (h, h), h, h, dtype),
            "b": torch.zeros((h,), dtype=dtype, device=generator.device),
        }

    def apply(self, params, state, x, *, train=False, mask=None,
              initial_state=None):
        b, t, _ = x.shape
        act = self.activation_fn()
        xz = (matmul(x.reshape(b * t, -1), params["Wx"]) + params["b"]).reshape(b, t, -1)
        xz = xz.transpose(0, 1)
        mask_tm = None if mask is None else mask.transpose(0, 1)
        h = initial_state if initial_state is not None else \
            torch.zeros((b, self.n_out), dtype=xz.dtype, device=xz.device)
        hs = []
        for step in range(t):
            h_new = act(xz[step] + matmul(h, params["Wh"]))
            if mask_tm is not None:
                m = mask_tm[step][:, None].to(h_new.dtype)
                h_new = m * h_new + (1 - m) * h
            h = h_new
            hs.append(h)
        y = torch.stack(hs).transpose(0, 1)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def apply_with_carry(self, params, carry, x, *, mask=None):
        if carry is None:
            carry = self.zero_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.apply(params, {}, x, mask=mask, initial_state=carry)
        return y, last_time_step(y, mask)  # the final hidden: the last valid output


@register_config
@dataclasses.dataclass(frozen=True)
class Bidirectional(Layer):
    """A recurrent layer run forward and backward over time (reference:
    the Bidirectional wrapper and GravesBidirectionalLSTM.java). ``mode``:
    concat | add | mul | ave. As in the JAX package, the backward direction
    reverses the whole [B, T] sequence, padding included. Parameters nest
    as ``fwd`` and ``bwd``."""

    layer: object = None
    mode: str = "concat"

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        inner = self.layer.output_type(input_type)
        if self.mode == "concat":
            return _inputs.RecurrentType(inner.size * 2, inner.timesteps)
        return inner

    def init(self, generator, input_type, dtype=torch.float32):
        return {"fwd": self.layer.init(generator, input_type, dtype),
                "bwd": self.layer.init(generator, input_type, dtype)}

    def regularization_penalty(self, params):
        return (self.layer.regularization_penalty(params["fwd"]) +
                self.layer.regularization_penalty(params["bwd"]))

    def apply(self, params, state, x, *, train=False, mask=None):
        kw = {} if mask is None else {"mask": mask}
        yf, _ = self.layer.apply(params["fwd"], {}, x, train=train, **kw)
        if mask is not None:
            kw = {"mask": torch.flip(mask, dims=[1])}
        yb, _ = self.layer.apply(params["bwd"], {}, torch.flip(x, dims=[1]), train=train, **kw)
        yb = torch.flip(yb, dims=[1])
        if self.mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "add":
            y = yf + yb
        elif self.mode == "mul":
            y = yf * yb
        elif self.mode == "ave":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(f"Unknown Bidirectional mode {self.mode!r}")
        return y, state


@register_config
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(Layer):
    """Bidirectional(GravesLSTM) with concat output (reference:
    GravesBidirectionalLSTM.java)."""

    n_out: int = 0
    activation: object = "tanh"
    weight_init: object = "xavier"

    input_family = _inputs.RecurrentType

    def _inner(self):
        return Bidirectional(layer=GravesLSTM(n_out=self.n_out, activation=self.activation,
                                              weight_init=self.weight_init), mode="concat")

    def output_type(self, input_type):
        return self._inner().output_type(input_type)

    def init(self, generator, input_type, dtype=torch.float32):
        return self._inner().init(generator, input_type, dtype)

    def regularization_penalty(self, params):
        return self._inner().regularization_penalty(params)

    def apply(self, params, state, x, *, train=False, mask=None):
        return self._inner().apply(params, state, x, train=train, mask=mask)


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


@register_config
@dataclasses.dataclass(frozen=True)
class RnnLossLayer(Layer):
    """Parameterless per-timestep loss (reference: conf/layers/RnnLossLayer.java)."""

    loss: object = "mcxent"
    activation: object = "identity"

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False):
        return _act.get(self.activation)(x), state

    def compute_loss(self, predictions, labels, mask=None):
        return _losses.get(self.loss)(predictions, labels, mask)


@register_config
@dataclasses.dataclass(frozen=True)
class LastTimeStep(Layer):
    """The last (mask-aware) timestep: [B,T,F] -> [B,F] (reference:
    conf/graph/rnn/LastTimeStepVertex.java)."""

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        return _inputs.FeedForwardType(input_type.size)

    def apply(self, params, state, x, *, train=False, mask=None):
        return last_time_step(x, mask), state


def last_time_step(x, mask):
    """x[:, t_last] with t_last the last valid step of each row under a
    [B, T] mask (the last step without one)."""
    if mask is None:
        return x[:, -1, :]
    idx = (mask.to(torch.int64).sum(dim=1) - 1).clamp_min(0)
    return x[torch.arange(x.shape[0], device=x.device), idx, :]
