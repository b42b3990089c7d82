"""Core feed-forward layers: Dense and Output, and the policy matmul."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import ParamLayer
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.serde import register_config


def matmul(x, w):
    """Matmul under the dtype policy: operands rounded to the compute dtype,
    products summed and returned in the accumulation dtype (the JAX
    package's ``preferred_element_type``). A bf16 x bf16 product is exact
    in f32, so upcasting the rounded operands gives that contract with
    plain torch ops."""
    cd, ad = _dtypes.compute_dtypes_for(x.dtype)
    return torch.matmul(x.to(cd).to(ad), w.to(cd).to(ad))


@register_config
@dataclasses.dataclass(frozen=True)
class DenseLayer(ParamLayer):
    n_out: int = 0
    has_bias: bool = True

    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return _inputs.FeedForwardType(self.n_out)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = _inputs.adapted_type(input_type, _inputs.FeedForwardType).size
        p = {"W": _init.init_weight(self.weight_init, generator, (n_in, self.n_out),
                                    n_in, self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        z = matmul(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss head. The loss is carried for the config's sake; it is
    computed by the training slice."""

    loss: object = "mcxent"
    activation: object = dataclasses.field(default="softmax", kw_only=True)
