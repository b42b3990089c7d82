"""MultiLayerNetwork: the sequential stack, as an ``nn.Module``.

Parameters live in one ``nn.ParameterDict`` per layer under the JAX
package's keys (``Wx``, ``Wh``, ``Wp``, ``b``, ``W``), so a checkpoint's
``params[i]['key']`` arrays map one to one. This slice ports inference:
``apply_fn`` runs under ``torch.inference_mode()``; ``fit`` and the loss
arrive with the training slice.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.device import resolve_device


def _accepts_mask(layer):
    return "mask" in inspect.signature(type(layer).apply).parameters


class MultiLayerNetwork(nn.Module):
    """Sequential network: config in, inference forward out."""

    def __init__(self, conf: MultiLayerConfiguration, *, device="cuda"):
        super().__init__()
        self.conf = conf
        self._device = resolve_device(device)
        self.layer_inputs, self.output_type = conf.layer_input_types()
        self._mask_aware = [_accepts_mask(l) for l in conf.layers]
        self.layer_params = nn.ModuleList()
        self.state = [{} for _ in conf.layers]
        # checkpoint entries this slice carries without using: the JAX
        # package's updater state ("opt..." arrays) and step RNG chain
        self.opt_arrays = {}
        self.rng = None
        self.iteration = 0
        self.epoch = 0

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return self._device

    @property
    def params(self):
        """Per-layer parameter dicts (``None`` before ``init``)."""
        return list(self.layer_params) if len(self.layer_params) else None

    def init(self, generator=None, dtype=None):
        """Initialize parameters from ``generator`` (default: a CPU
        generator seeded with ``conf.seed``) and move them to the
        network's device. Returns the per-layer parameter dicts."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        dtype = dtype or _dtypes.get_policy().param_dtype
        dicts = []
        for layer, in_type in zip(self.conf.layers, self.layer_inputs):
            p = layer.init(generator, in_type, dtype)
            if layer.init_state(in_type, dtype):
                raise NotImplementedError(
                    f"{type(layer).__name__} carries state; stateful layers "
                    "are not ported yet")
            dicts.append(nn.ParameterDict(
                {k: nn.Parameter(v.to(self._device), requires_grad=False)
                 for k, v in p.items()}))
        self.layer_params = nn.ModuleList(dicts)
        self.state = [{} for _ in self.conf.layers]
        return self.params

    def apply_fn(self, params, state, x, *, train=False, mask=None):
        """Inference forward pass. Returns (output, new_state)."""
        if train:
            raise NotImplementedError("training is not ported yet: apply_fn "
                                      "runs inference only")
        new_state = list(state)
        cur_type = self.conf.input_type
        with torch.inference_mode():
            for i, layer in enumerate(self.conf.layers):
                fam = layer.input_family
                if fam is not None and not isinstance(cur_type, fam):
                    x = _inputs.adapt(x, cur_type, fam)
                    cur_type = _inputs.adapted_type(cur_type, fam)
                kwargs = {}
                if self._mask_aware[i] and mask is not None and mask.dim() >= 2:
                    kwargs["mask"] = mask
                x, new_state[i] = layer.apply(params[i], state[i], x, **kwargs)
                cur_type = layer.output_type(cur_type)
        return x, new_state

    def forward(self, x, mask=None):
        return self.apply_fn(self.params, self.state, x, mask=mask)[0]

    def output(self, x, mask=None):
        """Inference on host or device input; returns a tensor on the
        network's device."""
        if self.params is None:
            self.init()
        dev = self.device
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            device=dev)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask)
                                   else mask, device=dev)
        return self.forward(x, mask=mask)

    def num_params(self):
        return sum(int(p.numel()) for p in self.parameters())
