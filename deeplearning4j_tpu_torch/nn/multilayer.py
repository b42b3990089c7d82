"""MultiLayerNetwork: the sequential stack, as an ``nn.Module``.

Parameters live in one ``nn.ParameterDict`` per layer under the JAX
package's keys (``Wx``, ``W``, ``b``, ...); a layer whose parameters nest
(TransformerBlock's ``ln1``/``mha``/``ln2``) holds nested ParameterDicts,
so each parameter's path maps one to one onto the checkpoint's keystr path
(``params[1]['mha']['Wqkv']``).

The functional core mirrors the JAX package's: ``apply_fn``, ``loss_fn``,
``compute_gradients``, ``apply_update``, ``apply_constraints`` and
``make_train_step``; ``fit``, ``score`` and ``output`` wrap it. Parameters
are created with ``requires_grad=False`` (serving needs no graph);
``compute_gradients`` turns it on. The updater changes parameters and its
state in place. ``fit`` is a plain loop: one step per batch, the loss
fetched one step late so the host never waits on the step it just issued.
Input dropout, weight noise and truncated BPTT are not ported yet: training
a network that needs them raises ``NotImplementedError``.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.datasets.iterator import iter_batches
from deeplearning4j_tpu_torch.nn import gradnorm as _gradnorm
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, \"Rest of the training core\")"


def _accepts_mask(layer):
    return "mask" in inspect.signature(type(layer).apply).parameters


def _param_tree(d, device):
    """A (nested) ParameterDict of frozen parameters from a dict of tensors."""
    return nn.ParameterDict({
        k: _param_tree(v, device) if isinstance(v, dict)
        else nn.Parameter(v.to(device), requires_grad=False)
        for k, v in d.items()})


def _as_tensor(a, device, dtype=None):
    if a is None:
        return None
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


class MultiLayerNetwork(nn.Module):
    """Sequential network: config in, functional core + convenience API out."""

    def __init__(self, conf: MultiLayerConfiguration, *, device="cuda"):
        super().__init__()
        self.conf = conf
        self._device = resolve_device(device)
        self.layer_inputs, self.output_type = conf.layer_input_types()
        self._mask_aware = [_accepts_mask(l) for l in conf.layers]
        self.layer_params = nn.ModuleList()
        self.state = [{} for _ in conf.layers]
        self.opt_state = None
        # the JAX package's step RNG chain, carried through checkpoints
        # unused (no ported layer draws random numbers)
        self.rng = None
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.score_history = []

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return self._device

    @property
    def params(self):
        """Per-layer parameter dicts (``None`` before ``init``)."""
        return list(self.layer_params) if len(self.layer_params) else None

    # ------------------------------------------------------------------
    # functional core
    # ------------------------------------------------------------------

    def init(self, generator=None, dtype=None):
        """Initialize parameters from ``generator`` (default: a CPU
        generator seeded with ``conf.seed``), move them to the network's
        device; the updater state is made at the first ``fit``. Returns
        the per-layer parameter dicts."""
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
            dicts.append(_param_tree(p, self._device))
        self.layer_params = nn.ModuleList(dicts)
        self.state = [{} for _ in self.conf.layers]
        self.opt_state = None
        return self.params

    def _check_trainable(self):
        for layer in self.conf.layers:
            if layer.dropout > 0.0:
                raise NotImplementedError(
                    f"{type(layer).__name__}: input dropout in train mode {_NOT_PORTED}")
            if getattr(layer, "weight_noise", None) is not None:
                raise NotImplementedError(
                    f"{type(layer).__name__}: weight noise in train mode {_NOT_PORTED}")

    def apply_fn(self, params, state, x, *, train=False, mask=None):
        """Forward pass. Returns (output, new_state). ``train=False`` runs
        under ``torch.inference_mode()``; ``train=True`` builds the graph."""
        if train:
            self._check_trainable()
        new_state = list(state)
        cur_type = self.conf.input_type
        with torch.enable_grad() if train else torch.inference_mode():
            for i, layer in enumerate(self.conf.layers):
                fam = layer.input_family
                if fam is not None and not isinstance(cur_type, fam):
                    x = _inputs.adapt(x, cur_type, fam)
                    cur_type = _inputs.adapted_type(cur_type, fam)
                kwargs = {}
                # a 1-d mask marks valid examples; only [batch, time] masks
                # reach mask-aware layers
                if self._mask_aware[i] and mask is not None and mask.dim() >= 2:
                    kwargs["mask"] = mask
                x, new_state[i] = layer.apply(params[i], state[i], x, train=train, **kwargs)
                cur_type = layer.output_type(cur_type)
        return x, new_state

    def loss_fn(self, params, state, x, y, *, train=True, mask=None, label_mask=None):
        """Score = output-layer loss + L1/L2 penalties. Returns
        (loss, (new_state, predictions))."""
        out_layer = self.conf.layers[-1]
        if not hasattr(out_layer, "compute_loss"):
            raise ValueError("Last layer must be an output/loss layer, got "
                             f"{type(out_layer).__name__}")
        lm = label_mask if label_mask is not None else mask
        preds, new_state = self.apply_fn(params, state, x, train=train, mask=mask)
        with torch.enable_grad() if train else torch.inference_mode():
            loss = out_layer.compute_loss(preds, y, lm)
            for layer, p in zip(self.conf.layers, params):
                if len(p):
                    loss = loss + layer.regularization_penalty(p)
            loss, new_state = _base.pop_aux_losses(loss, new_state)
        return loss, (new_state, preds)

    def compute_gradients(self, params, state, x, y, *, mask=None):
        """Loss and normalized/clipped gradients. Returns (loss, new_state,
        grads) with ``grads`` a list of per-layer dicts shaped as
        ``params``. A parameter the loss does not reach gets zeros."""
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss, (new_state, _) = self.loss_fn(params, state, x, y, train=True, mask=mask)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)])
        grads = tree_like(params, gs)
        grads = _gradnorm.normalize_grads(self.conf.gradient_normalization, grads,
                                          self.conf.gradient_normalization_threshold)
        return loss.detach(), new_state, grads

    def apply_update(self, params, opt_state, grads, step):
        """updater -> parameter add -> constraints, all in place. Returns
        (params, opt_state)."""
        with torch.profiler.record_function("updater.step"):
            opt_state = self.conf.updater.update_(params, grads, opt_state, step)
        return self.apply_constraints(params, step), opt_state

    def apply_constraints(self, params, step):
        return [l.apply_constraints(p, step, 0) if len(p) else p
                for l, p in zip(self.conf.layers, params)]

    def make_train_step(self):
        """The train step: (params, state, opt_state, x, y, step, mask) ->
        (params, state, opt_state, loss)."""
        def train_step(params, state, opt_state, x, y, step, mask=None):
            loss, new_state, grads = self.compute_gradients(params, state, x, y, mask=mask)
            params, opt_state = self.apply_update(params, opt_state, grads, step)
            return params, new_state, opt_state, loss
        return train_step

    # ------------------------------------------------------------------
    # convenience (stateful) API
    # ------------------------------------------------------------------

    def fit(self, data, labels=None, *, epochs=1, batch_size=None, mask=None,
            pad_ragged=None):
        """Train. ``data`` is an (x, y) pair, feature arrays with ``labels``,
        or an iterable of minibatches (see ``datasets.iter_batches``);
        arrays may be numpy or tensors, and move to the network's device.
        ``pad_ragged=True`` pads every batch to the first one's size with a
        validity mask (exact under the masked-mean losses). Each step's loss
        lands in ``score_history`` one step late; ``score_value`` is the
        last. Returns the network."""
        if self.params is None:
            self.init()
        if self.opt_state is None:
            self.opt_state = self.conf.updater.init(self.params)
        step_fn = self.make_train_step()
        dev = self.device
        self.score_history = []
        for _ in range(epochs):
            pending = None
            for x, y, m in iter_batches(data, labels, batch_size, mask,
                                        pad_to=True if pad_ragged else None):
                x, y, m = _as_tensor(x, dev), _as_tensor(y, dev), _as_tensor(m, dev)
                if (self.conf.backprop_type == "tbptt" and x.dim() == 3 and y.dim() == 3
                        and x.shape[1] > self.conf.tbptt_fwd_length):
                    raise NotImplementedError(f"truncated BPTT {_NOT_PORTED}")
                _, self.state, self.opt_state, loss = step_fn(
                    self.params, self.state, self.opt_state, x, y, self.iteration, m)
                self.iteration += 1
                if pending is not None:
                    self.score_history.append(float(pending))
                pending = loss
            if pending is not None:
                self.score_history.append(float(pending))
            self.epoch += 1
        if self.score_history:
            self.score_value = self.score_history[-1]
        return self

    def score(self, x, y, mask=None):
        """The loss on (x, y) without training (inference forward)."""
        if self.params is None:
            self.init()
        dev = self.device
        loss, _ = self.loss_fn(self.params, self.state, _as_tensor(x, dev), _as_tensor(y, dev),
                               train=False, mask=_as_tensor(mask, dev))
        return float(loss)

    def forward(self, x, mask=None):
        return self.apply_fn(self.params, self.state, x, mask=mask)[0]

    def output(self, x, mask=None):
        """Inference on host or device input; returns a tensor on the
        network's device."""
        if self.params is None:
            self.init()
        dev = self.device
        return self.forward(_as_tensor(x, dev), mask=_as_tensor(mask, dev))

    def num_params(self):
        return sum(int(p.numel()) for p in self.parameters())
