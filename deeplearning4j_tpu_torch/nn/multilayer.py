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
state in place. ``fit`` runs ``continuous.StepDriver``: at K=1 one step a
batch, the loss fetched one step late so the host never waits on the step
it just issued; with ``steps_per_dispatch=K`` K steps a dispatch through
``nn/fused.py`` (one CUDA-graph replay on a card), the batches bucketed
and stacked on a prefetch thread. ``make_train_step(with_health=True)``
also returns the numerics watchdog's bundle (``telemetry/health.py``).
``gradient_checkpointing`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint``.

Truncated BPTT (``backprop_type="tbptt"``): a batch of 3-d features and
labels longer than ``tbptt_fwd_length`` trains in chunks of that length,
one updater step a chunk, with the recurrent layers' (h, c) carried from
chunk to chunk and detached at each boundary (``_apply_rnn``,
``make_tbptt_step``, ``_fit_tbptt``). ``rnn_time_step`` streams inference
one step (or a short chunk) at a time with the same carries;
``rnn_clear_previous_state`` drops them.

Layer state (BatchNormalization's running statistics, also nested, as in
ResidualBottleneck) is a list of per-layer dicts of plain tensors, replaced
by each train step. An output layer with ``loss_from_features``
(``CenterLossOutputLayer``) gets its input activation and the labels.
Input dropout and ``DropoutLayer`` draw from a seed a train step
(``nn/layers/base.py step_seed``), split into one seed a layer; weight
noise (``nn/weightnoise.py``) perturbs a layer's parameters from its seed
before the layer runs in train mode.

Freezing (``nn/transfer.py``): ``frozen_layers`` holds the indices of
layers that train as DL4J's FrozenLayer does. A frozen layer runs with
``train=False`` in every pass (BatchNormalization normalizes with its
running statistics and keeps them, dropout is off), its parameters stay
out of autograd and out of the updater, whose state for them is left as
it is. Listeners (``nn/listeners.py``) hear every fit loop, one step
late; ``evaluate``, ``evaluate_regression`` and ``evaluate_roc`` run the
``eval/`` classes over arrays, an (x, y) pair or a DataSetIterator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from deeplearning4j_tpu_torch.datasets.iterator import iter_batches
from deeplearning4j_tpu_torch.nn import gradnorm as _gradnorm
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.nn.layers.base import apply_layer, split_seed, step_seed
from deeplearning4j_tpu_torch.telemetry import health as _health
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.trees import drop_entries, tree_leaves, tree_like

def _param_tree(d, device):
    """A (nested) ParameterDict of frozen parameters from a dict of tensors."""
    return nn.ParameterDict({
        k: _param_tree(v, device) if isinstance(v, dict)
        else nn.Parameter(v.to(device), requires_grad=False)
        for k, v in d.items()})


def _to_device(d, device):
    """A (nested) dict of tensors on ``device``."""
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in d.items()}


def _detach(carry):
    """A carry (a tensor or a tuple of them) cut from the graph."""
    return tuple(c.detach() for c in carry) if isinstance(carry, tuple) else carry.detach()


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
        self._mask_aware = [_base.takes(type(l), "mask") for l in conf.layers]
        self.layer_params = nn.ModuleList()
        self.state = [{} for _ in conf.layers]
        self.opt_state = None
        # the JAX package's step RNG chain, carried through checkpoints; the
        # port's draws come from ``step_seed(conf.seed, iteration)``
        self.rng = None
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.score_history = []
        self._rnn_stream_state = None
        self.listeners = []
        self.last_input = None  # the fit loop's current batch (listeners read it)
        # indices of the layers that train frozen (``nn/transfer.py``)
        self.frozen_layers = ()

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
        generator seeded with ``conf.seed``) and layer state, on the
        network's device; the updater state is made at the first ``fit``.
        Returns the per-layer parameter dicts."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        dtype = dtype or _dtypes.get_policy().param_dtype
        dicts, state = [], []
        for layer, in_type in zip(self.conf.layers, self.layer_inputs):
            dicts.append(_param_tree(layer.init(generator, in_type, dtype), self._device))
            state.append(_to_device(layer.init_state(in_type, dtype), self._device))
        self.layer_params = nn.ModuleList(dicts)
        self.state = state
        self.opt_state = None
        return self.params

    def _layer_train(self, i, train):
        """The mode layer ``i`` runs in: a frozen layer always as in
        inference (FrozenLayer.java)."""
        return train and i not in self.frozen_layers

    def _trainable(self, tree):
        """A per-layer tree (parameters, gradients, updater state) with the
        frozen layers' entries emptied."""
        return drop_entries(tree, set(self.frozen_layers), range(len(self.conf.layers)))

    def _watch(self, params):
        """Turn autograd on for the trainable parameters and off for the
        frozen ones; returns the trainable tree."""
        for p in tree_leaves(params):
            p.requires_grad_(False)
        trainable = self._trainable(params)
        for p in tree_leaves(trainable):
            p.requires_grad_(True)
        return trainable

    def apply_fn(self, params, state, x, *, train=False, mask=None, rng=None, layer_limit=None):
        """Forward pass through the first ``layer_limit`` layers (all by
        default). Returns (output, new_state). ``train=False`` runs under
        ``torch.inference_mode()``; ``train=True`` builds the graph. ``rng``
        is the step's seed (None: no random draws)."""
        new_state = list(state)
        cur_type = self.conf.input_type
        n = len(self.conf.layers) if layer_limit is None else layer_limit
        seeds = split_seed(rng, n) if rng is not None else [None] * n
        with torch.enable_grad() if train else torch.inference_mode():
            for i, layer in enumerate(self.conf.layers[:n]):
                fam = layer.input_family
                if fam is not None and not isinstance(cur_type, fam):
                    x = _inputs.adapt(x, cur_type, fam)
                    cur_type = _inputs.adapted_type(cur_type, fam)
                kwargs = {}
                # a 1-d mask marks valid examples; only [batch, time] masks
                # reach mask-aware layers
                if self._mask_aware[i] and mask is not None and mask.dim() >= 2:
                    kwargs["mask"] = mask
                l_train = self._layer_train(i, train)
                if l_train and self.conf.gradient_checkpointing:
                    # remat: keep the layer's input, recompute its activations
                    # in the backward (memory for operations); the seed makes
                    # the recompute draw the same masks
                    x, new_state[i] = torch.utils.checkpoint.checkpoint(
                        functools.partial(apply_layer, layer, train=l_train, rng=seeds[i],
                                          **kwargs),
                        params[i], state[i], x, use_reentrant=False, preserve_rng_state=False)
                else:
                    x, new_state[i] = apply_layer(layer, params[i], state[i], x, train=l_train,
                                                  rng=seeds[i], **kwargs)
                cur_type = layer.output_type(cur_type)
        return x, new_state

    def loss_fn(self, params, state, x, y, *, train=True, mask=None, label_mask=None,
                rng=None):
        """Score = output-layer loss + L1/L2 penalties. Returns
        (loss, (new_state, predictions)). An output layer with
        ``loss_from_features`` computes the loss from its input."""
        out_layer = self.conf.layers[-1]
        lm = label_mask if label_mask is not None else mask
        from_features = hasattr(out_layer, "loss_from_features")
        if not from_features and not hasattr(out_layer, "compute_loss"):
            raise ValueError("Last layer must be an output/loss layer, got "
                             f"{type(out_layer).__name__}")
        n = len(self.conf.layers) - 1 if from_features else None
        out, new_state = self.apply_fn(params, state, x, train=train, mask=mask, rng=rng,
                                       layer_limit=n)
        with torch.enable_grad() if train else torch.inference_mode():
            if from_features:
                loss, preds, new_state[-1] = out_layer.loss_from_features(
                    params[-1], state[-1], out, y, lm,
                    train=self._layer_train(len(params) - 1, train))
            else:
                preds, loss = out, out_layer.compute_loss(out, y, lm)
            for layer, p in zip(self.conf.layers, params):
                if len(p):
                    loss = loss + layer.regularization_penalty(p)
            loss, new_state = _base.pop_aux_losses(loss, new_state)
        return loss, (new_state, preds)

    def compute_gradients(self, params, state, x, y, *, mask=None, rng=None):
        """Loss and normalized/clipped gradients. Returns (loss, new_state,
        grads) with ``grads`` a list of per-layer dicts shaped as
        ``params``. A parameter the loss does not reach gets zeros.
        ``rng``, the step's seed, turns on the random draws (dropout). A
        frozen layer's entry is ``{}``: no gradient is computed for it."""
        trainable = self._watch(params)
        loss, (new_state, _) = self.loss_fn(params, state, x, y, train=True, mask=mask, rng=rng)
        return loss.detach(), new_state, self._grads(loss, trainable)

    def _grads(self, loss, params):
        """Gradients of ``loss`` shaped as ``params`` (zeros where the loss
        does not reach), normalized or clipped as configured."""
        leaves = list(tree_leaves(params))
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_like(params, iter([torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, gs)]))
        return _gradnorm.normalize_grads(self.conf.gradient_normalization, grads,
                                         self.conf.gradient_normalization_threshold)

    def apply_update(self, params, opt_state, grads, step):
        """updater -> parameter add -> constraints, all in place, on the
        trainable layers only (``grads`` as ``compute_gradients`` gives
        them). Returns (params, opt_state)."""
        self._update(params, opt_state, grads, step)
        return self.apply_constraints(params, step), opt_state

    def _update(self, params, opt_state, grads, step):
        """The updater in place over the trainable layers: a frozen layer's
        parameters and updater state are not touched."""
        with torch.profiler.record_function("updater.step"):
            self.conf.updater.update_(self._trainable(params), self._trainable(grads),
                                      self._trainable(opt_state), step)

    def apply_constraints(self, params, step):
        return [l.apply_constraints(p, step, 0) if len(p) and i not in self.frozen_layers else p
                for i, (l, p) in enumerate(zip(self.conf.layers, params))]

    def make_train_step(self, with_health=False):
        """The train step: (params, state, opt_state, x, y, step, mask, rng)
        -> (params, state, opt_state, loss[, health]). ``step`` is the
        iteration or its row of the updater's scalar table on the device;
        ``with_health=True`` appends the watchdog's bundle of device
        scalars, computed inside the step from the gradients and the
        parameters before the update."""
        def train_step(params, state, opt_state, x, y, step, mask=None, rng=None):
            loss, new_state, grads = self.compute_gradients(params, state, x, y, mask=mask,
                                                            rng=rng)
            health = _health.health_stats(grads, params, loss) if with_health else None
            params, opt_state = self.apply_update(params, opt_state, grads, step)
            if with_health:
                return params, new_state, opt_state, loss, health
            return params, new_state, opt_state, loss
        return train_step

    def make_train_steps(self, k, with_health=False):
        """The K-step engine (``nn/fused.py``): one dispatch runs K train
        steps over a stacked ``[K, B, ...]`` super-batch, one CUDA-graph
        replay on a card; ``fit(steps_per_dispatch=K)`` drives it."""
        from deeplearning4j_tpu_torch.nn import fused as _fused
        return _fused.make_train_steps(self, k, with_health=with_health)

    # ------------------------------------------------------------------
    # truncated BPTT and streaming inference (reference: doTruncatedBPTT,
    # MultiLayerNetwork.java:1252-1254, and RecurrentLayer.rnnTimeStep)
    # ------------------------------------------------------------------

    def _zero_carries(self, batch, dtype, device):
        """A zero carry for each recurrent layer (None for the others), in
        f32 (f64 for f64 inputs)."""
        sd = torch.promote_types(dtype, torch.float32)
        return [l.zero_carry(batch, sd, device) if hasattr(l, "zero_carry") else None
                for l in self.conf.layers]

    def _apply_rnn(self, params, state, x, carries, *, train=False, mask=None, rng=None):
        """Forward pass threading the recurrent layers' carries. Returns
        (y, new_state, new_carries). As in the JAX package, a layer that
        draws (``DropoutLayer``) gets its seed; input dropout is off here."""
        new_state = list(state)
        new_carries = list(carries)
        cur_type = self.conf.input_type
        seeds = split_seed(rng, len(self.conf.layers)) if rng is not None else None
        for i, layer in enumerate(self.conf.layers):
            fam = layer.input_family
            if fam is not None and not isinstance(cur_type, fam):
                x = _inputs.adapt(x, cur_type, fam)
                cur_type = _inputs.adapted_type(cur_type, fam)
            if hasattr(layer, "apply_with_carry"):
                x, new_carries[i] = layer.apply_with_carry(params[i], carries[i], x, mask=mask)
            else:
                kwargs = {"mask": mask} if (self._mask_aware[i] and mask is not None) else {}
                if seeds is not None and _base.takes(type(layer), "rng"):
                    kwargs["rng"] = seeds[i]
                x, new_state[i] = layer.apply(params[i], state[i], x,
                                              train=self._layer_train(i, train), **kwargs)
            cur_type = layer.output_type(cur_type)
        return x, new_state, new_carries

    def make_tbptt_step(self):
        """One TBPTT chunk: (params, state, opt_state, carries, x, y, step,
        mask, rng) -> (params, state, opt_state, carries, loss). The carries come
        in detached (the truncation), the chunk's loss takes the feature
        mask as its label mask, and the updater runs without the constraint
        pass, as in the JAX package's TBPTT step."""
        conf = self.conf

        def tbptt_step(params, state, opt_state, carries, x, y, step, mask=None, rng=None):
            carries = [None if c is None else _detach(c) for c in carries]
            trainable = self._watch(params)
            with torch.enable_grad():
                preds, new_state, new_carries = self._apply_rnn(params, state, x, carries,
                                                                train=True, mask=mask, rng=rng)
                loss = conf.layers[-1].compute_loss(preds, y, mask)
                for layer, p in zip(conf.layers, params):
                    if len(p):
                        loss = loss + layer.regularization_penalty(p)
                loss, new_state = _base.pop_aux_losses(loss, new_state)
            self._update(params, opt_state, self._grads(loss, trainable), step)
            new_carries = [None if c is None else _detach(c) for c in new_carries]
            return params, new_state, opt_state, new_carries, loss.detach()

        return tbptt_step

    def _fit_tbptt(self, x, y, mask):
        """One batch in chunks of ``tbptt_fwd_length`` steps, carries from
        zeros; ``iteration`` advances once a chunk. Returns the mean of the
        chunks' losses (a device scalar)."""
        step_fn = self.make_tbptt_step()
        length = self.conf.tbptt_fwd_length
        carries = self._zero_carries(x.shape[0], x.dtype, x.device)
        total, n_chunks = 0.0, 0
        for t0 in range(0, x.shape[1], length):
            cm = None if mask is None else mask[:, t0:t0 + length]
            _, self.state, self.opt_state, carries, loss = step_fn(
                self.params, self.state, self.opt_state, carries, x[:, t0:t0 + length],
                y[:, t0:t0 + length], self.iteration, cm, step_seed(self.conf.seed, self.iteration))
            total = total + loss  # summed on the device: no sync per chunk
            n_chunks += 1
            self.iteration += 1
        return total / max(n_chunks, 1)

    def _tbptt_applies(self, x, y):
        """The JAX package's gate: a 3-d batch longer than the window."""
        return (self.conf.backprop_type == "tbptt" and x.dim() == 3 and y.dim() == 3
                and x.shape[1] > self.conf.tbptt_fwd_length)

    def rnn_clear_previous_state(self):
        self._rnn_stream_state = None

    def rnn_time_step(self, x):
        """One timestep [B, F] (or a short [B, T, F] chunk) of streaming
        inference, carrying the recurrent state between calls."""
        if self.params is None:
            self.init()
        x = _as_tensor(x, self.device)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        carries = self._rnn_stream_state
        if carries is None:
            carries = self._zero_carries(x.shape[0], x.dtype, x.device)
        with _dtypes.policy_precision(), torch.inference_mode():
            y, _, carries = self._apply_rnn(self.params, self.state, x, carries)
        self._rnn_stream_state = carries
        return y[:, 0] if squeeze else y

    # ------------------------------------------------------------------
    # convenience (stateful) API
    # ------------------------------------------------------------------

    def fit(self, data, labels=None, *, epochs=1, batch_size=None, mask=None,
            steps_per_dispatch=1, pad_ragged=None):
        """Train. ``data`` is an (x, y) pair, feature arrays with ``labels``,
        or an iterable of minibatches (see ``datasets.iter_batches``);
        arrays may be numpy or tensors, and move to the network's device.
        Each step's loss lands in ``score_history`` one dispatch late, where
        the listeners hear it; ``score_value`` is the last. Returns the
        network.

        ``steps_per_dispatch=K`` runs K steps a dispatch through the K-step
        engine (``nn/fused.py``; one CUDA-graph replay on a card): batches
        are bucketed to one shape with validity masks (exact under the
        masked-mean losses), stacked K at a time and copied to the device
        on a prefetch thread while the current dispatch runs; a ragged
        K-tail pads with no-op steps. ``pad_ragged=True`` pads every batch
        of the K=1 loop to the first one's size the same way. Truncated
        BPTT is refused at K > 1 where it would engage (3-d features and
        labels longer than the window)."""
        from deeplearning4j_tpu_torch.continuous.driver import StepDriver

        if self.params is None:
            self.init()
        k = int(steps_per_dispatch)
        self.score_history = []
        if k > 1:
            if self.conf.backprop_type == "tbptt":
                pair = labels is None and isinstance(data, (tuple, list))
                feats = data[0] if pair else data
                labs = data[1] if pair else labels
                safe = (hasattr(feats, "shape") and
                        (feats.ndim != 3 or feats.shape[1] <= self.conf.tbptt_fwd_length
                         or (hasattr(labs, "shape") and labs.ndim != 3)))
                if not safe:
                    raise ValueError("steps_per_dispatch > 1 does not compose with TBPTT (the "
                                     "chunk loop is its own loop); use the default "
                                     "single-step path")
            from deeplearning4j_tpu_torch.nn import fused as _fused
            with _dtypes.policy_precision():
                return _fused.fit_fused(
                    self, lambda: iter_batches(data, labels, batch_size, mask),
                    epochs=epochs, k=k, batch_size=batch_size)
        drv = StepDriver(
            self, lambda: iter_batches(data, labels, batch_size, mask,
                                       pad_to=True if pad_ragged else None),
            tbptt_fn=self._tbptt_applies)
        with _dtypes.policy_precision():
            return drv.run(epochs)

    def score(self, x, y, mask=None):
        """The loss on (x, y) without training (inference forward)."""
        if self.params is None:
            self.init()
        dev = self.device
        with _dtypes.policy_precision():
            loss, _ = self.loss_fn(self.params, self.state, _as_tensor(x, dev),
                                   _as_tensor(y, dev), train=False, mask=_as_tensor(mask, dev))
        return float(loss)

    def forward(self, x, mask=None):
        return self.apply_fn(self.params, self.state, x, mask=mask)[0]

    def output(self, x, mask=None):
        """Inference on host or device input; returns a tensor on the
        network's device."""
        if self.params is None:
            self.init()
        dev = self.device
        with _dtypes.policy_precision():
            return self.forward(_as_tensor(x, dev), mask=_as_tensor(mask, dev))

    def predict(self, x, mask=None):
        """Predicted class indices [batch] (reference:
        MultiLayerNetwork.predict): the argmax of ``output``, on the host."""
        return self.output(x, mask=mask).argmax(-1).cpu().numpy()

    def f1_score(self, x, y, mask=None):
        """Macro F1 over a labelled batch (reference: Classifier.f1Score); a
        mask excludes padded examples or steps."""
        from deeplearning4j_tpu_torch.eval.classification import Evaluation

        e = Evaluation()
        e.eval(y, self.output(x, mask=mask), mask=mask)
        return e.f1()

    def _eval_batches(self, data, labels, batch_size):
        """(x, y, mask, output) for each batch of the evaluate family."""
        for bx, by, bm in iter_batches(data, labels, batch_size, None):
            yield bx, by, bm, self.output(bx, mask=bm)

    def evaluate(self, data, labels=None, *, batch_size=None, evaluation=None):
        """Classification ``Evaluation`` over arrays, an (x, y) pair or a
        DataSetIterator (reference: MultiLayerNetwork.evaluate). Pass
        ``evaluation=`` to accumulate into an existing instance (a top-N or
        cost-array one)."""
        from deeplearning4j_tpu_torch.eval.classification import Evaluation

        e = evaluation if evaluation is not None else Evaluation()
        for _, by, bm, out in self._eval_batches(data, labels, batch_size):
            e.eval(by, out, mask=bm)
        return e

    def evaluate_regression(self, data, labels=None, *, batch_size=None):
        """``RegressionEvaluation`` over the same inputs (reference:
        MultiLayerNetwork.evaluateRegression)."""
        from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation

        e = RegressionEvaluation()
        for _, by, bm, out in self._eval_batches(data, labels, batch_size):
            e.eval(by, out, mask=bm)
        return e

    def evaluate_roc(self, data, labels=None, *, batch_size=None, threshold_steps=0):
        """``ROC`` (at most 2 outputs) or ``ROCMultiClass`` over the same
        inputs (reference: evaluateROC / evaluateROCMultiClass)."""
        from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass

        roc = None
        for _, by, bm, out in self._eval_batches(data, labels, batch_size):
            if roc is None:
                roc = ROC(threshold_steps) if out.shape[-1] <= 2 else ROCMultiClass(threshold_steps)
            roc.eval(by, out, mask=bm)
        if roc is None:
            raise ValueError("no data to evaluate")
        return roc

    def add_listener(self, *ls):
        self.listeners.extend(ls)
        return self

    def num_params(self):
        return sum(int(p.numel()) for p in self.parameters())
