"""Weight-only int8 quantization for inference: the port of
``deeplearning4j_tpu/utils/quantization.py``.

Symmetric per-output-channel scales (absmax / 127, floored at
1e-12 / 127) on the matmul-family weight leaves (the last axis is the
output channel; stacked 3-D ``expert_*`` weights [E, I, O] get a scale per
expert and channel); biases, norms and the rest stay as they are.
Rounding is half to even in both packages (``torch.round``, ``jnp.round``).

The saving holds at rest: the quantized tree is int8 plus f32 scales. The
JAX package dequantizes inside its jitted forward, where XLA fuses the
int8 load into the matmul; here each ``QuantizedInference.output`` call
materializes the compute-dtype weights first and frees them after, so a
call's peak holds a float copy of the weights beside the int8 one.

    qi = QuantizedInference(net)        # quantizes a trained net
    y = qi.output(x)
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.utils import dtypes as _dtypes

# matmul-family parameter names whose leaves quantize (per-layer dicts may
# nest, e.g. a TransformerBlock's mha dict)
WEIGHT_KEYS = frozenset({"W", "Wx", "Wh", "Wqkv", "Wo",
                         "expert_W1", "expert_W2",
                         "mlp_W1", "mlp_W2", "router_W"})


def _is_weight(name, leaf, keys):
    return name in keys and torch.is_tensor(leaf) and leaf.dim() >= 2


def weight_keys_for(net):
    """The quantizable weight names of a network: the module's defaults
    and every layer's own ``WEIGHT_KEYS``."""
    keys = set(WEIGHT_KEYS)
    layers = getattr(net.conf, "layers", None)
    if layers is None:  # ComputationGraph
        layers = [getattr(getattr(v, "vertex", None), "layer", None) for v in net.conf.vertices]
    for layer in layers:
        keys.update(getattr(layer, "WEIGHT_KEYS", ()) or ())
    return frozenset(keys)


def _map_with_name(fn, tree, name=None):
    """``fn(name, leaf)`` over a tree of lists and dicts, ``name`` the
    leaf's own key; plain lists and dicts out."""
    if isinstance(tree, (list, tuple)):
        return [_map_with_name(fn, v, name) for v in tree]
    if hasattr(tree, "items"):
        return {k: _map_with_name(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def _zip_map(fn, a, b):
    if isinstance(a, (list, tuple)):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    if hasattr(a, "items"):
        return {k: _zip_map(fn, a[k], b[k]) for k in a.keys()}
    return fn(a, b)


def _quantize(name, w):
    w = w.detach().to(torch.float32)
    if w.dim() == 3 and name.startswith("expert_"):
        dims = (1,)                      # [E, I, O] -> scale [E, 1, O]
    else:
        dims = tuple(range(w.dim() - 1))  # everything but the output channel
    absmax = torch.amax(w.abs(), dim=dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(params, keys=WEIGHT_KEYS):
    """(qparams, scales) shaped as ``params``: each weight leaf as int8
    with its f32 per-channel scale; any other leaf as it is, with None."""
    pairs = _map_with_name(lambda n, leaf: _quantize(n, leaf) if _is_weight(n, leaf, keys)
                           else (leaf.detach() if torch.is_tensor(leaf) else leaf, None), params)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(tree, i):
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def dequantize_params(qparams, scales, dtype=None):
    """The parameter tree in ``dtype`` (default the policy's compute
    dtype) for each quantized leaf; the other leaves as they are."""
    dtype = dtype or _dtypes.get_policy().compute_dtype
    return _zip_map(lambda q, s: q if s is None else (q.to(torch.float32) * s).to(dtype),
                    qparams, scales)


def weight_bytes(params, keys=WEIGHT_KEYS):
    """Total bytes of the quantizable weight leaves."""
    total = [0]

    def add(name, leaf):
        if _is_weight(name, leaf, keys):
            total[0] += leaf.numel() * leaf.element_size()
        return leaf

    _map_with_name(add, params)
    return total[0]


class QuantizedInference:
    """Serve a trained MultiLayerNetwork or ComputationGraph from int8
    weights: the stored tree is int8 plus scales on the network's device,
    dequantized into the compute dtype at each ``output`` call. A graph
    takes a dict of inputs (or one array for its first input) and answers
    its single output's tensor, or the dict of them."""

    def __init__(self, net, dtype=None):
        if net.params is None:
            raise ValueError("quantize a trained or initialized network")
        self.net = net
        self.dtype = dtype
        self.qparams, self.scales = quantize_params(net.params, weight_keys_for(net))

    def _fwd(self, x, mask):
        p = dequantize_params(self.qparams, self.scales, self.dtype)
        return self.net.apply_fn(p, self.net.state, x, train=False, mask=mask)[0]

    def output(self, x, mask=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        dev = self.net.device
        put = lambda a: None if a is None else (a if torch.is_tensor(a)
                                                else torch.as_tensor(a)).to(dev)
        with _dtypes.policy_precision():
            if isinstance(self.net, ComputationGraph):
                if not isinstance(x, dict):
                    x = {self.net.conf.inputs[0]: x}
                outs = self._fwd({k: put(v) for k, v in x.items()}, put(mask))
                if len(self.net.conf.outputs) == 1:
                    return outs[self.net.conf.outputs[0]]
                return outs
            return self._fwd(put(x), put(mask))
