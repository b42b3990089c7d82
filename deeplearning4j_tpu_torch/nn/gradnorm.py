"""Gradient normalization and clipping.

The modes of ``deeplearning4j_tpu/nn/gradnorm.py`` (DL4J's
GradientNormalization): "layer" is one layer's parameter tree, "param type"
one named array. Gradients are trees of tensors (dicts, nested for layers
like TransformerBlock); the functions return new trees.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like


def _map(fn, tree):
    return tree_like(tree, (fn(g) for g in tree_leaves(tree)))


def _tree_l2(tree):
    return torch.sqrt(sum((g * g).sum() for g in tree_leaves(tree)) + 1e-32)


def normalize_layer_grads(mode, layer_grads, threshold=1.0):
    """Apply normalization to one layer's gradient tree."""
    if mode in (None, "none"):
        return layer_grads
    if mode == "renormalize_l2_per_layer":
        norm = _tree_l2(layer_grads)
        return _map(lambda g: g / norm, layer_grads)
    if mode == "renormalize_l2_per_param_type":
        return {k: v / torch.sqrt((v * v).sum() + 1e-32) for k, v in layer_grads.items()}
    if mode == "clip_elementwise_absolute_value":
        return _map(lambda g: g.clamp(-threshold, threshold), layer_grads)
    if mode == "clip_l2_per_layer":
        scale = (threshold / _tree_l2(layer_grads)).clamp_max(1.0)
        return _map(lambda g: g * scale, layer_grads)
    if mode == "clip_l2_per_param_type":
        return {k: v * (threshold / torch.sqrt((v * v).sum() + 1e-32)).clamp_max(1.0)
                for k, v in layer_grads.items()}
    raise ValueError(f"Unknown gradient normalization mode {mode!r}")


def normalize_grads(mode, grads, threshold=1.0):
    """Apply per-layer normalization across a list of per-layer trees."""
    if mode in (None, "none"):
        return grads
    return [normalize_layer_grads(mode, g, threshold) if g else g for g in grads]
