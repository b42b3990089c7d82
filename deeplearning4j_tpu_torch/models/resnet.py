"""ResNet50 as a ComputationGraph, and as a MultiLayerNetwork of
ResidualBottleneck layers (``resnet50_mln``): the same configurations,
vertex names included, as ``deeplearning4j_tpu/models/resnet.py``, so both
packages serialize them to the same ``config.json``.

NHWC, stride-2 downsampling on the first 1x1 conv of a stage and its
projection shortcut, BatchNormalization with running statistics in state.
``fused=True`` builds every conv -> BN (-> add -> relu) chain of the
bottlenecks as one ``FusedConvBNVertex`` (``nn/fusion.py``), whose train
mode runs the conv-with-statistics kernels (``ops/conv_stats.py``).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.fusion import FusedConvBNVertex
from deeplearning4j_tpu_torch.nn.graph import ElementWiseVertex, GraphBuilder


def _conv_bn(g, name, inp, n_out, kernel, stride=(1, 1), padding="same", activation="relu",
             fused=False):
    if fused:
        g.add_vertex(f"{name}_bn", FusedConvBNVertex(n_out=n_out, kernel=kernel, stride=stride,
                                                     padding=padding, activation=activation),
                     inp)
        return f"{name}_bn"
    g.add_layer(f"{name}_conv", L.ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                                   padding=padding, has_bias=False,
                                                   weight_init="relu"), inp)
    g.add_layer(f"{name}_bn", L.BatchNormalization(activation=activation), f"{name}_conv")
    return f"{name}_bn"


def _bottleneck(g, name, inp, filters, stride=(1, 1), project=False, fused=False):
    """1x1 reduce -> 3x3 -> 1x1 expand (4x) with the shortcut added."""
    f1, f2, f3 = filters, filters, filters * 4
    x = _conv_bn(g, f"{name}_a", inp, f1, (1, 1), stride=stride, fused=fused)
    x = _conv_bn(g, f"{name}_b", x, f2, (3, 3), fused=fused)
    if not fused:
        x = _conv_bn(g, f"{name}_c", x, f3, (1, 1), activation="identity")
    shortcut = inp
    if project:
        shortcut = _conv_bn(g, f"{name}_proj", inp, f3, (1, 1), stride=stride,
                            activation="identity", fused=fused)
    if fused:
        # the tail conv_c -> BN -> add -> relu is one vertex with the
        # shortcut as its residual input
        g.add_vertex(f"{name}_relu", FusedConvBNVertex(n_out=f3, kernel=(1, 1),
                                                       activation="relu", residual=True),
                     x, shortcut)
        return f"{name}_relu"
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    g.add_layer(f"{name}_relu", L.ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_relu"


def resnet50(height=224, width=224, channels=3, n_classes=1000, updater=None, seed=12345,
             checkpoint_scope=None, fused=False):
    """ResNet50 (reference: ResNet50.java, BASELINE.md config #2):
    25,557,032 parameters at 224x224x3 and 1000 classes.
    ``checkpoint_scope="prefix"`` recomputes each bottleneck block (and the
    stem) in the backward, keeping only the blocks' boundary activations."""
    g = GraphBuilder(updater=updater or U.Adam(learning_rate=1e-3), seed=seed,
                     checkpoint_scope=checkpoint_scope)
    g.add_inputs("input")
    g.set_input_types(I.ConvolutionalType(height, width, channels))
    x = _conv_bn(g, "stem", "input", 64, (7, 7), stride=(2, 2))
    g.add_layer("stem_pool", L.SubsamplingLayer(kernel=(3, 3), stride=(2, 2), padding="same",
                                                mode="max"), x)
    x = "stem_pool"
    stages = [(64, 3, (1, 1)), (128, 4, (2, 2)), (256, 6, (2, 2)), (512, 3, (2, 2))]
    for si, (filters, blocks, stride) in enumerate(stages):
        for bi in range(blocks):
            x = _bottleneck(g, f"s{si}b{bi}", x, filters, stride=stride if bi == 0 else (1, 1),
                            project=bi == 0, fused=fused)
    g.add_layer("avgpool", L.GlobalPoolingLayer(mode="avg"), x)
    g.add_layer("fc", L.OutputLayer(n_out=n_classes, loss="mcxent", weight_init="xavier"),
                "avgpool")
    g.set_outputs("fc")
    return g.build()


def resnet50_mln(height=224, width=224, channels=3, n_classes=1000, updater=None, seed=12345,
                 stages=None, stem_filters=64):
    """ResNet50 as a flat MultiLayerNetwork of ResidualBottleneck layers, the
    geometry of ``resnet50`` with the shortcuts inside the blocks.
    ``stages`` overrides the (filters, blocks, stride) table for cut-down
    variants."""
    stages = stages if stages is not None else [
        (64, 3, (1, 1)), (128, 4, (2, 2)), (256, 6, (2, 2)), (512, 3, (2, 2))]
    layers = [
        L.ConvolutionLayer(n_out=stem_filters, kernel=(7, 7), stride=(2, 2), padding="same",
                           has_bias=False, weight_init="relu"),
        L.BatchNormalization(activation="relu"),
        L.SubsamplingLayer(kernel=(3, 3), stride=(2, 2), padding="same", mode="max"),
    ]
    for filters, blocks, stride in stages:
        layers += [L.ResidualBottleneck(filters=filters, stride=stride if bi == 0 else (1, 1),
                                        project=bi == 0) for bi in range(blocks)]
    layers += [L.GlobalPoolingLayer(mode="avg"),
               L.OutputLayer(n_out=n_classes, loss="mcxent", weight_init="xavier")]
    return NeuralNetConfig(seed=seed, updater=updater or U.Adam(learning_rate=1e-3)).list(
        *layers, input_type=I.ConvolutionalType(height, width, channels))


def resnet50_flops_per_example(height=224, width=224, channels=3, n_classes=1000):
    """Approximate forward FLOPs (2 x MACs) of one example, for MFU
    accounting: 2 x the standard ~4.1 GMAC at 224x224, scaled by the image
    area. A training step is ~3 x the forward (the goodput ledger's
    ``set_flops_per_step(3 * resnet50_flops_per_example() * batch)``)."""
    base = 2 * 4.1e9
    return base * ((height * width) / (224 * 224))
