"""VGG16 and VGG19 (reference: VGG16.java, VGG19.java): sequential 3x3 conv
stacks, the same configurations as ``deeplearning4j_tpu/models/vgg.py``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig

_VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG19_BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


def _vgg(blocks, height, width, channels, n_classes, updater, seed):
    layers = []
    for n_out, reps in blocks:
        layers += [L.ConvolutionLayer(n_out=n_out, kernel=(3, 3), padding="same",
                                      activation="relu", weight_init="relu")
                   for _ in range(reps)]
        layers.append(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2), mode="max"))
    layers += [
        L.DenseLayer(n_out=4096, activation="relu", weight_init="relu", dropout=0.5),
        L.DenseLayer(n_out=4096, activation="relu", weight_init="relu", dropout=0.5),
        L.OutputLayer(n_out=n_classes, loss="mcxent", weight_init="xavier"),
    ]
    return NeuralNetConfig(seed=seed, updater=updater or U.Nesterovs(learning_rate=0.01)).list(
        *layers, input_type=I.ConvolutionalType(height, width, channels))


def vgg16(height=224, width=224, channels=3, n_classes=1000, updater=None, seed=12345):
    return _vgg(_VGG16_BLOCKS, height, width, channels, n_classes, updater, seed)


def vgg19(height=224, width=224, channels=3, n_classes=1000, updater=None, seed=12345):
    return _vgg(_VGG19_BLOCKS, height, width, channels, n_classes, updater, seed)
