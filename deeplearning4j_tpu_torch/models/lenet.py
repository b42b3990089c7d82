"""LeNet (reference: LeNet.java, BASELINE.md config #1): conv 5x5x20 ->
max pool -> conv 5x5x50 -> max pool -> dense 500 -> softmax, the same
configuration as ``deeplearning4j_tpu/models/lenet.py``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig


def lenet(height=28, width=28, channels=1, n_classes=10, updater=None, seed=12345,
          padding="valid"):
    """Valid padding (DL4J's default) gives the 431,080-parameter Caffe
    variant at 28x28; ``padding="same"`` suits inputs under 14 pixels."""
    return NeuralNetConfig(seed=seed, updater=updater or U.Adam(learning_rate=1e-3)).list(
        L.ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1), padding=padding,
                           activation="relu", weight_init="xavier"),
        L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2), mode="max"),
        L.ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1), padding=padding,
                           activation="relu", weight_init="xavier"),
        L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2), mode="max"),
        L.DenseLayer(n_out=500, activation="relu", weight_init="xavier"),
        L.OutputLayer(n_out=n_classes, loss="mcxent", weight_init="xavier"),
        input_type=I.ConvolutionalType(height, width, channels),
    )
