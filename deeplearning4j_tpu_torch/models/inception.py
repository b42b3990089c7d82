"""Inception-family zoo models: GoogLeNet, Inception-ResNet v1 and FaceNet
NN4-small2, each the same configuration, vertex names included, as
``deeplearning4j_tpu/models/inception.py``, so both packages serialize it to
the same ``config.json``.

- ``googlenet`` (reference GoogLeNet.java): LRN stem, nine inception
  modules (1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | max pool -> 1x1, concatenated
  by a MergeVertex) with the filter tables of GoogLeNet.java:154-169, a
  global average pool and fc1 with input dropout 0.4; 8,048,152 parameters
  at 224x224x3 and 1000 classes.
- ``inception_resnet_v1`` (InceptionResNetV1.java): the stem, 5 A blocks
  at scale 0.17, reduction A, 10 B blocks at 0.10, reduction B, 5 C blocks
  at 0.20 (each block: branches -> merge -> linear 1x1 -> ScaleVertex ->
  add the input -> relu), then the FaceNet head (avgpool -> 128-d
  bottleneck -> L2NormalizeVertex -> CenterLossOutputLayer); 16,863,161
  parameters at 160x160x3, 1001 classes.
- ``facenet_nn4_small2`` (FaceNetNN4Small2.java): NN4-small2 inception
  modules and the same head.

Every conv here is an unfused ConvolutionLayer (+ BatchNormalization):
these models reach no hand-written kernel; their convolutions, pooling,
LRN and concatenations are library and PyTorch operations.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.graph import (ElementWiseVertex, GraphBuilder,
                                               GraphBuilderModule, L2NormalizeVertex,
                                               MergeVertex, ScaleVertex)


def _conv(g, name, inp, n_out, kernel, stride=(1, 1), padding="same", activation="relu",
          bn=False):
    g.add_layer(name, L.ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                         padding=padding,
                                         activation="identity" if bn else activation,
                                         weight_init="relu"), inp)
    if bn:
        g.add_layer(name + "-bn", L.BatchNormalization(activation=activation), name)
        return name + "-bn"
    return name


# GoogLeNet.java:154-169: {1x1}, {3x3 reduce, 3x3}, {5x5 reduce, 5x5}, {pool proj}
_GOOGLENET_TABLE = {
    "3a": ((64,), (96, 128), (16, 32), (32,)),
    "3b": ((128,), (128, 192), (32, 96), (64,)),
    "4a": ((192,), (96, 208), (16, 48), (64,)),
    "4b": ((160,), (112, 224), (24, 64), (64,)),
    "4c": ((128,), (128, 256), (24, 64), (64,)),
    "4d": ((112,), (144, 288), (32, 64), (64,)),
    "4e": ((256,), (160, 320), (32, 128), (128,)),
    "5a": ((256,), (160, 320), (32, 128), (128,)),
    "5b": ((384,), (192, 384), (48, 128), (128,)),
}


def _inception(g, name, inp, cfg):
    """One GoogLeNet inception module (GoogLeNet.java:123-138)."""
    (f1,), (f3r, f3), (f5r, f5), (fp,) = cfg
    b1 = _conv(g, f"{name}-1x1", inp, f1, (1, 1))
    r3 = _conv(g, f"{name}-3x3r", inp, f3r, (1, 1))
    b3 = _conv(g, f"{name}-3x3", r3, f3, (3, 3))
    r5 = _conv(g, f"{name}-5x5r", inp, f5r, (1, 1))
    b5 = _conv(g, f"{name}-5x5", r5, f5, (5, 5))
    g.add_layer(f"{name}-pool", L.SubsamplingLayer(kernel=(3, 3), stride=(1, 1), padding="same",
                                                   mode="max"), inp)
    bp = _conv(g, f"{name}-poolproj", f"{name}-pool", fp, (1, 1))
    g.add_vertex(f"{name}-depthconcat", MergeVertex(), b1, b3, b5, bp)
    return f"{name}-depthconcat"


def _max_pool(g, name, inp):
    g.add_layer(name, L.SubsamplingLayer(kernel=(3, 3), stride=(2, 2), padding="same",
                                         mode="max"), inp)
    return name


def _lrn(g, name, inp):
    g.add_layer(name, L.LocalResponseNormalization(n=5, alpha=1e-4, beta=0.75), inp)
    return name


def googlenet(height=224, width=224, channels=3, n_classes=1000, updater=None, seed=12345):
    """GoogLeNet / Inception v1 (reference GoogLeNet.java)."""
    g = GraphBuilder(updater=updater or U.Adam(learning_rate=1e-3), seed=seed)
    g.add_inputs("input")
    g.set_input_types(I.ConvolutionalType(height, width, channels))
    x = _conv(g, "cnn1", "input", 64, (7, 7), stride=(2, 2))
    _lrn(g, "lrn1", _max_pool(g, "max1", x))
    x = _conv(g, "cnn2", "lrn1", 64, (1, 1))
    x = _conv(g, "cnn3", x, 192, (3, 3))
    x = _max_pool(g, "max2", _lrn(g, "lrn2", x))
    for name in ("3a", "3b"):
        x = _inception(g, name, x, _GOOGLENET_TABLE[name])
    x = _max_pool(g, "max3", x)
    for name in ("4a", "4b", "4c", "4d", "4e"):
        x = _inception(g, name, x, _GOOGLENET_TABLE[name])
    x = _max_pool(g, "max4", x)
    for name in ("5a", "5b"):
        x = _inception(g, name, x, _GOOGLENET_TABLE[name])
    g.add_layer("avgpool", L.GlobalPoolingLayer(mode="avg"), x)
    g.add_layer("fc1", L.DenseLayer(n_out=1024, activation="relu", dropout=0.4), "avgpool")
    g.add_layer("output", L.OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"),
                "fc1")
    g.set_outputs("output")
    return g.build()


def _res_block(g, name, inp, branches, n_channels, scale):
    """Inception-resnet block: branches -> merge -> linear 1x1 back to
    ``n_channels`` -> scale -> add the input -> relu
    (InceptionResNetHelper.inceptionV1ResA/B/C)."""
    outs = []
    for bi, branch in enumerate(branches):
        cur = inp
        for li, (f, k) in enumerate(branch):
            cur = _conv(g, f"{name}-b{bi}-{li}", cur, f, k, bn=True)
        outs.append(cur)
    g.add_vertex(f"{name}-merge", MergeVertex(), *outs)
    proj = _conv(g, f"{name}-proj", f"{name}-merge", n_channels, (1, 1), activation="identity")
    g.add_vertex(f"{name}-scale", ScaleVertex(factor=scale), proj)
    g.add_vertex(f"{name}-add", ElementWiseVertex(op="add"), inp, f"{name}-scale")
    g.add_layer(f"{name}", L.ActivationLayer(activation="relu"), f"{name}-add")
    return name


def _irv1_stem(g, channels_label="input"):
    """InceptionResNetV1.java:112-165."""
    x = _conv(g, "stem-cnn1", channels_label, 32, (3, 3), stride=(2, 2), bn=True)
    x = _conv(g, "stem-cnn2", x, 32, (3, 3), bn=True)
    x = _conv(g, "stem-cnn3", x, 64, (3, 3), bn=True)
    x = _max_pool(g, "stem-pool4", x)
    x = _conv(g, "stem-cnn5", x, 80, (1, 1), bn=True)
    x = _conv(g, "stem-cnn6", x, 128, (3, 3), bn=True)
    return _conv(g, "stem-cnn7", x, 192, (3, 3), stride=(2, 2), bn=True)


def _embedding_head(g, x, n_classes, embedding_size, lambda_=2e-4):
    """avgpool -> bottleneck -> L2 normalize -> center-loss softmax
    (FaceNetNN4Small2.java:82-91)."""
    g.add_layer("avgpool", L.GlobalPoolingLayer(mode="avg"), x)
    g.add_layer("bottleneck", L.DenseLayer(n_out=embedding_size, activation="identity"),
                "avgpool")
    g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
    g.add_layer("lossLayer", L.CenterLossOutputLayer(n_out=n_classes, lambda_=lambda_,
                                                     alpha=0.9), "embeddings")
    g.set_outputs("lossLayer")


def inception_resnet_v1(height=160, width=160, channels=3, n_classes=1001, embedding_size=128,
                        updater=None, seed=12345, blocks_a=5, blocks_b=10, blocks_c=5):
    """Inception-ResNet v1 with the FaceNet embedding and center-loss head
    (InceptionResNetV1.java; blocks and scales at :167-230)."""
    g = GraphBuilder(updater=updater or U.RmsProp(learning_rate=0.1), seed=seed)
    g.add_inputs("input")
    g.set_input_types(I.ConvolutionalType(height, width, channels))
    x = _irv1_stem(g)
    for i in range(blocks_a):  # 35x35 blocks
        x = _res_block(g, f"resnetA{i}", x,
                       [[(32, (1, 1))],
                        [(32, (1, 1)), (32, (3, 3))],
                        [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]], 192, 0.17)
    # reduction A (InceptionResNetV1.java:170-200)
    ra1 = _conv(g, "reduceA-cnn1", x, 192, (3, 3), stride=(2, 2), bn=True)
    ra2 = _conv(g, "reduceA-cnn2", x, 128, (1, 1), bn=True)
    ra2 = _conv(g, "reduceA-cnn3", ra2, 128, (3, 3), bn=True)
    ra2 = _conv(g, "reduceA-cnn4", ra2, 192, (3, 3), stride=(2, 2), bn=True)
    _max_pool(g, "reduceA-pool", x)
    g.add_vertex("reduceA", MergeVertex(), ra1, ra2, "reduceA-pool")
    x, n_ch = "reduceA", 192 + 192 + 192
    for i in range(blocks_b):  # 17x17 blocks
        x = _res_block(g, f"resnetB{i}", x,
                       [[(128, (1, 1))],
                        [(128, (1, 1)), (128, (1, 7)), (128, (7, 1))]], n_ch, 0.10)
    # reduction B
    rb1 = _conv(g, "reduceB-cnn1", x, 256, (1, 1), bn=True)
    rb1 = _conv(g, "reduceB-cnn2", rb1, 384, (3, 3), stride=(2, 2), bn=True)
    rb2 = _conv(g, "reduceB-cnn3", x, 256, (1, 1), bn=True)
    rb2 = _conv(g, "reduceB-cnn4", rb2, 256, (3, 3), stride=(2, 2), bn=True)
    rb3 = _conv(g, "reduceB-cnn5", x, 256, (1, 1), bn=True)
    rb3 = _conv(g, "reduceB-cnn6", rb3, 256, (3, 3), bn=True)
    rb3 = _conv(g, "reduceB-cnn7", rb3, 256, (3, 3), stride=(2, 2), bn=True)
    _max_pool(g, "reduceB-pool", x)
    g.add_vertex("reduceB", MergeVertex(), rb1, rb2, rb3, "reduceB-pool")
    x, n_ch = "reduceB", 384 + 256 + 256 + n_ch
    for i in range(blocks_c):  # 8x8 blocks
        x = _res_block(g, f"resnetC{i}", x,
                       [[(192, (1, 1))],
                        [(192, (1, 1)), (192, (1, 3)), (192, (3, 1))]], n_ch, 0.20)
    _embedding_head(g, x, n_classes, embedding_size)
    return g.build()


def _nn4_inception(g, name, inp, f3r, f3, f5r, f5, fp, f1=None, stride=(1, 1),
                   pool_mode="max"):
    """NN4 inception module (FaceNetNN4Small2.java:146-300): an optional
    1x1 branch, 1x1 -> 3x3, 1x1 -> 5x5, pool -> optional 1x1 projection."""
    outs = []
    if f1:
        outs.append(_conv(g, f"{name}-1x1", inp, f1, (1, 1), bn=True))
    if f3:
        r = _conv(g, f"{name}-3x3r", inp, f3r, (1, 1), bn=True)
        outs.append(_conv(g, f"{name}-3x3", r, f3, (3, 3), stride=stride, bn=True))
    if f5:
        r = _conv(g, f"{name}-5x5r", inp, f5r, (1, 1), bn=True)
        outs.append(_conv(g, f"{name}-5x5", r, f5, (5, 5), stride=stride, bn=True))
    g.add_layer(f"{name}-pool", L.SubsamplingLayer(kernel=(3, 3),
                                                   stride=stride if fp is None else (1, 1),
                                                   padding="same", mode=pool_mode), inp)
    if fp:
        outs.append(_conv(g, f"{name}-poolproj", f"{name}-pool", fp, (1, 1), bn=True))
    else:
        outs.append(f"{name}-pool")
    g.add_vertex(f"{name}", MergeVertex(), *outs)
    return name


def facenet_nn4_small2(height=96, width=96, channels=3, n_classes=5749, embedding_size=128,
                       updater=None, seed=12345):
    """FaceNet NN4-small2 (FaceNetNN4Small2.java: an inception net for
    96x96 faces with the embedding and center-loss head)."""
    g = GraphBuilder(updater=updater or U.Adam(learning_rate=1e-3), seed=seed)
    g.add_inputs("input")
    g.set_input_types(I.ConvolutionalType(height, width, channels))
    x = _conv(g, "stem-cnn1", "input", 64, (7, 7), stride=(2, 2), bn=True)
    _lrn(g, "stem-lrn1", _max_pool(g, "stem-pool1", x))
    x = _conv(g, "inception-2-cnn1", "stem-lrn1", 64, (1, 1), bn=True)
    x = _conv(g, "inception-2-cnn2", x, 192, (3, 3), bn=True)
    x = _max_pool(g, "inception-2-pool1", _lrn(g, "inception-2-lrn1", x))
    # the NN4-small2 table (FaceNetNN4Small2.java, blocks 3a..5b)
    x = _nn4_inception(g, "inception-3a", x, 96, 128, 16, 32, 32, f1=64)
    x = _nn4_inception(g, "inception-3b", x, 96, 128, 32, 64, 64, f1=64)
    x = _nn4_inception(g, "inception-3c", x, 128, 256, 32, 64, None, stride=(2, 2))
    x = _nn4_inception(g, "inception-4a", x, 96, 192, 32, 64, 128, f1=256)
    x = _nn4_inception(g, "inception-4e", x, 160, 256, 64, 128, None, stride=(2, 2))
    x = _nn4_inception(g, "inception-5a", x, 96, 384, 0, None, 96, f1=256, pool_mode="avg")
    x = _nn4_inception(g, "inception-5b", x, 96, 384, 0, None, 96, f1=256)
    _embedding_head(g, x, n_classes, embedding_size)
    return g.build()


class InceptionModule(GraphBuilderModule):
    """The GoogLeNet inception block as a ``GraphBuilderModule``: ``config``
    is its filter table ((f1,), (f3r, f3), (f5r, f5), (fp,)), as in
    GoogLeNet.java:154-169; ``input_size`` is taken for the interface's
    sake (the convs infer their input channels)."""

    def module_name(self):
        return "inception"

    def update_builder(self, builder, layer_name, input_size, config, input_layer):
        _inception(builder, f"{self.module_name()}-{layer_name}", input_layer, config)
        return builder
