"""The zoo registry and pretrained-weight loading (reference: ZooModel.java;
the JAX package's ``deeplearning4j_tpu/models/zoo.py``).

``get_model(name)`` returns a ``ZooModel``: ``build(device=...)`` makes a
freshly initialised network from the registered builder,
``init_pretrained`` restores the pretrained checkpoint from the local data
directory after its md5 check (``datasets/cacheable.py``; the port never
downloads). The registry holds the JAX package's names, all of them.
``restore_checkpoint`` restores any supported model file by its format, as
the JAX package's does (the reference's ModelGuesser role): a DL4J
ModelSerializer zip through ``modelimport/dl4j.py``, a Keras HDF5 file
through ``modelimport/keras.py``, the framework's own zip (format v1)
through ``utils/serialization.load_model``.
"""

from __future__ import annotations

import json
import os
import zipfile

from deeplearning4j_tpu_torch.datasets import cacheable as _cache
from deeplearning4j_tpu_torch.models import inception as _inc
from deeplearning4j_tpu_torch.models import misc as _misc
from deeplearning4j_tpu_torch.models import resnet as _resnet
from deeplearning4j_tpu_torch.models import vgg as _vgg
from deeplearning4j_tpu_torch.models.lenet import lenet as _lenet

class PretrainedType:
    """Reference: org.deeplearning4j.zoo.PretrainedType."""
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"


class ZooModel:
    """One registry entry: a configuration builder and its pretrained
    artifacts ({PretrainedType: (url, md5)})."""

    def __init__(self, name, builder, pretrained=None, graph=True):
        self.name = name
        self.builder = builder
        self.pretrained = pretrained or {}
        self.graph = graph

    def build(self, device="cuda", **kw):
        """A freshly initialised network on ``device``; ``kw`` go to the
        builder."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = self.builder(**kw)
        net = (ComputationGraph if self.graph else MultiLayerNetwork)(conf, device=device)
        net.init()
        return net

    def pretrained_available(self, pretrained_type=PretrainedType.IMAGENET):
        return pretrained_type in self.pretrained

    def init_pretrained(self, pretrained_type=PretrainedType.IMAGENET, device="cuda"):
        """The pretrained network from ``zoo/<name>_<type>.zip`` under the
        data directory, md5-checked, on ``device``."""
        if pretrained_type not in self.pretrained:
            raise ValueError(f"Model {self.name} has no pretrained weights for "
                             f"{pretrained_type!r} (available: {sorted(self.pretrained)})")
        url, md5 = self.pretrained[pretrained_type]
        path = _cache.ensure_file(os.path.join("zoo", f"{self.name}_{pretrained_type}.zip"),
                                  url=url, md5=md5)
        # DL4J graph configs carry no input shape (setInputTypes is not
        # serialized in the 0.9 format): the registry's own builder knows it
        return restore_checkpoint(path, input_type=self._default_input_type(), device=device)

    def _default_input_type(self):
        """The builder's input type at its defaults, or None for a builder
        that needs arguments (the char-RNN's vocabulary size)."""
        try:
            conf = self.builder()
        except TypeError:
            return None
        if self.graph:
            return conf.input_types[0] if conf.input_types else None
        return conf.input_type


def restore_checkpoint(path, input_type=None, device="cuda"):
    """Restore any supported model file onto ``device`` by its format (the
    reference's ModelGuesser role, util/ModelGuesser.java): a Keras HDF5
    file (signature ``\\x89HDF``) by its declared model class, Sequential
    to a MultiLayerNetwork and functional to a ComputationGraph; a zip
    holding ``configuration.json`` and ``coefficients.bin`` (the
    reference's ModelSerializer layout, what every zoo ``pretrainedUrl``
    serves) to a ComputationGraph when the config has ``"vertices"``, else
    to a MultiLayerNetwork, with ``input_type`` for configs that store no
    input shape; anything else through ``utils/serialization.load_model``."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89HDF"):
        from deeplearning4j_tpu_torch.modelimport.keras import (
            _layer_list, _model_config, _open, import_keras_model_and_weights,
            import_keras_sequential_model_and_weights)
        with _open(path) as archive:
            cls, _ = _layer_list(_model_config(archive))
        # dispatch on the declared model class (the reference's
        # KerasModelImport sniff): a fallback on the exception would mask
        # the real diagnostic of a failed Sequential import
        if cls == "Sequential":
            return import_keras_sequential_model_and_weights(path, device=device)
        return import_keras_model_and_weights(path, device=device)
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        cfg = (json.loads(zf.read("configuration.json").decode("utf-8"))
               if "configuration.json" in names else None)
    if cfg is not None and "coefficients.bin" in names:
        from deeplearning4j_tpu_torch.modelimport import dl4j
        if "vertices" in cfg:  # graph zips: what the zoo URLs serve
            return dl4j.restore_computation_graph(path, input_type=input_type, device=device)
        return dl4j.restore_multilayer_network(path, input_type=input_type, device=device)
    from deeplearning4j_tpu_torch.utils.serialization import load_model
    return load_model(path, device=device)


_REGISTRY = {}


def register_model(name, builder, pretrained=None, graph=True):
    _REGISTRY[name] = ZooModel(name, builder, pretrained=pretrained, graph=graph)
    return _REGISTRY[name]


def model_names():
    return sorted(_REGISTRY)


def get_model(name) -> ZooModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown zoo model {name!r}; known: {model_names()}") from None


def init_pretrained(name, pretrained_type=PretrainedType.IMAGENET, device="cuda"):
    return get_model(name).init_pretrained(pretrained_type, device=device)


# the JAX package's registry; entries ship without pretrained artifacts, as
# there
register_model("lenet", _lenet, graph=False)
register_model("simplecnn", _misc.simple_cnn, graph=False)
register_model("alexnet", _misc.alexnet, graph=False)
register_model("darknet19", _misc.darknet19, graph=False)
register_model("tinyyolo", _misc.tiny_yolo, graph=False)
register_model("textgenlstm", _misc.text_generation_lstm, graph=False)
register_model("vgg16", _vgg.vgg16, graph=False)
register_model("vgg19", _vgg.vgg19, graph=False)
register_model("resnet50", _resnet.resnet50)
register_model("googlenet", _inc.googlenet)
register_model("inceptionresnetv1", _inc.inception_resnet_v1)
register_model("facenetnn4small2", _inc.facenet_nn4_small2)
