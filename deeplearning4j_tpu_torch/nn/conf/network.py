"""Network configuration DSL.

``NeuralNetConfig`` carries the global defaults that cascade
into per-layer configs (a layer field left at its class default takes the
global value); ``MultiLayerConfiguration`` is the immutable result, with
the JAX package's JSON form.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn import updaters as _updaters
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.utils import serde

# fields that cascade from global defaults into layers when left unset
_CASCADE_FIELDS = ("activation", "weight_init", "bias_init", "l1", "l2",
                   "l1_bias", "l2_bias", "dropout", "constraints")


@serde.register_config
@dataclasses.dataclass(frozen=True)
class MultiLayerConfiguration:
    """Immutable, JSON-round-trippable sequential-network config."""

    layers: tuple = ()
    input_type: InputType | None = None
    updater: object = dataclasses.field(default_factory=_updaters.Sgd)
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    backprop_type: str = "standard"  # standard | tbptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    seed: int = 12345
    mini_batch: bool = True
    gradient_checkpointing: bool = False

    def to_json(self, indent=2):
        return serde.to_json(self, indent=indent)

    @staticmethod
    def from_json(s):
        conf = serde.from_json(s)
        if not isinstance(conf, MultiLayerConfiguration):
            raise TypeError(f"expected a MultiLayerConfiguration JSON, got "
                            f"{type(conf).__name__}")
        return conf

    def layer_input_types(self):
        """Shape inference along the stack: the input type each layer sees
        (after implicit family adaptation) and the network's output type."""
        types = []
        cur = self.input_type
        if cur is None:
            raise ValueError("MultiLayerConfiguration requires input_type for shape inference")
        for layer in self.layers:
            fam = layer.input_family
            if fam is not None and not isinstance(cur, fam):
                cur = _inputs.adapted_type(cur, fam)
            types.append(cur)
            cur = layer.output_type(cur)
        return types, cur


@dataclasses.dataclass
class NeuralNetConfig:
    """Global defaults that cascade into the layer configs of ``list``."""

    seed: int = 12345
    activation: object = None
    weight_init: object = None
    bias_init: float = None
    l1: float = None
    l2: float = None
    dropout: float = None
    updater: object = dataclasses.field(default_factory=_updaters.Sgd)
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0

    def list(self, *layers, input_type=None, backprop_type="standard",
             tbptt_fwd_length=20, tbptt_back_length=20,
             gradient_checkpointing=False) -> MultiLayerConfiguration:
        cascaded = tuple(self._cascade(l) for l in layers)
        return MultiLayerConfiguration(
            layers=cascaded, input_type=input_type,
            updater=self.updater if not isinstance(self.updater, str) else _updaters.get(self.updater),
            gradient_normalization=self.gradient_normalization,
            gradient_normalization_threshold=self.gradient_normalization_threshold,
            backprop_type=backprop_type, tbptt_fwd_length=tbptt_fwd_length,
            tbptt_back_length=tbptt_back_length, seed=self.seed,
            gradient_checkpointing=gradient_checkpointing,
        )

    def _cascade(self, layer):
        updates = {}
        fields = {f.name: f for f in dataclasses.fields(layer)}
        for name in _CASCADE_FIELDS:
            global_val = getattr(self, name, None)
            if global_val is None or name not in fields:
                continue
            f = fields[name]
            default = f.default if f.default is not dataclasses.MISSING else None
            if getattr(layer, name) == default:
                updates[name] = global_val
        return dataclasses.replace(layer, **updates) if updates else layer
