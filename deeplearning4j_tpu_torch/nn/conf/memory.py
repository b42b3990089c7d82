"""Memory estimation reports: the port of
``deeplearning4j_tpu/nn/conf/memory.py`` (reference: LayerMemoryReport.java
and NetworkMemoryReport.java).

Per layer: parameter count and bytes, updater-state bytes and the output
activation's bytes per example; per network, the estimated peak of one
training or inference step at a batch size. Shapes come from each layer's
``init`` and the updater's ``init`` run on ``torch.device("meta")``:
nothing is allocated, as the JAX package's ``jax.eval_shape``. The
updater's state is counted as the port holds it (the same tensors as the
JAX package's for every ported updater: a per-parameter moment or two,
no step counter), and the estimate counts what the JAX package counts:
parameters, their gradients, the updater state and every layer's output
activation (training) or the largest neighbouring pair (inference). It
does not count an allocator's caching or a kernel's workspace.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.utils.trees import tree_leaves


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is meta: the initializers make
    their tensors on the generator's device, so ``init`` allocates
    nothing."""

    @property
    def device(self):
        return torch.device("meta")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if torch.is_tensor(t))


def _count(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree) if torch.is_tensor(t))


@dataclasses.dataclass(frozen=True)
class LayerMemoryReport:
    """Per-layer memory, in bytes except ``param_count``.
    ``activation_bytes_per_example`` is the layer's output, a residual the
    backward pass holds in training."""

    layer_name: str
    layer_type: str
    param_count: int
    param_bytes: int
    updater_state_bytes: int
    activation_bytes_per_example: int

    def training_fixed_bytes(self) -> int:
        # params + gradients (the same size) + updater state
        return 2 * self.param_bytes + self.updater_state_bytes

    def inference_fixed_bytes(self) -> int:
        return self.param_bytes


@dataclasses.dataclass(frozen=True)
class NetworkMemoryReport:
    """Whole-network report (reference: NetworkMemoryReport.java)."""

    layer_reports: tuple
    input_bytes_per_example: int
    model_name: str = "network"

    @property
    def total_param_count(self) -> int:
        return sum(r.param_count for r in self.layer_reports)

    @property
    def total_param_bytes(self) -> int:
        return sum(r.param_bytes for r in self.layer_reports)

    @property
    def total_updater_state_bytes(self) -> int:
        return sum(r.updater_state_bytes for r in self.layer_reports)

    def total_memory_bytes(self, batch_size: int, *, training: bool = True) -> int:
        """The estimated peak of one step at ``batch_size``: training keeps
        every layer's output live for the backward; inference needs the
        largest neighbouring pair of activations at once."""
        acts = [r.activation_bytes_per_example for r in self.layer_reports]
        if training:
            fixed = sum(r.training_fixed_bytes() for r in self.layer_reports)
            transient = self.input_bytes_per_example + sum(acts)
        else:
            fixed = sum(r.inference_fixed_bytes() for r in self.layer_reports)
            pairs = [self.input_bytes_per_example] + acts
            transient = max((pairs[i] + pairs[i + 1] for i in range(len(pairs) - 1)),
                            default=self.input_bytes_per_example)
        return fixed + batch_size * transient

    def to_json(self, indent=2) -> str:
        return json.dumps({
            "model_name": self.model_name,
            "total_param_count": self.total_param_count,
            "total_param_bytes": self.total_param_bytes,
            "total_updater_state_bytes": self.total_updater_state_bytes,
            "input_bytes_per_example": self.input_bytes_per_example,
            "layers": [dataclasses.asdict(r) for r in self.layer_reports],
        }, indent=indent)

    def summary(self, batch_size: int = 32) -> str:
        lines = [f"{'layer':<28}{'type':<26}{'params':>12}{'act/ex (B)':>12}", "-" * 78]
        for r in self.layer_reports:
            lines.append(f"{r.layer_name:<28}{r.layer_type:<26}{r.param_count:>12}"
                         f"{r.activation_bytes_per_example:>12}")
        lines.append("-" * 78)
        lines.append(
            f"total params: {self.total_param_count:,} "
            f"({self.total_param_bytes / 1e6:.2f} MB), "
            f"train @ batch {batch_size}: "
            f"{self.total_memory_bytes(batch_size) / 1e6:.2f} MB, "
            f"infer @ batch {batch_size}: "
            f"{self.total_memory_bytes(batch_size, training=False) / 1e6:.2f} MB")
        return "\n".join(lines)


def _example_bytes(input_type, dtype) -> int:
    n = 1
    for d in input_type.shape(batch=1):
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def memory_report(conf, *, dtype=torch.float32, model_name="network") -> NetworkMemoryReport:
    """A NetworkMemoryReport for a MultiLayerConfiguration, from shapes
    made on the meta device (no memory is touched)."""
    in_types, _ = conf.layer_input_types()
    gen = _MetaGenerator()
    updater = conf.updater
    reports = []
    for i, (layer, it) in enumerate(zip(conf.layers, in_types)):
        p_shapes = layer.init(gen, it, dtype)
        u_bytes = _nbytes(updater.init(p_shapes)) if updater is not None else 0
        fam = layer.input_family
        out_t = layer.output_type(_inputs.adapted_type(it, fam) if fam is not None
                                  and not isinstance(it, fam) else it)
        reports.append(LayerMemoryReport(
            layer_name=f"layer_{i}", layer_type=type(layer).__name__,
            param_count=_count(p_shapes), param_bytes=_nbytes(p_shapes),
            updater_state_bytes=u_bytes,
            activation_bytes_per_example=_example_bytes(out_t, dtype)))
    return NetworkMemoryReport(layer_reports=tuple(reports),
                               input_bytes_per_example=_example_bytes(conf.input_type, dtype),
                               model_name=model_name)
