"""Serving tier: continuous batching over warmed shape buckets.

Quickstart::

    from deeplearning4j_tpu_torch.serving import get_model_registry
    reg = get_model_registry()
    engine = reg.register("charnn", net, input_spec=(128, 96),
                          max_batch_size=64, seq_buckets=(32, 64, 128),
                          device="cuda")
    y = engine.submit(example, tenant="acme").get(timeout=10.0)
    reg.update_model("charnn", retrained)     # atomic hot swap
    usage = reg.health()["models"]["charnn"]["usage"]
    reg.stop()
"""

from deeplearning4j_tpu_torch.serving.engine import (BucketedForward,
                                                     InferenceFuture,
                                                     ServingEngine,
                                                     ServingOverloaded,
                                                     ServingShutdown)
from deeplearning4j_tpu_torch.serving.registry import (ModelRegistry,
                                                       get_model_registry,
                                                       manifest_grid_signatures, reset)

__all__ = ["BucketedForward", "InferenceFuture", "ModelRegistry",
           "ServingEngine", "ServingOverloaded", "ServingShutdown",
           "get_model_registry", "manifest_grid_signatures", "reset"]
