"""Training telemetry of the port: the one-dispatch-late score pipeline
(``scorepipe``) and the numerics watchdog (``health``). The JAX package's
metrics registry, spans, flight recorder and device gauges are not ported
yet (ROADMAP queue 1, item 7)."""

from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.telemetry.scorepipe import ScorePipeline

__all__ = ["ScorePipeline", "health"]
