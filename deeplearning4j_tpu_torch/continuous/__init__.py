"""The resumable dispatch loop every fit path of the port runs
(``driver.StepDriver``)."""

from deeplearning4j_tpu_torch.continuous.driver import RoundResult, StepDriver

__all__ = ["RoundResult", "StepDriver"]
