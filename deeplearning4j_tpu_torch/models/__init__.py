"""Model zoo: the models ported so far."""

from deeplearning4j_tpu_torch.models.misc import (  # noqa: F401
    get_model, text_generation_lstm, transformer_lm,
)
