"""Zoo models ported so far: the GravesLSTM char-RNN.

``text_generation_lstm`` builds the same configuration as the JAX
package's (``deeplearning4j_tpu/models/misc.py``), so both serialize to
the same ``config.json``.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig


def text_generation_lstm(vocab_size, hidden=256, seq_len=64, updater=None, seed=12345):
    """Char-RNN (reference: TextGenerationLSTM.java — stacked GravesLSTM +
    RnnOutputLayer; BASELINE.md config #4)."""
    return NeuralNetConfig(seed=seed, updater=updater or U.RmsProp(learning_rate=1e-3)).list(
        L.GravesLSTM(n_out=hidden),
        L.GravesLSTM(n_out=hidden),
        L.RnnOutputLayer(n_out=vocab_size, loss="mcxent"),
        input_type=I.RecurrentType(vocab_size, seq_len),
        backprop_type="tbptt", tbptt_fwd_length=seq_len, tbptt_back_length=seq_len,
    )


_MODELS = {"text_generation_lstm": text_generation_lstm}


def get_model(name, **kwargs):
    """The configuration of the zoo model ``name``, built with ``kwargs``."""
    try:
        fn = _MODELS[name]
    except KeyError:
        raise KeyError(f"zoo model {name!r} is not ported yet; ported: "
                       f"{sorted(_MODELS)}") from None
    return fn(**kwargs)

