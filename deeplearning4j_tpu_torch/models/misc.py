"""Zoo models ported so far: the GravesLSTM char-RNN and the transformer
language model.

Each builds the same configuration as the JAX package's
(``deeplearning4j_tpu/models/misc.py``), so both serialize to the same
``config.json``.
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


def transformer_lm(vocab_size, n_layers=4, d_model=256, n_heads=4,
                   seq_len=128, mlp_ratio=4, updater=None, seed=12345):
    """Decoder-only transformer language model: [B, T] (or [B, T, 1]) token
    ids -> per-timestep vocab softmax trained with cross-entropy. Its
    attention takes the flash kernel from ``seq_len`` >= MIN_SEQ."""
    return NeuralNetConfig(seed=seed, updater=updater or U.Adam(learning_rate=3e-4)).list(
        L.EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model, add_positional=True),
        *[L.TransformerBlock(n_out=d_model, n_heads=n_heads, mlp_ratio=mlp_ratio,
                             causal=True)
          for _ in range(n_layers)],
        L.RnnOutputLayer(n_out=vocab_size, loss="mcxent"),
        input_type=I.RecurrentType(1, seq_len),
    )


_MODELS = {"text_generation_lstm": text_generation_lstm, "transformer_lm": transformer_lm}


def get_model(name, **kwargs):
    """The configuration of the zoo model ``name``, built with ``kwargs``."""
    try:
        fn = _MODELS[name]
    except KeyError:
        raise KeyError(f"zoo model {name!r} is not ported yet; ported: "
                       f"{sorted(_MODELS)}") from None
    return fn(**kwargs)

