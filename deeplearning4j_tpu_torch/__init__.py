"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The port mirrors the JAX package's module paths and its on-disk formats
(config JSON, checkpoint zip v1), so a model written by either package
loads in the other. It imports torch, numpy and the standard library only.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
raises when CUDA is requested and no card is present; pass
``device="cpu"`` to run on the CPU, where each hand-written kernel's
wrapper takes its plain PyTorch version.

Ported so far: serving a sequential recurrent network (the GravesLSTM
char-RNN) through ``serving.ModelRegistry`` and the ``serve`` CLI verb,
with the LSTM recurrence in a hand-written Hopper kernel
(``ops/lstm_seq.py`` + ``csrc/lstm_seq.cu``); training a sequential
network through ``MultiLayerNetwork.fit`` (losses, updaters, schedules,
gradient normalization, constraints), with the transformer LM's
attention forward in a hand-written Hopper flash kernel
(``ops/attention.py`` + ``csrc/flash_attn.cu``).
"""

__version__ = "0.1.0"
