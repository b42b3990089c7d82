"""Model import: Keras HDF5 files (``keras.py``, ``layers.py``) and DL4J
ModelSerializer zips (``dl4j.py``), the JAX package's
``deeplearning4j_tpu/modelimport`` (reference: deeplearning4j-modelimport,
SURVEY.md §2.6; util/ModelSerializer.java)."""

from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError,
    import_keras_model_and_weights,
    import_keras_sequential_config,
    import_keras_sequential_config_and_weights,
    import_keras_sequential_model_and_weights,
)

__all__ = [
    "KerasImportError",
    "import_keras_model_and_weights",
    "import_keras_sequential_config",
    "import_keras_sequential_config_and_weights",
    "import_keras_sequential_model_and_weights",
]
