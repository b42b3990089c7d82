from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    BucketRegistry, ShapeBuckets, iter_batches, pad_batch, validity_mask,
)
