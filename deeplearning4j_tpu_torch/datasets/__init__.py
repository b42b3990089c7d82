from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    ArrayDataSetIterator, AsyncDataSetIterator, BenchmarkDataSetIterator, BucketRegistry,
    DataSet, DataSetCallback, EarlyTerminationIterator, InterleavedDataSetCallback,
    MultipleEpochsIterator, ShapeBuckets, ShardedDataSetIterator, iter_batches, pad_batch, validity_mask,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    Cifar10DataFetcher, EmnistDataFetcher, IrisDataFetcher, LfwDataFetcher,
    MnistDataFetcher, SvhnDataFetcher, SyntheticDataFetcher,
    TinyImageNetFetcher, UciSequenceDataFetcher,
    cifar10_iterator, emnist_iterator, iris_iterator, mnist_iterator,
    svhn_iterator, synthetic_iterator, tiny_imagenet_iterator,
    uci_sequence_iterator,
)
from deeplearning4j_tpu_torch.datasets.cacheable import (  # noqa: F401
    ChecksumError, ensure_extracted, ensure_file,
)
