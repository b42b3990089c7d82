"""The streaming tier: the NDArray wire codec (``codec``) and TCP pub/sub
with a streaming training iterator (``pubsub``), the port of
``deeplearning4j_tpu/streaming/``."""

from deeplearning4j_tpu_torch.streaming.codec import (  # noqa: F401
    decode_dataset, decode_ndarray, encode_dataset, encode_ndarray,
)
from deeplearning4j_tpu_torch.streaming.pubsub import (  # noqa: F401
    NDArrayPublisher, NDArraySubscriber, StreamingBroker,
    StreamingDataSetIterator,
)
