"""Model zoo: the builders and the registry (``get_model(name)`` returns a
``ZooModel``, as in the JAX package)."""

from deeplearning4j_tpu_torch.models.lenet import lenet  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet import (  # noqa: F401
    resnet50, resnet50_flops_per_example, resnet50_mln,
)
from deeplearning4j_tpu_torch.models.vgg import vgg16, vgg19  # noqa: F401
from deeplearning4j_tpu_torch.models.misc import (  # noqa: F401
    alexnet, darknet19, simple_cnn, text_generation_lstm, tiny_yolo, transformer_lm,
)
from deeplearning4j_tpu_torch.models.inception import (  # noqa: F401
    InceptionModule, facenet_nn4_small2, googlenet, inception_resnet_v1,
)
from deeplearning4j_tpu_torch.models.zoo import (  # noqa: F401
    PretrainedType, ZooModel, get_model, init_pretrained, model_names, register_model,
    restore_checkpoint,
)
