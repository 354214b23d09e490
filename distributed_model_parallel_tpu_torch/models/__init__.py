"""Model zoo (port of `models/`): parameter trees and pure functions over
them, NHWC images, linear weights (K, N)."""

from distributed_model_parallel_tpu_torch.models import layers  # noqa: F401
from distributed_model_parallel_tpu_torch.models.layers import (  # noqa: F401
    Context,
    Layer,
)
from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (  # noqa: F401,E501
    mobilenet_v2,
    mobilenet_v2_nobn,
    split_stages,
)
from distributed_model_parallel_tpu_torch.models.resnet import (  # noqa: F401
    resnet,
    resnet18,
    resnet50,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import (  # noqa: F401
    tiny_cnn,
)
from distributed_model_parallel_tpu_torch.models.bert import (  # noqa: F401
    BERT_BASE,
    BertConfig,
    bert_base,
    bert_for_classification,
)
from distributed_model_parallel_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    gpt_lm,
    lm_loss,
    lm_loss_fn,
)
from distributed_model_parallel_tpu_torch.models.moe import (  # noqa: F401
    moe_encoder_layer,
    moe_feed_forward,
)
from distributed_model_parallel_tpu_torch.models.vit import (  # noqa: F401
    VIT_B16,
    VIT_CIFAR,
    ViTConfig,
    vit,
    vit_b16,
    vit_cifar,
)
