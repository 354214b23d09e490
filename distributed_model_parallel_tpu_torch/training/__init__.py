"""Training (port of `training/`): optimizers and the cosine schedule,
metrics, the legacy checkpoint format, and the Trainer."""

from distributed_model_parallel_tpu_torch.training.optim import (  # noqa: F401
    SGD,
    AdamW,
    AdamWState,
    SGDState,
    cosine_warmup_schedule,
)
from distributed_model_parallel_tpu_torch.training.metrics import (  # noqa: F401,E501
    Meter,
    accuracy,
    cross_entropy,
    topk_correct,
)
from distributed_model_parallel_tpu_torch.training.checkpoint import (  # noqa: F401,E501
    latest_exists,
    restore_checkpoint,
    save_checkpoint,
)
from distributed_model_parallel_tpu_torch.training.trainer import (  # noqa: F401,E501
    EpochStats,
    Trainer,
    TrainerConfig,
)
