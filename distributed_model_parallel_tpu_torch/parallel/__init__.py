"""The training engines (port of `parallel/`): data parallel (global and
per-replica BN), pipeline, sequence, tensor, expert and FSDP, and the
composed plans over them."""

from distributed_model_parallel_tpu_torch.parallel.data_parallel import (  # noqa: F401,E501
    DataParallelEngine,
    DDPEngine,
    TrainState,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (  # noqa: F401,E501
    LMPipelineEngine,
    PipelineEngine,
    build_1f1b_schedule,
    build_interleaved_schedule,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (  # noqa: F401,E501
    CausalLMSequenceParallelEngine,
    SequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (  # noqa: F401,E501
    MEGATRON_RULES,
    TensorParallelEngine,
)
from distributed_model_parallel_tpu_torch.parallel.expert_parallel import (  # noqa: F401,E501
    EXPERT_RULES,
    ExpertParallelEngine,
)
from distributed_model_parallel_tpu_torch.parallel.fsdp import (  # noqa: F401
    FSDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.plan import (  # noqa: F401
    ComposedPlanEngine,
    ParallelPlan,
    build_plan_engine,
    parse_plan,
)
