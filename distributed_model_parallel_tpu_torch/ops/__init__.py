"""Compute ops (port of `ops/`): the attention cores, their
sequence-parallel variants (ring, Ulysses and ring-flash over
`torch.distributed`), the flash-attention kernels K1-K3
(`flash_attention.py`, the counterpart of `pallas_attention.py`, over
`csrc/flash_attention.cu`), the collective matmuls, and the bucketed
hierarchy-aware gradient reducer (`grad_reduction.py`)."""

from distributed_model_parallel_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.ops.collective_matmul import (  # noqa: F401,E501
    CollectiveMatmul,
    LocalCollectiveMatmul,
    ag_matmul,
    matmul_rs,
)
from distributed_model_parallel_tpu_torch.ops.grad_reduction import (  # noqa: F401,E501
    bucketed_pmean,
    bucketed_psum,
    plan_buckets,
    ring_all_gather,
    ring_reduce_scatter,
)
from distributed_model_parallel_tpu_torch.ops.flash_attention import (  # noqa: F401,E501
    flash_attention,
)
from distributed_model_parallel_tpu_torch.ops.ring_attention import (  # noqa: F401,E501
    ring_attention,
    ring_flash_attention,
    ulysses_attention,
)
