"""Meshes and the process group (port of `runtime/`): `mesh.py` lays the
data, model, seq, expert and stage axes out over `torch.distributed`
ranks, `dist.py` starts the process group (a world of one gloo rank
when no launcher set one)."""

from distributed_model_parallel_tpu_torch.runtime.mesh import (  # noqa: F401
    MeshSpec,
    local_mesh,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.runtime.dist import (  # noqa: F401
    initialize_backend,
    is_primary,
    process_count,
    process_index,
)
