"""checkpointing/ (port of the reference's package): sharded parallel
saves, async writes, resharding restore.

Beside the legacy gather-to-rank-0 format of `training/checkpoint.py`
(still the default and always readable), three layers, file for file
the reference's, so either package restores the other's files:

  sharded save       each rank writes only the chunks it owns
                     (`{name}.s{id}.shard{p}.npz`) + a JSON manifest; no
                     all-gather on the save path (save.py, sharded.py).
  async writer       one device -> host snapshot on the step path, file
                     I/O on a background thread; errors surface at the
                     next save or `fit()` exit, and a crash mid-write
                     never clobbers the previous manifest (writer.py).
  resharding restore full leaves reassembled from the chunks and
                     re-sliced for the CURRENT mesh by the engine's
                     `from_canonical`; `elastic_fit` hands the saved
                     topology to a restart (restore.py).

Opt in with `TrainerConfig(checkpoint_format="sharded", async_save=True)`
or `--checkpoint-format sharded --async-save` on the training CLIs.
"""

from distributed_model_parallel_tpu_torch.checkpointing.manifest import (
    Manifest,
    load_manifest,
    manifest_exists,
    manifest_path,
)
from distributed_model_parallel_tpu_torch.checkpointing.restore import (
    checkpoint_metadata,
    restore_checkpoint,
    restore_subtree,
    saved_topology,
)
from distributed_model_parallel_tpu_torch.checkpointing.save import (
    save_sharded,
)
from distributed_model_parallel_tpu_torch.checkpointing.sharded import (
    ShardedState,
    sharded_state,
)
from distributed_model_parallel_tpu_torch.checkpointing.writer import (
    AsyncCheckpointer,
    SaveHandle,
)

__all__ = [
    "AsyncCheckpointer",
    "Manifest",
    "SaveHandle",
    "ShardedState",
    "checkpoint_metadata",
    "load_manifest",
    "manifest_exists",
    "manifest_path",
    "restore_checkpoint",
    "restore_subtree",
    "save_sharded",
    "saved_topology",
    "sharded_state",
]
