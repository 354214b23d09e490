"""Sharded parallel save (port of `checkpointing/save.py`): each rank
writes its own chunks, nothing gathers.

`save_sharded` supersedes the legacy `training/checkpoint.save_checkpoint`
gather-to-rank-0 path for the sharded engines (FSDP, tensor parallel):
the state stays in its runtime layout, every rank persists exactly the
chunks it owns (`sharded.plan_leaf_chunks`), and no all-gather runs on
the save path.

Layout on disk (manifest.py has the commit discipline):

    {name}.s{save_id}.shard{p}.npz   one per rank owning >= 1 chunk
    {name}.manifest.json             committed LAST; the previous
                                     save's shard files are deleted only
                                     after this rename lands

Several ranks need a filesystem they all share: rank 0 waits for every
referenced peer shard file to appear (each is renamed into place, so
existence means complete) before it commits the manifest.

With a `writer` (an `AsyncCheckpointer`) only the snapshot, the device
-> host copy of the owned chunks, happens on the caller's thread; all
file I/O runs in the background and its errors surface at the next save
or when `fit()` exits (writer.py). Without one the same job runs inline.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Union

from distributed_model_parallel_tpu_torch.checkpointing import (
    writer as writer_mod,
)
from distributed_model_parallel_tpu_torch.checkpointing.manifest import (
    Chunk,
    LeafRecord,
    Manifest,
    commit_manifest,
    gc_stale_shards,
    manifest_path,
    next_save_id,
    shard_file_name,
)
from distributed_model_parallel_tpu_torch.checkpointing.sharded import (
    ShardedState,
    local_chunk_data,
    plan_leaf_chunks,
)
from distributed_model_parallel_tpu_torch.checkpointing.writer import (
    AsyncCheckpointer,
    SaveHandle,
)
from distributed_model_parallel_tpu_torch.observability.metrics import (
    get_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (
    get_tracer,
)
from distributed_model_parallel_tpu_torch.runtime.dist import process_index

# How long rank 0 waits for peer shard files before declaring the save
# failed (shared-filesystem propagation and slow peers).
PEER_SHARD_TIMEOUT_S = 600.0


def save_sharded(
    directory: str,
    tree: ShardedState,
    *,
    acc: float,
    epoch: int,
    name: str = "ckpt",
    extra: Optional[dict] = None,
    writer: Optional[AsyncCheckpointer] = None,
    peer_timeout_s: float = PEER_SHARD_TIMEOUT_S,
) -> Union[str, SaveHandle]:
    """Write `tree` (`sharded.sharded_state`, an engine's
    `to_canonical_sharded`) as a sharded checkpoint.

    EVERY rank calls this together, with the same tree structure; each
    snapshots only its own chunks. Synchronous without `writer`
    (returns the manifest path); with one, returns a `SaveHandle` as
    soon as the snapshot is taken."""
    my_process = process_index()
    save_id = next_save_id(directory, name)
    if writer is not None:
        # A predecessor still writing has not committed its manifest;
        # reserve past it so shard file names stay unique per save.
        save_id = writer.reserve_save_id(directory, name, save_id)

    # ---- plan + snapshot (caller's thread): the same plan on every
    # rank; data copied to the host only for the chunks this rank owns.
    writing_processes: list = []
    proc_to_file: dict = {}
    records: dict = {}
    my_arrays: dict = {}
    tracer = get_tracer()
    mx = get_metrics()
    t0 = tracer.now() if mx.enabled else None
    with tracer.span("ckpt_snapshot", snapshot=name, save_id=save_id):
        for key in sorted(tree.leaves):
            leaf = tree.leaves[key]
            chunks = []
            for ordinal, pc in enumerate(plan_leaf_chunks(leaf)):
                if pc.owner_process not in proc_to_file:
                    proc_to_file[pc.owner_process] = len(writing_processes)
                    writing_processes.append(pc.owner_process)
                npz_key = f"{key}::{ordinal}"
                chunks.append(Chunk(file=proc_to_file[pc.owner_process],
                                    key=npz_key, start=pc.start,
                                    shape=pc.shape))
                data = local_chunk_data(leaf, pc)
                if data is not None:
                    my_arrays[npz_key] = data
            records[key] = LeafRecord(shape=tuple(leaf.shape),
                                      dtype=leaf.dtype, spec=leaf.spec,
                                      chunks=chunks)
    if t0 is not None:
        mx.observe("ckpt_snapshot_s", tracer.now() - t0)
    shard_files = [shard_file_name(name, save_id, p)
                   for p in writing_processes]
    manifest = Manifest(save_id=save_id, acc=float(acc), epoch=int(epoch),
                        shards=shard_files, leaves=records,
                        mesh_axes=tree.mesh_axes,
                        process_count=tree.process_count, extra=extra)
    os.makedirs(directory, exist_ok=True)
    my_file = (shard_file_name(name, save_id, my_process)
               if my_process in proc_to_file else None)

    # ---- the I/O half: in the background under a writer, else inline.
    def job() -> None:
        if my_file is not None:
            writer_mod._write_shard(os.path.join(directory, my_file),
                                    my_arrays)
        if my_process != 0:
            return  # rank 0 alone commits, and collects for everyone
        _await_peer_shards(directory, shard_files, my_file, peer_timeout_s)
        commit_manifest(directory, name, manifest)
        gc_stale_shards(directory, name, save_id, process=None)

    path = manifest_path(directory, name)
    if writer is None:
        job()
        return path
    return writer.submit(job, path)


def _await_peer_shards(directory: str, shard_files: list,
                       my_file: Optional[str], timeout_s: float) -> None:
    """Rank 0's pre-commit barrier: every referenced shard file must
    exist (renamed into place, so complete) before the manifest lands."""
    missing = [f for f in shard_files
               if f != my_file and not os.path.isfile(
                   os.path.join(directory, f))]
    deadline = time.monotonic() + timeout_s
    while missing:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"sharded save of '{os.path.join(directory, my_file or '')}'"
                f" timed out after {timeout_s:.0f}s waiting for peer shard "
                f"files {missing} — shared filesystem required for "
                "checkpoint_format='sharded'")
        time.sleep(0.05)
        missing = [f for f in missing
                   if not os.path.isfile(os.path.join(directory, f))]


__all__ = ["PEER_SHARD_TIMEOUT_S", "save_sharded"]
