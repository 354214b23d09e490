"""Resharding restore (port of `checkpointing/restore.py`): any saved
layout onto any current mesh.

`restore_checkpoint` is the unified entry the trainer calls: a directory
holding a sharded manifest restores through chunk reassembly; anything
else falls back to the legacy `.npz` reader
(`training/checkpoint.restore_checkpoint`), with the same signature and
return, so old checkpoints keep working.

Resharding is the point: each leaf is reassembled to its FULL host
array from whatever layout the manifest records (N-way FSDP, tensor-
parallel columns, the reference's GSPMD shards, a dcn x ici hybrid),
which is the canonical form every engine already restores through, and
the engine's `from_canonical` re-slices it for the CURRENT mesh. A file
saved at N = 2 loads at N = 1 or 4, and into the tensor-parallel
engine.

Ranks: the legacy reader's agreement protocol
(`training/checkpoint.agree_and_broadcast`): rank 0 reads, its outcome
is broadcast before anyone raises, then its leaves, so no rank hangs in
a broadcast, and ranks with their own disks restore what rank 0 sees.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np

from distributed_model_parallel_tpu_torch.checkpointing.manifest import (
    Manifest,
    load_manifest,
    manifest_exists,
    manifest_path,
)


def _legacy():
    """The legacy format's module (`training/checkpoint.py`), imported at
    first use: `training/__init__` re-exports the Trainer, which imports
    this package, so a module-level import here would close the cycle."""
    from distributed_model_parallel_tpu_torch.training import checkpoint

    return checkpoint


def _assemble_leaf(directory: str, manifest: Manifest, key: str,
                   want_shape, want_dtype, npz_cache: dict,
                   name: str = "ckpt") -> np.ndarray:
    rec = manifest.leaves.get(key)
    if rec is None:
        raise KeyError(
            f"sharded checkpoint at {manifest_path(directory, name)} is "
            f"missing leaf '{key}' — model structure changed since save")
    if tuple(rec.shape) != tuple(want_shape):
        raise ValueError(f"checkpoint leaf '{key}' has shape "
                         f"{tuple(rec.shape)}, expected {tuple(want_shape)}")
    arr = np.empty(rec.shape, dtype=np.dtype(rec.dtype))
    for ch in rec.chunks:
        fname = manifest.shards[ch.file]
        if fname not in npz_cache:
            path = os.path.join(directory, fname)
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"manifest references shard file {fname!r} which is "
                    f"absent from {directory} — a committed save never "
                    "leaves this state; was the directory partially "
                    "copied or hand-pruned?")
            npz_cache[fname] = np.load(path)
        region = tuple(slice(s, s + n) for s, n in zip(ch.start, ch.shape))
        arr[region] = npz_cache[fname][ch.key]
    # Not np.ascontiguousarray, which lifts a 0-d leaf to (1,): np.empty
    # is contiguous already.
    return arr.astype(want_dtype, copy=False)


def _read_leaves(directory: str, name: str, template: Any,
                 prefix: str = "") -> Tuple[dict, Manifest]:
    """{path: full array} for every leaf of `template` (leaves with
    `.shape` and `.dtype`), looked up under `{prefix}{path}`."""
    manifest = load_manifest(directory, name)
    npz_cache: dict = {}
    try:
        out = {path: _assemble_leaf(directory, manifest, prefix + path,
                                    tuple(leaf.shape), leaf.dtype,
                                    npz_cache, name)
               for path, leaf in _legacy().flatten_tree(template).items()}
    finally:
        for f in npz_cache.values():
            f.close()
    return out, manifest


def restore_checkpoint(directory: str, template: Any, *,
                       name: str = "ckpt") -> Tuple[Any, float, int]:
    """Unified restore: the sharded manifest when present, the legacy
    `.npz` otherwise. Returns (tree of full numpy arrays shaped like
    `template`, best_acc, epoch) on every rank (module docstring)."""
    if not manifest_exists(directory, name):
        return _legacy().restore_checkpoint(directory, template, name=name)

    def read():
        leaves, manifest = _read_leaves(directory, name, template)
        return leaves, manifest.acc, manifest.epoch

    return _legacy().agree_and_broadcast(read, template)


def _manifest_meta(m: Manifest) -> dict:
    meta = {"acc": m.acc, "epoch": m.epoch, "format": "sharded",
            "mesh_axes": dict(m.mesh_axes)}
    if m.extra:
        meta.update(m.extra)
    return meta


def restore_subtree(directory: str, template: Any, *, name: str = "ckpt",
                    prefix: str = "params") -> Tuple[Any, dict]:
    """ONE subtree of a saved training state (the `params`, for
    serving) from either format, plus the checkpoint's metadata (acc,
    epoch, extra: the serve CLI's model-config guard reads it). Saved
    keys are looked up under `{prefix}/{leaf path}`. Read on this
    process alone."""
    if not manifest_exists(directory, name):
        return _legacy().restore_subtree(directory, template, name=name,
                                         prefix=prefix)
    leaves, manifest = _read_leaves(directory, name, template, prefix + "/")
    return (_legacy()._unflatten_like(template, leaves),
            _manifest_meta(manifest))


def checkpoint_metadata(directory: str, name: str = "ckpt") -> dict:
    """acc / epoch / extra of either format WITHOUT reading array data
    (what `cli/serve.py --checkpoint` checks before building an engine).
    FileNotFoundError when neither format is present."""
    if manifest_exists(directory, name):
        return _manifest_meta(load_manifest(directory, name))
    if not os.path.isfile(os.path.join(directory, f"{name}.npz")):
        raise FileNotFoundError(
            f"Error: no checkpoint found at "
            f"{os.path.join(directory, name + '.npz')} (nor a "
            f"{name}.manifest.json)")
    return _legacy().checkpoint_metadata(directory, name)


def saved_topology(directory: str, name: str = "ckpt") -> Optional[dict]:
    """The mesh a sharded checkpoint was taken at, `{"mesh_axes": {...},
    "process_count": n, "epoch": e, "format": "sharded"}`, or None for
    a legacy or absent checkpoint (which records none): what
    `elastic_fit` hands to `make_trainer`."""
    if not manifest_exists(directory, name):
        return None
    try:
        m = load_manifest(directory, name)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    return {"mesh_axes": dict(m.mesh_axes),
            "process_count": m.process_count, "epoch": m.epoch,
            "format": "sharded"}


__all__ = ["checkpoint_metadata", "restore_checkpoint", "restore_subtree",
           "saved_topology"]
