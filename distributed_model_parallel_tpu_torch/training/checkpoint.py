"""Checkpoint / resume (port of `training/checkpoint.py`, and of the
legacy-format readers `checkpoint_metadata` / `restore_subtree` of
`checkpointing/restore.py`).

The reference saves `{'net': state_dict, 'acc': best_acc, 'epoch':
epoch}` whenever validation accuracy improves and restores it under
`--resume`. As in the JAX package, the whole training state goes into
the snapshot (parameters, BN running stats, optimizer moments, step),
plus the epoch and the best accuracy, so a resumed run continues the
schedule where it stopped.

Format: the JAX package's legacy format, byte for byte in its keys,
shapes and dtypes, so that a checkpoint written by either package
resumes in the other:

* `{name}.npz` holds every leaf of the canonical tree, keyed by its
  flattened path (`params/...`, `model_state/...`,
  `opt_state/momentum/...` or `opt_state/mu|nu|count`, `step`). The
  canonical tree is the JAX package's layout
  (`models/convert.train_state_to_jax`): conv weights HWIO, `step` an
  int32 scalar;
* `{name}.json` is the sidecar: `acc`, `epoch`, the sorted `keys`, and
  any `extra` fields (the LM CLI records its `gpt_config`);
* both are written to a temporary name and renamed into place, by
  rank 0 only.

Restore: rank 0 reads the file; with more than one rank it broadcasts
the outcome (an error is raised on every rank), the accuracy, the epoch
and then every leaf (`torch.distributed`), so ranks with their own disks
resume identically (`agree_and_broadcast`, which the sharded format's
reader shares). This module is the legacy format's writer and reader;
`checkpointing/restore.py` is the unified reader, which takes a sharded
manifest when one is present and this reader otherwise.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.runtime.dist import (
    is_primary,
    process_count,
)

def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts and tuples -> {"a/0/c": leaf}, the JAX package's path
    keys (a tuple's index is its key: the pipeline's per-stage tuples)."""
    if isinstance(tree, dict) or type(tree) is tuple:
        items = (sorted(tree.items()) if isinstance(tree, dict)
                 else enumerate(tree))
        out = {}
        for k, v in items:
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten_like(template, leaves: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if type(template) is tuple:
        return tuple(_unflatten_like(v, leaves, f"{prefix}{i}/")
                     for i, v in enumerate(template))
    return leaves[prefix[:-1]]


def _write_atomic(path: str, write, mode: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        write(f)
    os.replace(tmp, path)


def save_checkpoint(directory: str, tree: Any, *, acc: float, epoch: int,
                    name: str = "ckpt", extra: Optional[dict] = None) -> str:
    """Write `{directory}/{name}.npz` and its `.json` sidecar from the
    canonical `tree` (nested dicts of numpy arrays,
    `models/convert.train_state_to_jax`). Rank 0 writes; other ranks
    return at once (the state is replicated). Returns the npz path."""
    npz_path = os.path.join(directory, f"{name}.npz")
    if not is_primary():
        return npz_path
    arrays = {k: np.asarray(v) for k, v in flatten_tree(tree).items()}
    os.makedirs(directory, exist_ok=True)
    _write_atomic(npz_path, lambda f: np.savez(f, **arrays), "wb")
    meta = {"acc": float(acc), "epoch": int(epoch), "keys": sorted(arrays)}
    if extra:
        meta.update(extra)
    _write_atomic(os.path.join(directory, f"{name}.json"),
                  lambda f: json.dump(meta, f, indent=1), "w")
    return npz_path


def _manifest_path(directory: str, name: str) -> str:
    # The sharded format's commit point (`checkpointing/manifest.py`,
    # which imports this module; the file name is spelled here).
    return os.path.join(directory, f"{name}.manifest.json")


def _missing(directory: str, name: str) -> FileNotFoundError:
    npz_path = os.path.join(directory, f"{name}.npz")
    if os.path.isfile(_manifest_path(directory, name)):
        return FileNotFoundError(
            f"Error: {directory} holds a sharded checkpoint ({name}."
            f"manifest.json) and no {name}.npz; this is the legacy "
            "format's reader: restore it through "
            "checkpointing.restore_checkpoint")
    return FileNotFoundError(f"Error: no checkpoint found at {npz_path}")


def _read_leaves(npz_path: str, template: dict, prefix: str) -> dict:
    """{path: array} for every leaf of `template` (leaves with `.shape`
    and `.dtype`), read from the npz under `{prefix}{path}`, each cast to
    the template's dtype. KeyError names a missing leaf, ValueError one
    whose shape differs."""
    with np.load(npz_path) as data:
        files = set(data.files)
        out = {}
        for path, leaf in flatten_tree(template).items():
            key = prefix + path
            if key not in files:
                raise KeyError(
                    f"checkpoint at {npz_path} is missing leaf '{key}' — "
                    "model structure changed since save")
            arr = data[key]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint leaf '{key}' has shape "
                                 f"{arr.shape}, expected {want}")
            out[path] = arr.astype(leaf.dtype)
    return out


def _read_meta(directory: str, name: str) -> dict:
    meta_path = os.path.join(directory, f"{name}.json")
    if not os.path.isfile(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _broadcast_leaves(leaves: dict, template: dict) -> dict:
    """Rank 0's leaves to every rank, one broadcast each, in path
    order; NCCL broadcasts from the rank's GPU, gloo from the host."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    out = {}
    for path, leaf in flatten_tree(template).items():
        if path in leaves:
            # ascontiguousarray lifts a 0-d leaf (AdamW's count) to 1-d
            t = torch.from_numpy(np.ascontiguousarray(leaves[path]).reshape(
                tuple(leaf.shape)))
        else:
            t = torch.from_numpy(np.zeros(tuple(leaf.shape), leaf.dtype))
        t = t.to(dev)
        dist.broadcast(t, src=0)
        out[path] = t.cpu().numpy()
    return out


def agree_and_broadcast(read, template) -> Tuple[Any, float, int]:
    """Rank 0 runs `read()` -> ({path: array}, acc, epoch); with more
    than one rank the outcome (an error is raised on every rank), the
    accuracy, the epoch and then every leaf are broadcast, so no rank
    hangs in a broadcast that rank 0 never reaches. Returns (tree shaped
    like `template`, acc, epoch)."""
    leaves, acc, epoch, error = {}, 0.0, 0, None
    if is_primary():
        try:
            leaves, acc, epoch = read()
        except (OSError, KeyError, ValueError) as e:
            error = e
    if process_count() > 1:
        status = [error, acc, epoch]
        dist.broadcast_object_list(status, src=0)
        error, acc, epoch = status
        if error is None:
            leaves = _broadcast_leaves(leaves, template)
    if error is not None:
        raise error
    return _unflatten_like(template, leaves), acc, epoch


def restore_checkpoint(directory: str, template: Any, *,
                       name: str = "ckpt") -> Tuple[Any, float, int]:
    """Restore into the structure of `template` (the canonical tree, or
    one of `models/convert.ShapeDtype` leaves). Returns (tree of numpy
    arrays, best_acc, epoch). FileNotFoundError when the file is absent,
    KeyError / ValueError when a leaf is missing or misshapen — raised
    on every rank when rank 0's read fails."""

    def read():
        npz_path = os.path.join(directory, f"{name}.npz")
        if not os.path.isfile(npz_path):
            raise _missing(directory, name)
        leaves = _read_leaves(npz_path, template, "")
        meta = _read_meta(directory, name)
        return leaves, float(meta.get("acc", 0.0)), int(meta.get("epoch", 0))

    return agree_and_broadcast(read, template)


def latest_exists(directory: str, name: str = "ckpt") -> bool:
    """True when a restorable checkpoint of either format is present: the
    legacy `{name}.npz`, or a sharded save's manifest (its commit
    point, so its existence means a complete save)."""
    return os.path.isfile(os.path.join(directory, f"{name}.npz")) or \
        os.path.isfile(_manifest_path(directory, name))


def checkpoint_epoch(directory: str, name: str = "ckpt") -> Optional[int]:
    """Epoch recorded in the sharded manifest or `{name}.json`, or None
    when the checkpoint or its record is absent or unreadable. The
    manifest first: the unified reader prefers it when both formats
    share the directory, so the epoch answered is the snapshot's that
    would load."""
    if not latest_exists(directory, name):
        return None
    for meta_path in (_manifest_path(directory, name),
                      os.path.join(directory, f"{name}.json")):
        if not os.path.isfile(meta_path):
            continue
        try:
            with open(meta_path) as f:
                return int(json.load(f).get("epoch", 0))
        except (OSError, ValueError):
            continue
    return None


def newest_checkpoint_name(directory: str) -> str:
    """The newer by recorded epoch of the per-epoch 'last' and the
    best-acc 'ckpt' snapshots, ties to 'last'. The one rule shared by
    the Trainer's resume and `cli/serve.py --checkpoint`, so training and
    serving never pick different snapshots; a stale 'last' from an older
    run never rolls a newer 'ckpt' back."""
    last_ep = checkpoint_epoch(directory, "last")
    ckpt_ep = checkpoint_epoch(directory, "ckpt")
    if last_ep is not None and (ckpt_ep is None or last_ep >= ckpt_ep):
        return "last"
    return "ckpt"


def checkpoint_metadata(directory: str, name: str = "ckpt") -> dict:
    """The sidecar (acc, epoch, keys and extra fields, with
    `format: legacy`) without reading any array; FileNotFoundError when
    the checkpoint is absent."""
    if not os.path.isfile(os.path.join(directory, f"{name}.npz")):
        raise _missing(directory, name)
    return {"format": "legacy", **_read_meta(directory, name)}


def restore_subtree(directory: str, template: Any, *, name: str = "ckpt",
                    prefix: str = "params") -> Tuple[Any, dict]:
    """One subtree of a saved training state (the `params` for serving),
    shaped like `template`, plus the checkpoint's metadata. Read on this
    process alone (serving runs one)."""
    npz_path = os.path.join(directory, f"{name}.npz")
    if not os.path.isfile(npz_path):
        raise _missing(directory, name)
    leaves = _read_leaves(npz_path, template, f"{prefix}/")
    meta = {"format": "legacy", **_read_meta(directory, name)}
    return _unflatten_like(template, leaves), meta


__all__ = ["agree_and_broadcast", "checkpoint_epoch", "checkpoint_metadata",
           "flatten_tree", "latest_exists", "newest_checkpoint_name",
           "restore_checkpoint", "restore_subtree", "save_checkpoint"]
