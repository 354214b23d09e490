"""Chunk planning for sharded saves (port of `checkpointing/sharded.py`):
who writes which slice of which leaf.

ZeRO's discipline: every rank persists exactly the shards it already
holds, so the save path runs no collective. The reference derives the
plan from each array's `devices_indices_map`; the port's engines have no
sharded array type, so they describe their layout themselves:
`sharded_state` turns a `TrainState` and the engine's partition specs
(`parallel/tensor_parallel.Split` per leaf, None for replicated) into a
`ShardedState`, one `ShardedLeaf` a canonical leaf, holding

* the GLOBAL picture, the same on every rank without communication:
  each distinct region of the canonical leaf and the ranks that hold it;
* this rank's pieces of it, in the canonical layout (conv weights HWIO,
  as `models/convert.py` writes them), still where the engine keeps
  them.

A region's OWNER is the lowest rank that holds it (the reference takes
the lowest device id), and a rank writes a chunk iff it owns it. A
replicated leaf therefore collapses to one chunk that rank 0 writes; an
FSDP leaf sharded N ways yields N chunks, one a rank; a tensor-parallel
leaf's shards are written by the ranks of data index 0. The head-aligned
QKV shard (`Split(1, 3)`) is three rectangles of the canonical (D, 3D)
leaf: [q | k | v] columns of the rank's heads. An expert stack
(`parallel/expert_parallel.py`, a leading-E `Split(0)`) is N blocks of
E/N experts: written by the expert ranks of data index 0 under gspmd,
one a data rank under the hierarchical dispatch; the resharding restore
reassembles the whole stack, so a file saved at one S restores at
another.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.runtime.dist import (
    process_count,
    process_index,
)

# A region of a leaf: ((start, stop), ...) per dimension.
Region = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class ShardedLeaf:
    """One canonical leaf as this rank sees it (module docstring)."""

    shape: Tuple[int, ...]           # global, canonical layout
    dtype: str                       # numpy dtype name
    spec: list                       # the manifest's spec record
    holders: Dict[Region, Tuple[int, ...]]  # region -> ranks holding it
    local: Dict[Region, Any]         # this rank's regions -> data


@dataclasses.dataclass
class ShardedState:
    """A training state ready for `save_sharded`: canonical path ->
    `ShardedLeaf`, plus the mesh record the manifest stores."""

    leaves: Dict[str, ShardedLeaf]
    mesh_axes: dict
    process_count: int


@dataclasses.dataclass
class PlannedChunk:
    """One distinct slice region of one leaf, with its global owner."""

    start: Tuple[int, ...]
    shape: Tuple[int, ...]
    owner_process: int


def canonical_dim(dim: int, ndim: int) -> int:
    """The canonical (JAX-layout) index of the port's dimension `dim`:
    conv weights are OIHW in the port and HWIO in the canonical tree."""
    return (3, 2, 0, 1)[dim] if ndim == 4 else dim


def port_dim(dim: int, ndim: int) -> int:
    """Inverse of `canonical_dim`."""
    return (2, 3, 1, 0)[dim] if ndim == 4 else dim


def _canonical_data(t):
    """A leaf's data in the canonical layout, without a copy: a 4-D
    float tensor permuted to HWIO, the host step as an int32 scalar."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, np.int32)
    t = t.detach()
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def _dtype_name(t) -> str:
    if not isinstance(t, torch.Tensor):
        return "int32"
    return "float32" if t.is_floating_point() else "int32"


def _tree(ts) -> dict:
    """The canonical tree of a `TrainState`, leaves untouched."""
    opt = ts.opt_state
    return {"params": ts.params, "model_state": ts.model_state,
            "opt_state": {f: getattr(opt, f) for f in opt._fields},
            "step": ts.step}


def _regions(shape: Tuple[int, ...], cdim: int, parts: int, count: int,
             m: int) -> List[Region]:
    """Shard `m`'s regions of a canonical leaf split along `cdim` into
    `parts` blocks, each split into `count` pieces."""
    block = shape[cdim] // parts
    piece = block // count
    out = []
    for b in range(parts):
        start = b * block + m * piece
        out.append(tuple((start, start + piece) if d == cdim else (0, n)
                         for d, n in enumerate(shape)))
    return out


def sharded_state(ts, specs=None, *,
                  place: Optional[Callable[[Any], tuple]] = None,
                  mesh_axes: Optional[dict] = None) -> ShardedState:
    """The `ShardedState` of the port's `TrainState` `ts`. `specs` is a
    TrainState of the same structure whose leaves are `Split`s or None
    (an engine's `state_partition_specs`; None for a replicated state).
    `place(split)` gives a split leaf's (count, index, holders, entry):
    it is sharded `count` ways over its axis (one tree may shard over
    several: EP x TP), this rank holding shard `index` and `holders(m)`
    the ranks holding shard m; `entry` is the mesh axis name (or tuple
    of names) the manifest's spec records. Every rank holds every
    replicated leaf. No collective."""
    # imported here: `training/__init__` re-exports the Trainer, which
    # imports this package (`restore._legacy`)
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )

    world = process_count()
    everyone = tuple(range(world))
    leaves = flatten_tree(_tree(ts))
    splits = flatten_tree(_tree(specs)) if specs is not None else {}
    out = {}
    for path, t in leaves.items():
        data = _canonical_data(t)
        shape = tuple(int(n) for n in data.shape)
        split = splits.get(path)
        if split is None:
            whole = tuple((0, n) for n in shape)
            out[path] = ShardedLeaf(shape, _dtype_name(t), [],
                                    {whole: everyone}, {whole: data})
            continue
        count, index, holders, entry = place(split)
        ndim = len(shape)
        cdim = canonical_dim(split.dim, ndim)
        full = list(shape)
        full[cdim] *= count
        full = tuple(full)
        held = {}
        for m in range(count):
            for region in _regions(full, cdim, split.parts, count, m):
                held[region] = tuple(holders(m))
        mine = _regions(full, cdim, split.parts, count, index)
        spec = [None] * ndim
        spec[cdim] = list(entry) if isinstance(entry, tuple) else entry
        out[path] = ShardedLeaf(
            full, _dtype_name(t), spec, held,
            dict(zip(mine, data.chunk(split.parts, dim=cdim))))
    return ShardedState(out, dict(mesh_axes or {}), world)


def plan_leaf_chunks(leaf: ShardedLeaf) -> List[PlannedChunk]:
    """The GLOBAL chunk plan of one leaf, identical on every rank:
    each region owned by the lowest rank holding it, sorted by start
    offsets so chunk ordinals are stable across ranks and restarts."""
    plan = [PlannedChunk(tuple(a for a, _ in region),
                         tuple(b - a for a, b in region), min(ranks))
            for region, ranks in leaf.holders.items()]
    plan.sort(key=lambda c: c.start)
    return plan


def local_chunk_data(leaf: ShardedLeaf,
                     chunk: PlannedChunk) -> Optional[np.ndarray]:
    """A host copy of a chunk THIS rank owns (None otherwise): the
    snapshot's only transfer. A device tensor is copied with a blocking
    `.to("cpu")`, which waits for the compute stream's writes to it; a
    CPU tensor is copied too, as the engines update their state in
    place and the writer thread must not see the next step's values."""
    if chunk.owner_process != process_index():
        return None
    region = tuple((s, s + n) for s, n in zip(chunk.start, chunk.shape))
    data = leaf.local.get(region)
    if data is None:
        raise RuntimeError(
            f"chunk {region} planned for rank {chunk.owner_process} is not "
            f"held by it (leaf shape {leaf.shape})")
    if isinstance(data, torch.Tensor):
        # One copy (strides kept; np.savez writes any layout in C order).
        return data.to("cpu", copy=True).numpy()
    return np.array(data, copy=True)  # keeps a 0-d leaf 0-d


__all__ = ["PlannedChunk", "ShardedLeaf", "ShardedState", "canonical_dim",
           "local_chunk_data", "plan_leaf_chunks", "port_dim",
           "sharded_state"]
