"""Sharded-checkpoint manifest (port of `checkpointing/manifest.py`): the
JSON source of truth for a save, field for field the reference's, so
either package reads the other's files.

One manifest (`{name}.manifest.json`) describes one committed
checkpoint: for every leaf of the canonical training-state tree (keys
as in the legacy format, `params/...`, `opt_state/mu/...`, `step`), the
GLOBAL shape and dtype, the partition spec it was stored under, and the
chunks that reassemble it, each naming the shard file that holds it
(written by exactly one rank), the npz key inside that file, and its
offsets inside the global array. Plus the mesh factorization the state
was sharded over (axis name -> size), which `training/elastic.py` hands
to a restart.

The manifest is the COMMIT POINT of a save: shard files are written
first (each tmp + renamed), the manifest last (tmp + renamed too), so a
crash anywhere mid-save leaves the previous manifest and the previous
shard files it references, which carry another save id in their names
and are deleted only AFTER the new manifest commits. A manifest that
references a missing shard file therefore means a foreign deletion, and
restore fails loudly.

Plain json / os only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Tuple

FORMAT = "dmpt.sharded.v1"


@dataclasses.dataclass
class Chunk:
    """One contiguous block of one leaf, stored in one shard file."""

    file: int            # index into Manifest.shards
    key: str             # npz key inside that shard file
    start: Tuple[int, ...]
    shape: Tuple[int, ...]

    def as_json(self) -> dict:
        return {
            "file": self.file, "key": self.key,
            "start": list(self.start), "shape": list(self.shape),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Chunk":
        return cls(
            file=int(d["file"]), key=d["key"],
            start=tuple(int(v) for v in d["start"]),
            shape=tuple(int(v) for v in d["shape"]),
        )


@dataclasses.dataclass
class LeafRecord:
    """Global description of one pytree leaf."""

    shape: Tuple[int, ...]
    dtype: str
    spec: list           # the partition spec: None | 'axis' | [axes] a dim
    chunks: List[Chunk]

    def as_json(self) -> dict:
        return {
            "shape": list(self.shape), "dtype": self.dtype,
            "spec": self.spec,
            "chunks": [c.as_json() for c in self.chunks],
        }

    @classmethod
    def from_json(cls, d: dict) -> "LeafRecord":
        return cls(
            shape=tuple(int(v) for v in d["shape"]),
            dtype=d["dtype"],
            spec=d.get("spec", []),
            chunks=[Chunk.from_json(c) for c in d["chunks"]],
        )


@dataclasses.dataclass
class Manifest:
    """One committed sharded checkpoint (module docstring)."""

    save_id: int
    acc: float
    epoch: int
    shards: List[str]               # shard file names, index = Chunk.file
    leaves: Dict[str, LeafRecord]   # path-string -> record
    mesh_axes: Dict[str, int]       # axis name -> size at save time
    process_count: int = 1
    extra: Optional[dict] = None

    def as_json(self) -> dict:
        return {
            "format": FORMAT,
            "save_id": self.save_id,
            "acc": float(self.acc),
            "epoch": int(self.epoch),
            "shards": list(self.shards),
            "mesh": {
                "axes": dict(self.mesh_axes),
                "process_count": int(self.process_count),
            },
            "leaves": {
                k: r.as_json() for k, r in sorted(self.leaves.items())
            },
            **({"extra": self.extra} if self.extra else {}),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Manifest":
        if d.get("format") != FORMAT:
            raise ValueError(
                f"not a sharded-checkpoint manifest (format="
                f"{d.get('format')!r}, expected {FORMAT!r})"
            )
        mesh = d.get("mesh", {})
        return cls(
            save_id=int(d.get("save_id", 0)),
            acc=float(d.get("acc", 0.0)),
            epoch=int(d.get("epoch", 0)),
            shards=list(d["shards"]),
            leaves={
                k: LeafRecord.from_json(r)
                for k, r in d["leaves"].items()
            },
            mesh_axes={
                k: int(v) for k, v in mesh.get("axes", {}).items()
            },
            process_count=int(mesh.get("process_count", 1)),
            extra=d.get("extra"),
        )


def manifest_path(directory: str, name: str = "ckpt") -> str:
    return os.path.join(directory, f"{name}.manifest.json")


def shard_file_name(name: str, save_id: int, process: int) -> str:
    """`{name}.s{save_id}.shard{p}.npz` — the save-id makes shard files
    of successive saves DISTINCT, so renaming a new shard into place can
    never tear the previous manifest's referents (module docstring)."""
    return f"{name}.s{save_id}.shard{process}.npz"


_SHARD_RE_TMPL = r"^{name}\.s(\d+)\.shard(\d+)\.npz$"


def list_shard_files(
    directory: str, name: str
) -> List[Tuple[str, int, int]]:
    """[(filename, save_id, process)] for every shard file of `name`
    present in `directory` (commit state notwithstanding)."""
    pat = re.compile(_SHARD_RE_TMPL.format(name=re.escape(name)))
    out = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    for fname in entries:
        m = pat.match(fname)
        if m:
            out.append((fname, int(m.group(1)), int(m.group(2))))
    return out


def load_manifest(directory: str, name: str = "ckpt") -> Manifest:
    path = manifest_path(directory, name)
    with open(path) as f:
        return Manifest.from_json(json.load(f))


def manifest_exists(directory: str, name: str = "ckpt") -> bool:
    return os.path.isfile(manifest_path(directory, name))


def next_save_id(directory: str, name: str = "ckpt") -> int:
    """Monotonic save counter: previous committed manifest's id + 1 (0
    for a fresh directory). Deterministic across processes reading the
    same shared filesystem — every process derives the same shard file
    names without coordination."""
    try:
        return load_manifest(directory, name).save_id + 1
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return 0


def commit_manifest(directory: str, name: str, manifest: Manifest) -> str:
    """Atomically write the manifest (tmp + rename) — the save's commit
    point. Returns the manifest path."""
    os.makedirs(directory, exist_ok=True)
    path = manifest_path(directory, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest.as_json(), f, indent=1)
    os.replace(tmp, path)
    return path


def gc_stale_shards(
    directory: str, name: str, keep_save_id: int,
    process: Optional[int] = None,
) -> List[str]:
    """Delete shard files of `name` OLDER than the just-committed
    save-id (pass `process` to collect only one process's shard
    index). Strictly older only: a NEWER id belongs to an in-flight
    successor save whose peers may already have renamed their shards —
    collecting those would wedge the successor's peer-shard wait.
    Called only AFTER `commit_manifest` — until then the old files
    back the old manifest. Returns the removed names."""
    removed = []
    for fname, sid, p in list_shard_files(directory, name):
        if sid >= keep_save_id:
            continue
        if process is not None and p != process:
            continue
        try:
            os.remove(os.path.join(directory, fname))
            removed.append(fname)
        except OSError:
            pass  # already collected by a peer / racing cleanup
    return removed


__all__ = [
    "FORMAT",
    "Chunk",
    "LeafRecord",
    "Manifest",
    "commit_manifest",
    "gc_stale_shards",
    "list_shard_files",
    "load_manifest",
    "manifest_exists",
    "manifest_path",
    "next_save_id",
    "shard_file_name",
]
