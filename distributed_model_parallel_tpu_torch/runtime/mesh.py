"""The data and stage axes of the mesh (the part of `runtime/mesh.py` the
data-parallel and pipeline trainers need).

The reference's mesh names device axes and runs one SPMD program over
them. Here the two axes the ported engines use are:

* `data`: how many ranks share the batch and the process group their
  collectives run over. `MeshSpec(data=-1)` resolves to the world size
  of `torch.distributed`;
* `stage`: the pipeline's stages, driven by ONE process (as the JAX
  engine's one controller drives every stage through its tick tables).
  The axis is a list of this process's devices; stage s runs on
  `devices[s % len(devices)]`, so on one GPU every stage shares it and on
  a host with S GPUs stage s has its own. A `(data=D, stage=S)` mesh is D
  processes, each running the S-stage pipeline on its own devices.

The other axes belong to later slices and are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Later port slices (ROADMAP.md), named by the refusals below.
AXIS_SLICES = {
    "dcn": "the gradient-reduction slice",
    "model": "the tensor-parallel slice",
    "seq": "the sequence-parallel slice",
    "expert": "the expert-parallel slice",
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape, the reference's fields; -1 on `data` means
    every rank."""

    data: int = -1
    stage: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    dcn: int = 1

    def resolve(self, world: int) -> int:
        """The data-axis size for a world of `world` ranks."""
        for axis, later in AXIS_SLICES.items():
            if getattr(self, axis) != 1:
                raise ValueError(
                    f"MeshSpec.{axis}={getattr(self, axis)} is not ported "
                    f"to the PyTorch package yet: it belongs to {later} "
                    "(ROADMAP.md)"
                )
        if self.stage < 1:
            raise ValueError(f"MeshSpec(stage={self.stage}) must be >= 1")
        if self.data not in (-1, world):
            raise ValueError(f"MeshSpec(data={self.data}) needs {self.data} "
                             f"ranks; the world has {world}")
        return world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`data` ranks share each batch; their collectives run over
    `group`. `group=None` is one process with no process group (data 1),
    where every collective is the identity. `stage` pipeline stages run
    in this process, stage s on `devices[s % len(devices)]`."""

    data: int
    group: Optional[Any]
    stage: int = 1
    devices: Tuple[torch.device, ...] = (torch.device("cpu"),)

    def stage_device(self, s: int) -> torch.device:
        return self.devices[s % len(self.devices)]


def local_devices(kind: str = "cuda") -> Tuple[torch.device, ...]:
    """This process's devices of `kind`: the CPU; or every GPU when the
    process is alone in its world, else the rank's own GPU."""
    if kind == "cpu":
        return (torch.device("cpu"),)
    if dist.is_initialized() and dist.get_world_size() > 1:
        return (torch.device("cuda", torch.cuda.current_device()),)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The mesh of this process: the data axis is the default process
    group when `torch.distributed` is initialized, else one process; the
    stage axis runs on `devices` (default: the CPU)."""
    spec = spec or MeshSpec()
    devices = tuple(torch.device(d) for d in (devices or ["cpu"]))
    if not dist.is_initialized():
        return Mesh(spec.resolve(1), None, spec.stage, devices)
    return Mesh(spec.resolve(dist.get_world_size()), dist.group.WORLD,
                spec.stage, devices)


__all__ = ["AXIS_SLICES", "Mesh", "MeshSpec", "local_devices", "make_mesh"]
