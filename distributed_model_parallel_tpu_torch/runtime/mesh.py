"""The data-parallel world (the part of `runtime/mesh.py` the
data-parallel trainer needs).

The reference's mesh names device axes; the port's data-parallel
engines need only the data axis: how many ranks share the batch and the
process group their collectives run over. `MeshSpec(data=-1)` resolves
to the world size of `torch.distributed`. The other axes belong to
later slices and are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist

# Later port slices (ROADMAP.md), named by the refusals below.
AXIS_SLICES = {
    "dcn": "the gradient-reduction slice",
    "model": "the tensor-parallel slice",
    "stage": "the pipeline slice",
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
        if self.data not in (-1, world):
            raise ValueError(f"MeshSpec(data={self.data}) needs {self.data} "
                             f"ranks; the world has {world}")
        return world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`data` ranks share each batch; their collectives run over
    `group`. `group=None` is one process with no process group (data 1),
    where every collective is the identity."""

    data: int
    group: Optional[Any]


def make_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """The data-parallel world of this process: the default process
    group when `torch.distributed` is initialized, else one process."""
    spec = spec or MeshSpec()
    if not dist.is_initialized():
        return Mesh(spec.resolve(1), None)
    return Mesh(spec.resolve(dist.get_world_size()), dist.group.WORLD)


__all__ = ["AXIS_SLICES", "Mesh", "MeshSpec", "make_mesh"]
