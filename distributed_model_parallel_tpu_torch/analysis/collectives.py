"""Classify every recorded collective against the mesh (port of
`analysis/collectives.py`).

Each record's ranks are mapped back through the mesh to the AXES they
cross, so a rule can say "no grad-sized all-reduce over 'dcn'" instead
of counting calls. `MeshModel` holds the axis names and sizes and each
global rank's coordinates; it is built from the port's meshes
(`runtime/mesh.Mesh`: data (or dcn and ici), model, seq, expert, in the
reference's axis order; `PlanMesh`: stage, data, seq), or directly from
a coordinate table (the rule tests).

Ring against monolithic is structural, as in the reference: a send or a
receive is ring traffic (the permutation hops of `ops/wire_codec`'s
batched isend / irecv that every ring of the port rides); all_reduce,
all_gather, reduce_scatter and all_to_all are the monolithic forms.
Where gloo stages a CUDA tensor through the host (`ops/wire_codec.
host_staged`), the call is the same collective on a host copy, so the
record is the logical one: the lint judges the program a card runs on
NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from distributed_model_parallel_tpu_torch.analysis.record import Record


@dataclasses.dataclass(frozen=True)
class MeshModel:
    """The linter's view of a mesh of ranks: axis names / sizes and the
    global rank -> coordinates map."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Dict[int, Tuple[int, ...]]

    @classmethod
    def from_axes(cls, axes: Sequence[Tuple[str, int]],
                  ranks: Optional[Sequence[int]] = None) -> "MeshModel":
        """Row-major ranks over `axes` ((name, size), ... outermost
        first); `ranks[i]` is the global rank of the i-th position
        (default: i)."""
        names = tuple(a for a, _ in axes)
        shape = tuple(int(n) for _, n in axes)
        coords = {}
        total = 1
        for n in shape:
            total *= n
        for i in range(total):
            idx, rest = [], i
            for n in reversed(shape):
                rest, c = divmod(rest, n)
                idx.append(c)
            coords[int(ranks[i]) if ranks is not None else i] = \
                tuple(reversed(idx))
        return cls(names, shape, coords)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshModel":
        """The model of a port mesh (module docstring). A `Mesh` over a
        process group lays its ranks out data-major (the data index
        dcn-major on a factored mesh), then model, seq and expert; its
        `stage` axis lives inside each process and crosses no rank."""
        from distributed_model_parallel_tpu_torch.runtime.mesh import (
            PlanMesh,
        )

        if isinstance(mesh, PlanMesh):
            return cls.from_axes((("stage", mesh.stage),
                                  ("data", mesh.data),
                                  ("seq", mesh.seq)), mesh.ranks)
        data = ((("dcn", mesh.dcn), ("ici", mesh.ici)) if mesh.dcn > 1
                else (("data", mesh.data),))
        inner = tuple((a, getattr(mesh, a)) for a in ("model", "seq",
                                                      "expert"))
        return cls.from_axes(data + inner)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axes_of_ids(self, ids: Sequence[int]) -> Optional[FrozenSet[str]]:
        """Axes on which the given ranks differ; None when a rank is not
        on the mesh (the conservative 'cannot classify' answer)."""
        cs = []
        for i in ids:
            c = self.coords.get(int(i))
            if c is None:
                return None
            cs.append(c)
        crossed = set()
        for c in cs[1:]:
            for d, (a, b) in enumerate(zip(cs[0], c)):
                if a != b:
                    crossed.add(self.axis_names[d])
        return frozenset(crossed)


@dataclasses.dataclass(frozen=True)
class ClassifiedCollective:
    """One recorded collective with its contract-relevant facts."""

    record: Record
    kind: str
    axes: Optional[FrozenSet[str]]
    payload_bytes: int
    is_ring_hop: bool

    @property
    def name(self) -> str:
        r = self.record
        return f"#{r.seq} {r.op}" + (f" [{r.scope}]" if r.scope else "")

    @property
    def scope(self) -> str:
        return self.record.scope

    @property
    def dtype(self) -> str:
        return self.record.dtype

    @property
    def elems(self) -> int:
        return self.record.elems

    @property
    def is_scalar(self) -> bool:
        """One element, or a packed vector of metric sums (the port sums
        a step's metrics in one call where the reference psums scalars
        one by one)."""
        import re

        return self.record.elems <= 1 or bool(
            re.search(r"\bmetrics\b", self.record.scope))

    @property
    def is_send(self) -> bool:
        return self.record.op == "send"

    def crosses(self, axis: Optional[str]) -> bool:
        """True when this collective spans `axis`; unknown membership
        answers True (a fabric rule must not be dodged by a rank the
        mesh does not know)."""
        if axis is None:
            return False
        if self.axes is None:
            return True
        return axis in self.axes


def classify_record(rec: Record, mesh: MeshModel) -> ClassifiedCollective:
    axes = mesh.axes_of_ids(rec.ranks) if len(rec.ranks) > 1 \
        else frozenset()
    return ClassifiedCollective(rec, rec.op, axes, rec.nbytes, rec.is_hop)


def classify(records: Sequence[Record], mesh: MeshModel
             ) -> List[ClassifiedCollective]:
    """Every recorded collective, classified, in issue order."""
    return [classify_record(r, mesh) for r in records]


def ring_sends_over(collectives: Sequence[ClassifiedCollective],
                    axis: str) -> List[ClassifiedCollective]:
    """The ring traffic on one fabric: the sends whose pair differs on
    `axis` alone (a hop that also crosses another axis belongs to
    another wire, such as a pipeline's stage hops). One send is one
    permutation hop of this rank."""
    return [c for c in collectives
            if c.is_send and c.axes is not None and c.axes == {axis}]


def monolithic_over(collectives: Sequence[ClassifiedCollective], axis: str,
                    kinds: Tuple[str, ...] = ("all_gather", "reduce_scatter")
                    ) -> List[ClassifiedCollective]:
    """Monolithic collectives of `kinds` crossing `axis`: what a
    latency-hiding ring must have replaced."""
    return [c for c in collectives if c.kind in kinds and c.crosses(axis)]


def nonscalar_all_reduces(collectives: Sequence[ClassifiedCollective]
                          ) -> List[ClassifiedCollective]:
    return [c for c in collectives
            if c.kind == "all_reduce" and not c.is_scalar]


__all__ = ["ClassifiedCollective", "MeshModel", "classify",
           "classify_record", "monolithic_over", "nonscalar_all_reduces",
           "ring_sends_over"]
