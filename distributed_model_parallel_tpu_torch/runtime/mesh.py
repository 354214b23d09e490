"""The data, model, seq and stage axes of the mesh (the part of
`runtime/mesh.py` the data-parallel, tensor-parallel, sequence-parallel,
LM and pipeline trainers need).

The reference's mesh names device axes and runs one SPMD program over
them. Here the axes the ported engines use are:

* `data`: how many ranks share the batch and the process group their
  collectives run over. `MeshSpec(data=-1)` resolves to the world size
  of `torch.distributed`. `MeshSpec(dcn=K)` factors it over two fabrics,
  as the reference's ('dcn', 'ici') mesh does: K slices of data / K
  ranks each, slice-major (rank = dcn_index * ici + ici_index). The mesh
  then carries, beside `group` (the whole data axis), `ici_group` (this
  rank's slice) and `dcn_group` (the rank at this rank's ici_index in
  every slice), so the bucketed reducer (`ops/grad_reduction.py`) can
  reduce-scatter inside a slice and all-reduce only the 1/ici shard
  across slices;
* `model`: the tensor-parallel axis (`parallel/tensor_parallel.py`).
  `MeshSpec(data=-1, model=M)` over a world of W ranks is W / M data
  ranks of M model ranks each, laid out data-major with `model`
  innermost, as the reference's `make_mesh` orders its axes: rank =
  data_index * M + model_index, so a model group is M consecutive
  ranks (on one host, NVLink peers). The mesh then carries
  `model_group` (the M ranks of this data index) and `data_group` (the
  D ranks of this model index), and `group` is `data_group`: the data
  axis every engine reduces its gradients over;
* `seq`: the sequence-parallel axis (`parallel/sequence_parallel.py`).
  `MeshSpec(data=-1, seq=S)` over W ranks is W / S data ranks of S
  sequence shards each, data-major with `seq` minor, as the reference
  orders its axes: rank = data_index * S + seq_index (on a factored
  mesh the data index is the (dcn, ici) pair, dcn-major). The mesh then
  carries `seq_group` (the S consecutive ranks of this data index, the
  rings' group) and `group` / `ici_group` / `dcn_group` become the data
  groups of this rank's seq index. `model` > 1 together with `seq` > 1
  is refused: a composed plan lays its axes out on `make_plan_mesh`;
* `expert`: the expert-parallel axis (`parallel/expert_parallel.py`).
  `MeshSpec(data=-1, expert=N)` over W ranks is W / N data ranks of N
  expert ranks each, laid out as the seq axis is, with `expert`
  innermost as in the reference's axis order ('data', 'stage', 'model',
  'seq', 'expert'): rank = data_index * N + expert_index. The mesh then
  carries `expert_group` (the N consecutive ranks of this data index)
  and `group` / `ici_group` / `dcn_group` become the data groups of this
  rank's expert index: the batch shards over the data axes only, so the
  N ranks of an expert group see the same rows (the reference's
  `data_axis_names` excludes 'expert'). `expert` > 1 beside `seq` > 1 is
  refused as the reference's plans refuse it (ep composes with the data
  axis only);
* `model` and `expert` together (EP x TP, the reference's `EXPERT_RULES
  + MEGATRON_RULES` on one program): `MeshSpec(data=-1, model=M,
  expert=E)` over W ranks is W / (M * E) data ranks, in the reference's
  axis order (data, stage, model, seq, expert): rank = (data_index * M +
  model_index) * E + expert_index. The mesh carries `model_group` (the
  M ranks of its (data, expert) index), `expert_group` (the E ranks of
  its (data, model) index) and `group`, the data group of its (model,
  expert) index;
* `stage`: the pipeline's stages, driven by ONE process (as the JAX
  engine's one controller drives every stage through its tick tables).
  The axis is a list of this process's devices; stage s runs on
  `devices[s % len(devices)]`, so on one GPU every stage shares it and on
  a host with S GPUs stage s has its own. A `(data=D, stage=S)` mesh is D
  processes, each running the S-stage pipeline on its own devices.

`make_plan_mesh(pp, dp, sp)` is the other stage axis, the one a composed
plan (`parallel/plan.py`) needs: the reference's stage-major ('stage',
'data', 'seq') mesh over RANKS, rank = (stage * dp + data) * sp + seq,
so that a pipeline stage is a rank of its own next to its seq and data
ranks (`PlanMesh`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Where every other composition of the inner axes lives.
PLAN_WAY = ("a composed plan (parallel/plan.py, --plan) lays its axes out "
            "on runtime/mesh.make_plan_mesh")


_KINDS = {"model": "tensor", "seq": "sequence", "expert": "expert"}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape, the reference's fields; -1 on `data` means
    every rank. `dcn` is the cross-slice factor of the data axis (1 =
    one fabric); it must divide the resolved data size. `model` is the
    tensor-parallel factor, `seq` the sequence-parallel one and `expert`
    the expert-parallel one; their product must divide the world;
    `model` excludes `dcn` > 1, `seq` excludes the other two, and
    `model` composes with `expert` (EP x TP)."""

    data: int = -1
    stage: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    dcn: int = 1

    def resolve(self, world: int) -> int:
        """The data-axis size for a world of `world` ranks: world /
        (model * seq * expert)."""
        if self.stage < 1:
            raise ValueError(f"MeshSpec(stage={self.stage}) must be >= 1")
        if self.model < 1:
            raise ValueError(f"MeshSpec(model={self.model}) must be >= 1")
        if self.seq < 1:
            raise ValueError(f"MeshSpec(seq={self.seq}) must be >= 1")
        if self.expert < 1:
            raise ValueError(f"MeshSpec(expert={self.expert}) must be >= 1")
        inner = [(a, getattr(self, a)) for a in ("model", "seq", "expert")
                 if getattr(self, a) > 1]
        if self.seq > 1 and len(inner) > 1:
            named = ", ".join(f"{a}={n}" for a, n in inner)
            kinds = " and ".join(_KINDS[a] for a, _ in inner)
            raise ValueError(
                f"MeshSpec({named}) composes {kinds} parallelism, which "
                f"MeshSpec does not lay out: {PLAN_WAY}")
        named = ", ".join(f"{a}={n}" for a, n in inner) or "model=1"
        ways = self.model * self.seq * self.expert
        if world % ways:
            raise ValueError(f"MeshSpec({named}) must divide the "
                             f"world ({world} ranks)")
        data = world // ways
        if self.data not in (-1, data):
            raise ValueError(
                f"MeshSpec(data={self.data}, {named}) needs "
                f"{self.data * ways} ranks; the world has {world}")
        if self.dcn < 1:
            raise ValueError(f"dcn must be >= 1, got {self.dcn}")
        if self.dcn > 1 and self.model > 1:
            raise ValueError(
                "dcn > 1 factors the data axis for the hierarchical "
                "reducer; it does not combine with model > 1")
        if data % self.dcn:
            raise ValueError(
                f"dcn={self.dcn} must divide the data axis ({data})")
        return data


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`data` ranks share each batch; their collectives run over
    `group`. `group=None` is one process with no process group (data 1),
    where every collective is the identity. `stage` pipeline stages run
    in this process, stage s on `devices[s % len(devices)]`. With
    `dcn` > 1 the data axis is `dcn` slices of `ici` ranks: `ici_group`
    is this rank's slice and `dcn_group` its peers across slices; with
    `dcn` = 1, `ici_group` is `group` and `dcn_group` is None. With
    `model` > 1 each data index holds `model` ranks: `model_group` is
    this rank's (None when `model` is 1), `data_group` the ranks that
    share its `model_index`, and `group` is `data_group`. With `seq` > 1
    each data index holds `seq` ranks: `seq_group` is this rank's (None
    when `seq` is 1), and `group`, `ici_group` and `dcn_group` are the
    data groups of its `seq_index`. `data_seq_group` holds every rank of
    the data and seq axes (the ones a sequence-parallel engine sums its
    gradients and metrics over); it is `group` when `seq` is 1. With
    `expert` > 1 each data index holds `expert` ranks: `expert_group` is
    this rank's (None when `expert` is 1), and `group`, `ici_group` and
    `dcn_group` are the data groups of its `expert_index`. With both
    `model` and `expert` above 1 (EP x TP), `model_group` is the model
    ranks of this rank's (data, expert) index, `expert_group` the expert
    ranks of its (data, model) index, and `group` the data ranks of its
    (model, expert) index."""

    data: int
    group: Optional[Any]
    stage: int = 1
    devices: Tuple[torch.device, ...] = (torch.device("cpu"),)
    dcn: int = 1
    ici_group: Optional[Any] = None
    dcn_group: Optional[Any] = None
    model: int = 1
    model_group: Optional[Any] = None
    data_index: int = 0
    model_index: int = 0
    seq: int = 1
    seq_group: Optional[Any] = None
    seq_index: int = 0
    data_seq_group: Optional[Any] = None
    expert: int = 1
    expert_group: Optional[Any] = None
    expert_index: int = 0

    def __post_init__(self):
        if self.dcn == 1 and self.ici_group is None:
            object.__setattr__(self, "ici_group", self.group)
        if self.seq == 1 and self.data_seq_group is None:
            object.__setattr__(self, "data_seq_group", self.group)

    @property
    def data_group(self):
        """The data axis's process group (`group`)."""
        return self.group

    @property
    def ici(self) -> int:
        return self.data // self.dcn

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
    stage axis runs on `devices` (default: the CPU). With `spec.dcn` > 1
    every rank creates every slice's and every cross-slice group, in the
    same order (`dist.new_group` is collective over the world), and
    keeps the two it belongs to."""
    spec = spec or MeshSpec()
    devices = tuple(torch.device(d) for d in (devices or ["cpu"]))
    if not dist.is_initialized():
        return Mesh(spec.resolve(1), None, spec.stage, devices)
    world = spec.resolve(dist.get_world_size())
    if spec.model > 1 and spec.expert > 1:
        return _model_expert_mesh(world, spec, devices)
    if spec.model > 1:
        return _model_mesh(world, spec, devices)
    if spec.seq > 1:
        return _inner_mesh(world, spec, devices, "seq")
    if spec.expert > 1:
        return _inner_mesh(world, spec, devices, "expert")
    rank = dist.get_rank()
    if spec.dcn == 1:
        return Mesh(world, dist.group.WORLD, spec.stage, devices,
                    data_index=rank)
    ici = world // spec.dcn
    ici_group = dcn_group = None
    for d in range(spec.dcn):
        g = dist.new_group(list(range(d * ici, (d + 1) * ici)))
        if rank // ici == d:
            ici_group = g
    for j in range(ici):
        g = dist.new_group([d * ici + j for d in range(spec.dcn)])
        if rank % ici == j:
            dcn_group = g
    return Mesh(world, dist.group.WORLD, spec.stage, devices, spec.dcn,
                ici_group, dcn_group, data_index=rank)


def local_mesh(**axes: int) -> Mesh:
    """Convenience: `make_mesh(MeshSpec(**axes))`, e.g. `local_mesh(seq=2)`
    (an unspecified `data` absorbs the remaining ranks)."""
    return make_mesh(MeshSpec(**axes))


def _model_mesh(data: int, spec: MeshSpec, devices) -> Mesh:
    """A (data, model) mesh, rank = data_index * model + model_index:
    every rank creates every model group and then every data group, in
    the same order (`dist.new_group` is collective over the world), and
    keeps the two it belongs to."""
    m = spec.model
    rank = dist.get_rank()
    model_group = data_group = None
    for d in range(data):
        g = dist.new_group(list(range(d * m, (d + 1) * m)))
        if rank // m == d:
            model_group = g
    for j in range(m):
        g = dist.new_group([d * m + j for d in range(data)])
        if rank % m == j:
            data_group = g
    return Mesh(data, data_group, spec.stage, devices, model=m,
                model_group=model_group, data_index=rank // m,
                model_index=rank % m)


def _model_expert_mesh(data: int, spec: MeshSpec, devices) -> Mesh:
    """A (data, model, expert) mesh, rank = (data_index * model +
    model_index) * expert + expert_index: every rank creates every model
    group, every expert group and every data group, in that order
    (`dist.new_group` is collective over the world), and keeps the three
    it belongs to."""
    m, e = spec.model, spec.expert
    rank = dist.get_rank()
    d_idx, rest = divmod(rank, m * e)
    m_idx, e_idx = divmod(rest, e)

    def at(d, j, i):
        return (d * m + j) * e + i

    model_group = expert_group = data_group = None
    for d in range(data):
        for i in range(e):
            g = dist.new_group([at(d, j, i) for j in range(m)])
            if (d, i) == (d_idx, e_idx):
                model_group = g
    for d in range(data):
        for j in range(m):
            g = dist.new_group([at(d, j, i) for i in range(e)])
            if (d, j) == (d_idx, m_idx):
                expert_group = g
    for j in range(m):
        for i in range(e):
            g = dist.new_group([at(d, j, i) for d in range(data)])
            if (j, i) == (m_idx, e_idx):
                data_group = g
    return Mesh(data, data_group, spec.stage, devices, model=m,
                model_group=model_group, data_index=d_idx,
                model_index=m_idx, expert=e, expert_group=expert_group,
                expert_index=e_idx)


def _inner_mesh(data: int, spec: MeshSpec, devices, axis: str) -> Mesh:
    """A (data, seq) or (data, expert) mesh, `axis` the inner one: rank =
    data_index * ways + inner_index, the data index dcn-major on a
    factored mesh. Every rank creates every inner group, then for each
    inner index its data group, its slices and its cross-slice groups,
    in the same order (`dist.new_group` is collective over the world),
    and keeps the ones it belongs to. The mesh's ranks are 0 .. data *
    ways - 1, the whole world (`resolve`), so a (data, seq) mesh's data
    x seq group is the world's."""
    ways, dcn = getattr(spec, axis), spec.dcn
    ici = data // dcn
    rank = dist.get_rank()
    d_idx, i_idx = divmod(rank, ways)
    inner_group = data_group = ici_group = dcn_group = None
    for d in range(data):
        g = dist.new_group([d * ways + i for i in range(ways)])
        if d == d_idx:
            inner_group = g
    for i in range(ways):
        g = dist.new_group([d * ways + i for d in range(data)])
        if i == i_idx:
            data_group = g
        if dcn == 1:
            continue
        for k in range(dcn):
            g = dist.new_group([(k * ici + j) * ways + i
                                for j in range(ici)])
            if i == i_idx and d_idx // ici == k:
                ici_group = g
        for j in range(ici):
            g = dist.new_group([(k * ici + j) * ways + i
                                for k in range(dcn)])
            if i == i_idx and d_idx % ici == j:
                dcn_group = g
    if axis == "expert":
        return Mesh(data, data_group, spec.stage, devices, dcn, ici_group,
                    dcn_group, data_index=d_idx, expert=ways,
                    expert_group=inner_group, expert_index=i_idx)
    return Mesh(data, data_group, spec.stage, devices, dcn, ici_group,
                dcn_group, data_index=d_idx, seq=ways,
                seq_group=inner_group, seq_index=i_idx,
                data_seq_group=dist.group.WORLD)


@dataclasses.dataclass(frozen=True)
class PlanMesh:
    """The stage-major ('stage', 'data', 'seq') mesh of a composed plan,
    over ranks: `ranks[(stage * data + d) * seq + q]` is the global rank
    at (stage, d, q). This rank sits at (`stage_index`, `data_index`,
    `seq_index`) and computes on `device`. Its groups (None where the
    group would hold this rank alone, and every collective over it is the
    identity):

    * `seq_group`: the seq ranks of its (stage, data), the rings' group;
    * `group` (`data_group`): the data ranks of its (stage, seq), the
      FSDP gathers' group;
    * `data_seq_group`: every rank of its stage, the group of the plan's
      fused gradient reduction (its stage does not span the world, so
      this is not the world's group);
    * `plan_group`: every rank of the plan (the metric sums).

    `stage_ranks` is its column, the global rank of each stage at its
    (data, seq): the ranks its stage wire talks to."""

    stage: int
    data: int
    seq: int
    ranks: Tuple[int, ...]
    device: torch.device
    stage_index: int = 0
    data_index: int = 0
    seq_index: int = 0
    seq_group: Optional[Any] = None
    group: Optional[Any] = None
    data_seq_group: Optional[Any] = None
    plan_group: Optional[Any] = None
    stage_ranks: Tuple[int, ...] = (0,)

    @property
    def data_group(self):
        return self.group

    @property
    def size(self) -> int:
        return self.stage * self.data * self.seq

    def rank_of(self, stage: int, data: int, seq: int) -> int:
        """The global rank at (stage, data, seq)."""
        return self.ranks[(stage * self.data + data) * self.seq + seq]

    def stage_holders(self, stage: int, data: Optional[int] = None
                      ) -> Tuple[int, ...]:
        """The global ranks of `stage` (of its data index `data` only,
        when given), in rank order."""
        ds = range(self.data) if data is None else (data,)
        return tuple(self.rank_of(stage, d, q) for d in ds
                     for q in range(self.seq))


def make_plan_mesh(pp: int, dp: int, sp: int, device="cuda",
                   ranks: Optional[Sequence[int]] = None) -> PlanMesh:
    """The reference's `make_plan_mesh` over ranks (`PlanMesh`): the plan
    occupies `ranks` (default: the world's first pp * dp * sp ranks),
    stage-major, each rank computing on `device` (default: its current
    CUDA device; "cpu" only when asked). Every rank of the world creates
    every group of the mesh in the same order (`dist.new_group` is
    collective over the world), so a rank outside `ranks` calls it too
    and gets a mesh whose `stage_index` is -1. Without a process group
    the plan is one rank."""
    for name, ways in (("pp", pp), ("dp", dp), ("sp", sp)):
        if ways < 1:
            raise ValueError(f"make_plan_mesh: {name}={ways} must be >= 1")
    n = pp * dp * sp
    device = torch.device(device)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a plan of {n} ranks needs a process group "
                             "of at least that many ranks")
        return PlanMesh(1, 1, 1, (0,), device)
    world = dist.get_world_size()
    ranks = tuple(range(n) if ranks is None else ranks)
    if len(ranks) != n or len(set(ranks)) != n or \
            not all(0 <= r < world for r in ranks):
        raise ValueError(f"a {pp} x {dp} x {sp} plan needs {n} distinct "
                         f"ranks of the world of {world}, got {ranks}")
    me = dist.get_rank()
    pos = ranks.index(me) if me in ranks else -1
    s_idx, rest = divmod(pos, dp * sp) if pos >= 0 else (-1, 0)
    d_idx, q_idx = divmod(rest, sp) if pos >= 0 else (-1, -1)

    def at(s, d, q):
        return ranks[(s * dp + d) * sp + q]

    def group(members):
        g = dist.new_group(list(members)) if len(members) > 1 else None
        return g if me in members else None

    seq_group = data_group = data_seq_group = None
    for s in range(pp):
        for d in range(dp):
            g = group([at(s, d, q) for q in range(sp)])
            if (s, d) == (s_idx, d_idx):
                seq_group = g
    for s in range(pp):
        for q in range(sp):
            g = group([at(s, d, q) for d in range(dp)])
            if (s, q) == (s_idx, q_idx):
                data_group = g
    for s in range(pp):
        g = group([at(s, d, q) for d in range(dp) for q in range(sp)])
        if s == s_idx:
            data_seq_group = g
    plan_group = group(list(ranks))
    column = (tuple(at(s, d_idx, q_idx) for s in range(pp)) if pos >= 0
              else ())
    return PlanMesh(pp, dp, sp, ranks, device, s_idx, d_idx, q_idx,
                    seq_group, data_group, data_seq_group, plan_group,
                    column)


def data_axis_names(mesh: Mesh) -> Tuple[str, ...]:
    """The reference's names of the data axes: ('dcn', 'ici') on a
    factored mesh, ('data',) otherwise."""
    return ("dcn", "ici") if mesh.dcn > 1 else ("data",)


def data_axis_size(mesh: Mesh) -> int:
    """Total data-parallel ways (the product over the data axes)."""
    return mesh.data


def mesh_axes(mesh: Mesh) -> dict:
    """The reference's `{axis name: size}` record of the mesh, in its
    axis order (`data`, or `dcn` and `ici` on a factored mesh, then
    `stage`, `model`, `seq`, `expert`; a plan mesh's ('stage', 'data',
    'seq')): what a sharded checkpoint's manifest stores and
    `training/elastic.py` hands to a restart."""
    if isinstance(mesh, PlanMesh):
        return {"stage": mesh.stage, "data": mesh.data, "seq": mesh.seq}
    data = ({"dcn": mesh.dcn, "ici": mesh.ici} if mesh.dcn > 1
            else {"data": mesh.data})
    return {**data, "stage": mesh.stage, "model": mesh.model,
            "seq": mesh.seq, "expert": mesh.expert}


def data_hierarchy_axes(mesh: Mesh):
    """(group, ici_group, dcn_group) for gradient-reduction wiring: the
    whole data axis for fused collectives, the intra-slice group the
    bucket halves run over, and the cross-slice group for the 1/ici
    shard (None on a one-fabric mesh). The reference returns axis names;
    here the axes are process groups."""
    return mesh.group, mesh.ici_group, mesh.dcn_group


__all__ = ["Mesh", "MeshSpec", "PLAN_WAY", "PlanMesh",
           "data_axis_names", "data_axis_size", "data_hierarchy_axes",
           "local_devices", "local_mesh", "make_mesh", "make_plan_mesh",
           "mesh_axes"]
