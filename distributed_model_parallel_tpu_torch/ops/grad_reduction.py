"""Bucketed, hierarchy-aware gradient reduction (port of
`ops/grad_reduction.py`): PyTorch DDP's C++ `Reducer` rebuilt over
`torch.distributed` process groups.

The reference repo dissects the Reducer: gradients packed into ~25 MB
flat buckets in REVERSE registration order (backprop produces the late
layers' gradients first, so their buckets fill and launch first), each
bucket's ring all-reduce fired while the backward still runs, and the
reduction made hierarchical across fabrics. This module keeps the JAX
package's structure and names:

* `plan_buckets(leaves, bucket_mb)`: the bucket assignment. Leaves in
  reverse `tree_leaves` order (the reference's `tree_flatten` order),
  grouped by dtype, a new bucket when the running bytes would pass
  `bucket_mb` MiB, an oversized leaf alone. Shape-level, slot for slot
  the JAX plan.
* `ring_reduce_scatter` / `ring_all_gather`: a bucket's two halves over
  the intra-slice group. The reference spells them as explicit ppermute
  rings so that XLA can interleave the hops with the backward; NCCL's
  reduce-scatter and all-gather are rings already, so they are
  `dist.reduce_scatter_tensor` / `dist.all_gather_into_tensor`, issued
  asynchronously. The chunk layout is the reference's: rank i keeps
  chunk i, and the gather puts chunk j at offset j*n/S.
* `compressed_dcn_psum`: the cross-slice all-reduce of a 1/ici shard
  with its payload compressed (`ops/wire_codec.py`) and its sums not.
* `reduce_bucket_flat`: reduce-scatter over 'ici', all-reduce of the
  shard over 'dcn' (compressed or not), all-gather over 'ici'.
* `Reducer`: issues every bucket of a gradient tree (all of them, or one
  stage's from the stagewise backward's hook) without waiting, and
  returns a `PendingReduction` whose `wait` unpacks the reduced
  buckets into a tree. On the card each bucket's chain runs on the
  reducer's own stream, forked from and joined back into the compute
  stream, so the collectives are in flight while the host issues the
  next stage's backward, and the step stays capturable in a CUDA graph.
  A gloo group's buckets of CUDA gradients reduce on the host (gloo
  carries no CUDA tensor in these collectives): copied out, reduced,
  copied back. `bucketed_psum` / `bucketed_pmean` are the reference's
  synchronous entry points over it.
* `data_replica_index`: this rank's index over the factored data axes,
  dcn-major (the global rank).

Uneven tails are zero-padded to `bucket_pad_multiple` and dropped on
unpack; integer leaves are refused. A group of None is one process:
every collective is the identity and none is issued.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.analysis import record
from distributed_model_parallel_tpu_torch.analysis.record import scope
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    coded_all_gather,
    coded_all_to_all,
    require_dcn_axis,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_like,
)

# bucket_mb of "one flat bucket per dtype": the engines route
# grad_reduction="monolithic" + dcn_compression through the bucket path
# with this cap, so the cross-slice hop has a seam to compress.
MONOLITHIC_BUCKET_MB = math.inf


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def bucket_pad_multiple(ici_size: int, dcn_size: int,
                        dcn_compression: str = "none") -> int:
    """Element multiple a bucket's flat buffer is zero-padded to: the
    intra-slice group size, times the cross-slice size when the 'dcn'
    hop is compressed (it re-chunks the 1/ici shard over K peers)."""
    if dcn_compression != "none" and dcn_size > 1:
        return ici_size * dcn_size
    return ici_size


@dataclasses.dataclass(frozen=True)
class BucketSlot:
    """One gradient leaf's slice of a flat bucket buffer."""

    index: int  # position in the `tree_leaves` list
    offset: int  # start element inside the bucket's flat buffer
    size: int  # element count
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A dtype-homogeneous flat-buffer bucket; `size` is the unpadded
    element count."""

    dtype: Any
    slots: Tuple[BucketSlot, ...]
    size: int


def plan_buckets(leaves: Sequence[Any], bucket_mb: float = 25.0):
    """Assign gradient leaves (anything with .shape and a torch .dtype)
    to flat-buffer buckets: reverse order, grouped by dtype, a new bucket
    when the running bytes would pass `bucket_mb` MiB, an oversized leaf
    in a bucket of its own."""
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    cap_bytes = bucket_mb * (1 << 20)
    buckets: List[Bucket] = []
    open_slots: dict = {}
    open_elems: dict = {}

    def close(dt):
        slots = open_slots.pop(dt, [])
        if slots:
            buckets.append(Bucket(dt, tuple(slots), open_elems.pop(dt)))

    for index in reversed(range(len(leaves))):
        leaf = leaves[index]
        dt = leaf.dtype
        if not dt.is_floating_point:
            raise TypeError(
                f"plan_buckets: leaf {index} has non-floating dtype "
                f"{dt}; gradient pytrees are floating point"
            )
        size = int(math.prod(leaf.shape)) if len(leaf.shape) else 1
        have = open_elems.get(dt, 0)
        if have and (have + size) * dt.itemsize > cap_bytes:
            close(dt)
            have = 0
        open_slots.setdefault(dt, []).append(
            BucketSlot(index, have, size, tuple(leaf.shape)))
        open_elems[dt] = have + size
    for dt in list(open_slots):
        close(dt)
    return buckets


# ------------------------------------------------------ the two halves


def ring_reduce_scatter(x: torch.Tensor, group, *, async_op: bool = False):
    """Reduce-scatter a flat (n,) vector over `group`: rank i gets the
    sum of every rank's chunk i, (n/S,). n must divide by the group
    size. With `async_op`, returns (chunk, work)."""
    if group is None:
        return (x, None) if async_op else x
    size = dist.get_world_size(group)
    n = x.shape[0]
    if n % size:
        raise ValueError(
            f"ring_reduce_scatter: length {n} not divisible by the "
            f"group size {size}")
    out = x.new_empty((n // size,))
    work = dist.reduce_scatter_tensor(out, x, group=group,
                                      async_op=async_op)
    return (out, work) if async_op else out


def ring_all_gather(x: torch.Tensor, group, *, async_op: bool = False):
    """All-gather a flat (m,) shard over `group`: the (S*m,)
    concatenation in rank order, the inverse of `ring_reduce_scatter`'s
    layout. With `async_op`, returns (gathered, work)."""
    if group is None:
        return (x, None) if async_op else x
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],))
    work = dist.all_gather_into_tensor(out, x, group=group,
                                       async_op=async_op)
    return (out, work) if async_op else out


# ------------------------------------------------- bucketed reduction


def compressed_dcn_psum(shard: torch.Tensor, dcn_group,
                        wire: str) -> torch.Tensor:
    """All-reduce a 1/ici shard over the K cross-slice peers with the
    payload compressed and the sums in the shard's dtype (int8 never
    sums in int8). One `all_to_all` delivers every peer's encoded copy
    of this rank's 1/K sub-chunk; they are decoded and added in the
    reference's order (own chunk, then from rank i-1, i-2, ...). The
    reduced sub-chunk is encoded once and all-gathered; this rank keeps
    its own sub-chunk unencoded, as the reference does. Error an
    element: <= (K+1)·absmax/254 of the f32 sum for int8. The shard
    length must divide by K (`bucket_pad_multiple`)."""
    k = _size(dcn_group)
    if k == 1:
        return shard
    n = shard.shape[0]
    if n % k:
        raise ValueError(
            f"compressed_dcn_psum: shard length {n} not divisible by "
            f"the 'dcn' group size {k} (pad the bucket to "
            "bucket_pad_multiple elements)"
        )
    i = dist.get_rank(dcn_group)
    chunks = shard.view(k, n // k)
    recv = coded_all_to_all(chunks, dcn_group, wire)
    acc = chunks[i]
    for r in range(1, k):
        acc = acc + recv[(i - r) % k]
    out = coded_all_gather(acc, dcn_group, wire)
    out[i] = acc
    return out.reshape(n)


def _dcn_collectives(wire: str) -> int:
    """Collectives one cross-slice hop issues: the all-reduce, or the
    payload all-to-all and all-gather (and their int8 scales)."""
    return {"none": 1, "bf16": 2, "int8": 4}[wire]


def _reduce_chain(flat, ici_group, dcn_group, wire):
    """Issue `reduce_bucket_flat`'s collectives; returns (gathered,
    the last work or None). Each half waits for the one before it: gloo
    may run one group's collectives on several threads at once, and
    NCCL orders another group's only through a stream wait."""
    with scope("bucket_ring"):
        shard, work = ring_reduce_scatter(flat, ici_group, async_op=True)
    if dcn_group is not None:
        if work is not None:
            work.wait()
        if wire != "none":
            shard = compressed_dcn_psum(shard, dcn_group, wire)
        else:
            dist.all_reduce(shard, group=dcn_group)
    elif work is not None:
        work.wait()
    with scope("bucket_ring"):
        return ring_all_gather(shard, ici_group, async_op=True)


def reduce_bucket_flat(flat: torch.Tensor, ici_group, dcn_group=None,
                       dcn_compression: str = "none") -> torch.Tensor:
    """Hierarchically all-reduce one flat bucket (already padded to
    `bucket_pad_multiple`): reduce-scatter over the slice, all-reduce of
    the 1/ici shard across slices (compressed when `dcn_compression`
    says so), all-gather back over the slice. With `dcn_group=None` the
    two halves run over the one fabric."""
    out, work = _reduce_chain(flat, ici_group, dcn_group, dcn_compression)
    if work is not None:
        work.wait()
    return out


@dataclasses.dataclass
class PendingReduction:
    """The buckets of one `Reducer.issue` in flight; `wait` returns the
    reduced tree. `collectives` counts the collectives issued: two a
    bucket, plus the cross-slice hop's."""

    tree: Any
    n_leaves: int
    # (Bucket, packed flat, gathered flat, work or None). The packed
    # buffer is held until `wait`: it was allocated on the compute
    # stream, and freed earlier the allocator would hand it to the next
    # bucket's packing while the reducer's stream may still read it.
    buckets: list
    stream: Optional[Any]
    scale: Optional[float]
    collectives: int

    def wait(self):
        """Join the collectives into the current stream and unpack the
        buckets into a tree shaped like the issued one."""
        if record.ON:
            record.note("reduce_wait")
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)
        out: list = [None] * self.n_leaves
        for bucket, _, reduced, work in self.buckets:
            if work is not None:
                work.wait()
            if self.scale is not None:
                reduced = reduced * self.scale
            for s in bucket.slots:
                out[s.index] = reduced[s.offset:s.offset + s.size].view(
                    s.shape)
        self.buckets = []  # the flat buffers go with the tree
        return tree_like(self.tree, iter(out))


class Reducer:
    """DDP's Reducer over a mesh's (ici, dcn) groups: `issue(grads)`
    plans the tree's buckets, packs each into a flat buffer and issues
    its reduction without waiting (`reduce_bucket_flat`'s chain);
    `PendingReduction.wait` joins and unpacks. `mean=True` multiplies by
    1 / (ici * dcn ranks), as the reference's `bucketed_pmean` does."""

    def __init__(self, ici_group, dcn_group=None, *, bucket_mb: float = 25.0,
                 dcn_compression: str = "none"):
        self.wire = require_dcn_axis(dcn_compression, dcn_group)
        self.ici_group = ici_group
        self.dcn_group = dcn_group
        self.bucket_mb = bucket_mb
        self.pad_multiple = bucket_pad_multiple(
            _size(ici_group), _size(dcn_group), self.wire)
        self.denom = _size(ici_group) * _size(dcn_group)
        self._stream = None
        # gloo carries no CUDA tensor in a reduce-scatter, all-gather or
        # all-to-all: on the card a gloo group's buckets reduce on the host
        self._gloo = any(g is not None and dist.get_backend(g) == "gloo"
                         for g in (ici_group, dcn_group))

    def _stream_for(self, device: torch.device):
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def issue(self, grads, *, mean: bool = False) -> PendingReduction:
        leaves = list(tree_leaves(grads))
        stream = None
        staged = bool(leaves) and leaves[0].is_cuda and self._gloo
        if leaves and leaves[0].is_cuda and self.ici_group is not None \
                and not staged:
            stream = self._stream_for(leaves[0].device)
        per_bucket = 2 * (self.ici_group is not None) + (
            _dcn_collectives(self.wire) if self.dcn_group is not None
            else 0)
        issued = []
        for bucket in plan_buckets(leaves, self.bucket_mb):
            flat = torch.cat([leaves[s.index].reshape(-1)
                              for s in bucket.slots])
            pad = -flat.shape[0] % self.pad_multiple
            if pad:
                flat = torch.cat([flat, flat.new_zeros((pad,))])
            if staged:
                out, work = _reduce_chain(flat.cpu(), self.ici_group,
                                          self.dcn_group, self.wire)
                if work is not None:
                    work.wait()
                out, work = out.to(flat.device), None
            elif stream is None:
                out, work = _reduce_chain(flat, self.ici_group,
                                          self.dcn_group, self.wire)
            else:
                stream.wait_stream(torch.cuda.current_stream(flat.device))
                with torch.cuda.stream(stream):
                    out, work = _reduce_chain(flat, self.ici_group,
                                              self.dcn_group, self.wire)
            issued.append((bucket, flat, out, work))
        return PendingReduction(grads, len(leaves), issued, stream,
                                1.0 / self.denom if mean else None,
                                per_bucket * len(issued))


def bucketed_psum(grads, ici_group, dcn_group=None, *,
                  bucket_mb: float = 25.0, mean: bool = False,
                  dcn_compression: str = "none"):
    """Sum (or mean) a gradient tree over the data fabric(s) through
    dtype-grouped flat buckets, each reduced hierarchically; equal to
    one all-reduce of the tree up to summation order (exactly, without
    compression), within the codec's budget with it."""
    return Reducer(ici_group, dcn_group, bucket_mb=bucket_mb,
                   dcn_compression=dcn_compression).issue(
                       grads, mean=mean).wait()


def bucketed_pmean(grads, ici_group, dcn_group=None, *,
                   bucket_mb: float = 25.0, dcn_compression: str = "none"):
    """The mean over the data ranks of a gradient tree, bucketed and
    hierarchy-aware: the drop-in for `DDPEngine`'s one all-reduce."""
    return bucketed_psum(grads, ici_group, dcn_group, bucket_mb=bucket_mb,
                         mean=True, dcn_compression=dcn_compression)


def data_replica_index(ici_group, dcn_group=None) -> int:
    """This rank's linear index over the factored data axes, dcn-major:
    dcn_index * ici + ici_index (the global rank on a `make_mesh`
    mesh)."""
    ici = 0 if ici_group is None else dist.get_rank(ici_group)
    if dcn_group is None:
        return ici
    return dist.get_rank(dcn_group) * _size(ici_group) + ici


__all__ = [
    "Bucket",
    "BucketSlot",
    "MONOLITHIC_BUCKET_MB",
    "PendingReduction",
    "Reducer",
    "bucket_pad_multiple",
    "bucketed_pmean",
    "bucketed_psum",
    "compressed_dcn_psum",
    "data_replica_index",
    "plan_buckets",
    "reduce_bucket_flat",
    "ring_all_gather",
    "ring_reduce_scatter",
]
