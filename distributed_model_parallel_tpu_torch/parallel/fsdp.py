"""Fully-sharded data parallelism, ZeRO-3 style, over the data axis (port
of `parallel/fsdp.py`).

Each parameter is sharded along its largest dimension divisible by the
data ranks N (`fsdp_specs`, the reference's shape policy on the
canonical shapes: conv weights counted HWIO), and the optimizer state
follows it: momentum, AdamW's moments. Leaves below `min_shard_elems`
(1024, inclusive) or with no divisible dimension stay replicated. Per
rank, parameter and optimizer memory scale 1/N; the math stays data
parallelism with BN over the global batch.

The reference lets XLA's partitioner insert the collectives under
`grad_reduction="monolithic"`; the port has no partitioner, so every
mode is an explicit step, per rank:

* gather: each sharded leaf all-gathered over the data group (the
  ZeRO-3 "materialize right before use" collective; with a compressed
  wire, `_coded_dcn_gather`: an f32 gather inside the slice and K-1
  coded hops around the cross-slice ring);
* forward and backward of the local mean cross-entropy on the gathered
  parameters, BN statistics over the data group (`bn_axis = data`);
* the gradient mean over the data ranks: one flat all-reduce
  (monolithic), or the bucketed Reducer (`ops/grad_reduction.py`:
  bucketed, and monolithic + compression as one flat bucket per dtype);
* each rank keeps its own 1/N slice of each reduced gradient (local, no
  collective) and updates its parameter and moment shards in place.

`grad_reduction="overlapped"` runs the reference's stagewise loop: the
forward stage by stage on freshly gathered weights, keeping only the
stage inputs; the backward in reverse, each stage's weights gathered
again (stage k-1's issued one stage ahead), its forward recomputed and
differentiated, its buckets issued at once. Gather traffic doubles and
each stage's forward runs twice: ZeRO-3 with activation checkpointing.

The state's leaves are this rank's shards in the port's layout (conv
weights OIHW, the canonical dimension mapped across); `to_canonical`,
`from_canonical` and `canonical_spec` gather and re-slice over the data
group (`TensorParallelEngine`'s seams, over this axis), and
`to_canonical_sharded` is the sharded checkpoint's collective-free view
(`checkpointing/sharded.py`). On the card a gloo group carries no CUDA
tensor in an all-gather, so a gloo rank's gathers stage through the
host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.analysis import record
from distributed_model_parallel_tpu_torch.analysis.record import scope
from distributed_model_parallel_tpu_torch.checkpointing.sharded import (
    port_dim,
)
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models.convert import params_spec
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    check_compression,
    coded_ppermute,
    require_dcn_axis,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    GRAD_REDUCTIONS,
    TrainState,
    _DataParallel,
)
from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorParallelEngine,
    shard_tree,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    MeshSpec,
    data_axis_names,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_like,
    tree_map,
)


class P(tuple):
    """A partition spec, the reference's `PartitionSpec` spelling: one
    entry a dimension, None (replicated) or the mesh axis name(s) it is
    split over; `P()` is replicated. A one-name tuple is spelled as the
    name, as `PartitionSpec` normalizes it. A tuple subclass, so the
    trees of `training/optim.tree_map` treat it as a leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def fsdp_specs(params_aval, n_shards: int, *, min_shard_elems: int = 1024,
               axes: Sequence[str] | str = "data"):
    """The shape-driven spec tree: each leaf (anything with `.shape`)
    sharded over the data axis / axes along its largest dimension
    divisible by `n_shards`; leaves smaller than `min_shard_elems`, or
    with no divisible dimension, replicated (`P()`). `axes` is 'data',
    or ('dcn', 'ici') on a factored mesh."""
    entry = tuple(axes) if not isinstance(axes, str) else axes

    def spec_of(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or math.prod(shape) < min_shard_elems:
            return P()
        dims = sorted(range(len(shape)), key=lambda d: shape[d],
                      reverse=True)
        for d in dims:
            if shape[d] % n_shards == 0:
                parts = [None] * len(shape)
                parts[d] = entry
                return P(*parts)
        return P()

    return tree_map(spec_of, params_aval)


def _sharded_dim(spec) -> Tuple:
    """(dim, axes) of the one sharded dimension of an fsdp spec, or
    (None, None) for a replicated leaf."""
    for d, part in enumerate(spec):
        if part is not None:
            return d, part
    return None, None


def _all_gather(t: torch.Tensor, group, n: int) -> list:
    """The n shards of a leaf over `group`, in rank order (one flat
    all-gather; through the host for a gloo group on the card)."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = (t.detach().cpu() if staged else t.detach()).contiguous()
    out = src.new_empty((n * src.numel(),))
    dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    if staged:
        out = out.to(t.device)
    return list(out.view((n,) + tuple(src.shape)).unbind(0))


@dataclasses.dataclass
class FSDPEngine(TensorParallelEngine):
    """Fully-sharded data parallelism: batch AND parameters (and their
    optimizer moments) sharded over the data axis, with the other
    engines' API. `grad_reduction`, `bucket_mb`, `overlap_stages` and
    `dcn_compression` as on `DDPEngine`; under compression the weight
    gathers' cross-slice leg rides the wire too (module docstring)."""

    rules: tuple = ()  # shape-driven engine: rules are refused
    # Leaves below this many elements stay replicated (BN scales etc.).
    min_shard_elems: int = 1024
    grad_reduction: str = "monolithic"
    bucket_mb: float = 25.0
    overlap_stages: int = 0
    dcn_compression: str = "none"

    def __post_init__(self):
        if self.rules:
            raise ValueError(
                "FSDPEngine shards by shape policy, not path rules; "
                "passing rules here would be silently ignored. Subclass "
                "and override param_specs to compose FSDP with "
                "'model'/'expert' rule sharding.")
        if self.grad_reduction not in GRAD_REDUCTIONS:
            raise ValueError(
                "grad_reduction must be 'monolithic', 'bucketed' or "
                f"'overlapped', got {self.grad_reduction!r}")
        check_compression(self.dcn_compression)
        explicit = (self.grad_reduction in ("bucketed", "overlapped")
                    or self.dcn_compression != "none")
        if explicit and self.collective_matmul:
            raise ValueError(
                "collective_matmul=True is not supported by the "
                f"{self.grad_reduction} FSDP step (no matmul policy is "
                "threaded through the explicit shard_map program)")
        if self.mesh is None:
            self.mesh = make_mesh(MeshSpec(data=-1))
        if self.mesh.model > 1:
            raise ValueError(
                "FSDPEngine shards over the data axis; a mesh with "
                f"model={self.mesh.model} belongs to TensorParallelEngine")
        super().__post_init__()  # refuses collective_matmul by its slice
        self._wire = require_dcn_axis(self.dcn_compression,
                                      self.mesh.dcn_group)
        self._setup(True, self.grad_reduction, self.bucket_mb,
                    self.overlap_stages, self.dcn_compression)
        self._pspecs = None
        #: weight all-gathers issued (one a sharded leaf a gather)
        self.param_gathers = 0

    # ------------------------------------------------------------ layout

    def _shard_axis(self, split=None):
        return self.mesh.group, self.mesh.data, self.mesh.data_index

    def _holders(self, m: int, split=None) -> Tuple[int, ...]:
        return (m,)

    def _axis_entry(self, split=None):
        names = data_axis_names(self.mesh)
        return names[0] if len(names) == 1 else names

    def param_specs(self, params):
        """`fsdp_specs` of a parameter tree, on its canonical shapes."""
        return fsdp_specs(params_spec(params), self.mesh.data,
                          min_shard_elems=self.min_shard_elems,
                          axes=data_axis_names(self.mesh))

    def state_from_params(self, params, model_state) -> TrainState:
        """A step-0 state around the FULL `params`: this rank keeps its
        1/N of each sharded leaf on the engine's device."""
        self._pspecs = self.param_specs(params)

        def split(t, spec):
            d, _ = _sharded_dim(spec)
            return None if d is None else Split(port_dim(d, t.dim()))

        self._specs = tree_map(split, params, self._pspecs)
        _, count, index = self._shard_axis()
        return _DataParallel.state_from_params(
            self, shard_tree(params, self._specs, index, count), model_state)

    # -------------------------------------------------------- collectives

    def _gather(self, t: torch.Tensor, split, grad: bool) -> torch.Tensor:
        """The full leaf of shard `t` (itself when replicated), a new
        graph leaf that takes a gradient when `grad`."""
        if split is None:
            return t
        self.param_gathers += 1
        with torch.no_grad():
            if self._wire != "none":
                full = self._coded_dcn_gather(t, split.dim)
            else:
                group, n, _ = self._shard_axis()
                full = (t.detach().clone() if group is None else
                        torch.cat(_all_gather(t, group, n), dim=split.dim))
            if full.dim() == 4:  # the layout DDP's conv weights keep
                full = full.contiguous(memory_format=torch.channels_last)
        return full.requires_grad_(grad)

    def _gather_tree(self, tree, specs, grad: bool = True):
        return tree_map(lambda t, s: self._gather(t, s, grad), tree, specs)

    def _coded_dcn_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The fused data-axis gather of one shard, decomposed so that
        only the intra-slice leg stays f32: an all-gather over the slice
        makes its block (1/K of the leaf), then K-1 `coded_ppermute`
        hops rotate the blocks around the cross-slice ring on the wire
        dtype, each received block placed at its SOURCE slice's offset:
        the dcn-major layout of the fused gather."""
        mesh = self.mesh
        block = torch.cat(_all_gather(t, mesh.ici_group, mesh.ici), dim=dim)
        k = mesh.dcn
        if k <= 1:
            return block
        n = block.shape[dim]
        shape = list(block.shape)
        shape[dim] = n * k
        full = block.new_zeros(shape)
        j = dist.get_rank(mesh.dcn_group)
        full.narrow(dim, j * n, n).copy_(block)
        perm = tuple((i, (i + 1) % k) for i in range(k))
        cur = block
        for s in range(1, k):
            with scope("fsdp_gather"):
                cur = coded_ppermute(cur, mesh.dcn_group, perm, self._wire)
            full.narrow(dim, ((j - s) % k) * n, n).copy_(cur)
        return full

    def _slice_tree(self, grads, specs):
        """This rank's 1/N slice of each fully reduced leaf (local)."""
        _, n, index = self._shard_axis()

        def local(g, split):
            if split is None:
                return g
            block = g.shape[split.dim] // n
            return g.narrow(split.dim, index * block, block)

        return tree_map(local, grads, specs)

    # ------------------------------------------------------------- steps

    def _forward_params(self, params, grad: bool = True):
        return self._gather_tree(params, self._specs, grad)

    def _local_grads(self, grads):
        return self._slice_tree(grads, self._specs)

    def _overlapped_grads(self, ts: TrainState, x, labels, ctx):
        """Both ZeRO overlaps, stagewise (module docstring): returns
        (logits, ce, this rank's gradient slices, new BN state)."""
        cuts = self._cuts
        n = len(cuts) - 1
        fns = staging.stage_apply_fns(self.model.parts, cuts, ctx)
        shards = staging.partition_tree(ts.params, cuts)
        specs = staging.partition_tree(self._specs, cuts)
        states = staging.partition_tree(ts.model_state, cuts)
        # ---- forward: gather stage k, apply, drop; keep the stage
        # inputs and the new BN state.
        xs, new_states = [], []
        y = x
        with torch.no_grad():
            for k in range(n):
                xs.append(y)
                y, ns = fns[k](self._gather_tree(shards[k], specs[k], False),
                               states[k], y)
                new_states.append(ns)
        logits = staging._cut(y)
        ce = cross_entropy(logits, labels)
        cot = torch.autograd.grad(ce, [logits])
        # ---- backward: stage k-1's gather issued before stage k's
        # recomputed forward and backward; stage k's buckets issued as
        # soon as its gradients exist.
        pending = []
        with scope(f"prefetch_gather_stage{n - 1}"):
            prefetched = self._gather_tree(shards[n - 1], specs[n - 1])
        for k in reversed(range(n)):
            full_k = prefetched
            if k > 0:
                with scope(f"prefetch_gather_stage{k - 1}"):
                    prefetched = self._gather_tree(shards[k - 1],
                                                   specs[k - 1])
            if record.ON:
                record.note("bwd_stage", stage=k)
            x_k = staging._cut(xs[k]) if k else xs[k]
            out, ns = fns[k](full_k, states[k], x_k)
            p_leaves = list(tree_leaves(full_k))
            x_leaves = staging._float_leaves(x_k) if k else []
            outs, cots = staging._float_leaves(out), list(cot)
            aux = L.aux_loss(ns)  # a MoE stage's load-balance loss
            if torch.is_tensor(aux):
                outs, cots = outs + [aux], cots + [torch.ones_like(aux)]
            got = torch.autograd.grad(outs, p_leaves + x_leaves,
                                      grad_outputs=cots)
            dp = tree_like(full_k, iter(got[:len(p_leaves)]))
            with scope(f"grad_reduce_stage{k}"):
                pending.append((k, self._reducer.issue(dp, mean=True)))
            cot = got[len(p_leaves):]
        stage_grads = [None] * n
        for k, p in pending:
            stage_grads[k] = self._slice_tree(self._reduced(p), specs[k])
        return (logits.detach(), ce.detach(),
                staging.unpartition_tree(stage_grads, cuts),
                staging.unpartition_tree(new_states, cuts))


__all__ = ["FSDPEngine", "P", "fsdp_specs"]
