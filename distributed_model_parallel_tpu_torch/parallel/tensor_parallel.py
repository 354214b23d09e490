"""Tensor parallelism over the mesh's `model` axis (port of
`parallel/tensor_parallel.py`): Megatron's layout, with the collectives
written by hand.

The reference places the Megatron layout on the weight tree as sharding
annotations (`MEGATRON_RULES`) and lets XLA's SPMD partitioner insert
the all-reduces; its docstring names the GPU form, Megatron's f and g
autograd functions, and that is what runs here. Each of the M ranks of
a model group (`runtime/mesh.py`, rank = data_index * M + model_index)
holds its shard of every matched leaf and a full copy of the rest:

    column-parallel (qkv, ffn-in):      w (D, kD) -> (D, kD/M), b -> (kD/M,)
    row-parallel (attn-out, ffn-out):   w (kD, D) -> (kD/M, D), b whole
    everything else (LN, embeddings, pooler, head): replicated

and `layers.project` wraps the projections: f (identity forward,
gradient all-reduce backward) before a column projection, g (all-reduce
forward, identity backward) after a row projection's product, the bias
added once, after g (`models/transformer.py` passes the roles).

The fused QKV weight is not split contiguously. The reference stores
`attn/qkv/w` as one (D, 3D) array, whose columns are [q | k | v]; a
contiguous column block of it would not be head-local (at M 2 rank 0
would hold all of q and half of k). Each rank holds the reference's
shard shape, (D, 3D/M), built as [q columns of its heads | k columns of
them | v columns of them] (`Split(dim, parts=3)`), and the (3D,) bias
the same way. `to_canonical` gathers the shards and undoes the
interleave, so the checkpoint is the reference's layout exactly and
resumes under `--engine gspmd|ddp`, under the reference's engine, and
back. `to_canonical_sharded` is the sharded format's view of the same
state, with no collective: this rank's shards as rectangles of the
canonical leaves (three for the fused QKV), written by the ranks of
data index 0 (`checkpointing/sharded.py`).

A train step, per rank:

* the batch is its data index's rows (the loaders shard by data index:
  the M ranks of a model group see the same rows);
* forward and backward of the local mean cross-entropy; dropout keys
  fold the step and the DATA index (`step_key(step, data_index)`), so
  the ranks of a model group draw the same masks on the replicated
  residual stream (every dropout site acts on a replicated tensor);
* after f and g the replicated leaves' gradients are already identical
  across the model group, so the gradient mean runs over `data_group`
  only, as do the metric sums (summing over the world would count each
  sample M times);
* the optimizer update, in place; SGD's momentum and AdamW's moments
  are elementwise and shard like their parameters.

Divisibility: the port needs num_heads % M == 0 and ffn_dim % M == 0
(the reference's partitioner shards a 6-head (192, 576) QKV at M 4 into
144-column shards that split heads; the port's local attention cannot),
checked by `check_divisibility`.

`collective_matmul=True` runs each block's four projections on the
latency-hiding rings over the model group
(`ops/collective_matmul.CollectiveMatmul`) in place of f and g, with the
residual stream sequence-sharded between them (Megatron-SP): the model
runs by its stem / blocks / head anatomy (`models/staging.StageParts`),
the stem's output scattered to this rank's T/M positions and the blocks'
gathered before the head, so the sequence length must divide by M (the
reference's message; ViT's 65 tokens at M 2 are refused, as there).
Dropout in the blocks draws each element's bit from its index in the
whole sequence (`Context.seq_shard`), so the masks are those without the
rings. The blocks' replicated leaves (LayerNorms, row biases) then see
this rank's positions only, so their gradients are summed over the model
group after the data mean.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.checkpointing.sharded import (
    ShardedState,
    sharded_state,
)
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    train_state_from_jax,
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.ops.collective_matmul import (
    CollectiveMatmul,
    gather_seq,
    scatter_seq,
)
from distributed_model_parallel_tpu_torch.ops.expert_dispatch import (
    GlobalAux,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    TrainState,
    _DataParallel,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    Mesh,
    MeshSpec,
    make_mesh,
    mesh_axes,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_map,
)


class Split(NamedTuple):
    """How a leaf shards over a mesh axis: along `dim`, which is the
    concatenation of `parts` equal blocks (3 for the fused [q | k | v]),
    each block split contiguously into M pieces; rank m holds piece m of
    every block, concatenated in block order. `axis` names the mesh axis
    ("" = the engine's own: 'model' here, the data axes under FSDP);
    `EXPERT_RULES` say "expert", so that with `MEGATRON_RULES` beside
    them one tree shards over two axes (EP x TP)."""

    dim: int
    parts: int = 1
    axis: str = ""


# Megatron's layout on the transformer block tree (`models/transformer.py`
# paths), the reference's MEGATRON_RULES with the split dimension in
# place of the PartitionSpec.
MEGATRON_RULES: Tuple[Tuple[str, Split], ...] = (
    (r"attn/qkv/w$", Split(1, 3)),
    (r"attn/qkv/b$", Split(0, 3)),
    (r"attn/out/w$", Split(0)),
    (r"ffn/in/w$", Split(1)),
    (r"ffn/in/b$", Split(0)),
    (r"ffn/out/w$", Split(0)),
)


def shard_specs(params, rules: Sequence[Tuple[str, Split]] = MEGATRON_RULES):
    """A tree like `params` of `Split`s: the first rule whose regex
    matches a leaf's 'a/b/c' path wins; unmatched leaves are None
    (replicated)."""
    compiled = [(re.compile(pat), split) for pat, split in rules]

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        path = prefix[:-1]
        return next((split for pat, split in compiled if pat.search(path)),
                    None)

    return walk(params, "")


def _blocks(t: torch.Tensor, split: Split, m: int, shards: int) -> list:
    """Piece `m` of every block of `t` along `split.dim`."""
    size = t.shape[split.dim]
    if size % (split.parts * shards):
        raise ValueError(
            f"a dimension of {size} ({split.parts} block(s)) does not split "
            f"over {shards} model shards")
    piece = size // (split.parts * shards)
    return [blk.narrow(split.dim, m * piece, piece)
            for blk in t.chunk(split.parts, dim=split.dim)]


def shard_leaf(t: torch.Tensor, split: Optional[Split], m: int,
               shards: int) -> torch.Tensor:
    """Model rank `m`'s shard of the full leaf `t` (a copy)."""
    if split is None or shards == 1:
        return t
    return torch.cat(_blocks(t, split, m, shards), dim=split.dim)


def unshard_leaf(pieces: Sequence[torch.Tensor],
                 split: Optional[Split]) -> torch.Tensor:
    """The full leaf from every model rank's shard, in rank order."""
    if split is None or len(pieces) == 1:
        return pieces[0]
    per_rank = [p.chunk(split.parts, dim=split.dim) for p in pieces]
    return torch.cat([torch.cat([r[b] for r in per_rank], dim=split.dim)
                      for b in range(split.parts)], dim=split.dim)


def shard_tree(tree, specs, m: int, shards: int):
    return tree_map(lambda t, s: shard_leaf(t, s, m, shards), tree, specs)


def check_divisibility(num_heads: int, ffn_dim: int, shards: int) -> None:
    """The port's tensor-parallel layout needs whole heads and whole FFN
    columns on every model rank."""
    if num_heads % shards or ffn_dim % shards:
        raise ValueError(
            f"--model-shards {shards} must divide the model's {num_heads} "
            f"attention heads and its FFN width {ffn_dim}: each model rank "
            "attends over whole heads (the reference's partitioner may "
            "split a head across shards; the port does not)")


def megatron_sp(model: L.Layer, group, policy) -> L.Layer:
    """`model` (a `staging.staged_model`: stem, blocks, head) run with
    Megatron-SP over `group` (module doc): the stem on the whole
    sequence, its output scattered to this rank's positions, the blocks
    under the ring `policy` with `Context.seq_shard` set, their output
    gathered before the head; the parameter tree and the `Context.child`
    chain are `model`'s own."""
    parts = model.parts
    if parts is None:
        raise ValueError(
            "collective_matmul=True runs the model by its stem / blocks / "
            "head anatomy (models/staging.staged_model); this model has "
            "none")

    def apply(params, state, x, ctx):
        (h, mask), stem_state = parts.stem.apply(
            params["stem"], state["stem"], x, ctx.child(0))
        total = h.shape[1]
        h = scatter_seq(h, group)
        start = (0 if group is None else dist.get_rank(group)) * h.shape[1]
        block_ctx = dataclasses.replace(ctx.child(1), matmul=policy,
                                        seq_shard=(start, total))
        block_states = {}
        for i, block in enumerate(parts.blocks):
            key = str(i)
            (h, mask), block_states[key] = block.apply(
                params["blocks"][key], state["blocks"][key], (h, mask),
                block_ctx.child(i))
        y, head_state = parts.head.apply(
            params["head"], state["head"], (gather_seq(h, group), mask),
            ctx.child(2))
        return y, {"stem": stem_state, "blocks": block_states,
                   "head": head_state}

    return dataclasses.replace(model, apply=apply)


def _like_params(opt_field, params) -> bool:
    """True for an optimizer-state field shaped like the parameters (the
    momentum, the moments), False for a scalar (AdamW's count)."""
    return isinstance(opt_field, dict) and isinstance(params, dict)


@dataclasses.dataclass
class TensorParallelEngine(_DataParallel):
    """Megatron tensor parallelism on a (data, model) mesh, with the other
    engines' API (`init_state`, `state_from_params`, `shard_batch`,
    `train_step`, `eval_step`), so `Trainer` drives it unchanged; the
    data axis is the global-batch step of `DataParallelEngine`. `mesh=
    None` takes this process's world at model 1. The state holds this
    rank's shards; `to_canonical` / `from_canonical` are the full
    reference-layout tree, collective over the model group."""

    model: L.Layer
    optimizer: Any
    mesh: Optional[Mesh] = None
    rules: Sequence[Tuple[str, Split]] = MEGATRON_RULES
    compute_dtype: Optional[torch.dtype] = None
    input_transform: Any = None
    collective_matmul: bool = False
    device: Any = "cuda"

    #: `Trainer` gathers checkpoints through `to_canonical` on every rank
    collective_checkpoint = True

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_mesh(MeshSpec(data=-1))
        self._setup(sync_bn=True)
        self._expert_dispatch = GlobalAux(self.mesh.group)
        self._model_group = self.mesh.model_group
        self._specs = None  # the layout, from the first parameter tree
        self._matmul = None
        if self.collective_matmul:
            self._matmul = CollectiveMatmul(group=self._model_group)
            self.model = megatron_sp(self.model, self._model_group,
                                     self._matmul)

    def _model_partial(self, split: Optional[Split]) -> bool:
        """Whether a block leaf laid out like `split` saw this rank's
        positions only under Megatron-SP: the replicated ones."""
        return split is None

    def _local_grads(self, grads):
        """Under Megatron-SP the blocks' replicated leaves (LayerNorms,
        row biases) saw this rank's positions only: their gradients are
        summed over the model group (one all-reduce)."""
        if self._matmul is None or self.mesh.model == 1:
            return grads
        partial = [(g, s) for g, s in zip(tree_leaves(grads["blocks"]),
                                          tree_leaves(self._specs["blocks"]))
                   if self._model_partial(s)]
        flat = torch.cat([g.reshape(-1) for g, _ in partial])
        dist.all_reduce(flat, group=self._model_group)
        for (g, _), piece in zip(partial, flat.split(
                [g.numel() for g, _ in partial])):
            g.copy_(piece.view(g.shape))
        return grads

    def _shard_axis(self, split: Optional[Split] = None):
        """(group, count, index) of the axis `split` shards over: the
        model axis here; `FSDPEngine` shards over the data axis, and
        `ExpertParallelEngine` an expert stack over its expert axis."""
        return (self.mesh.model_group, self.mesh.model,
                self.mesh.model_index)

    def _holders(self, m: int, split: Optional[Split] = None
                 ) -> Tuple[int, ...]:
        """The global ranks holding shard `m` of a leaf split like
        `split`: model index m of every data (and expert) index."""
        mesh = self.mesh
        return tuple((d * mesh.model + m) * mesh.expert + i
                     for d in range(mesh.data) for i in range(mesh.expert))

    def _axis_entry(self, split: Optional[Split] = None):
        """The mesh axis name a sharded leaf's manifest spec records."""
        return "model"

    def _shard_tree(self, tree, specs):
        """This rank's shard of every leaf of the FULL `tree`."""
        def local(t, split):
            _, count, index = self._shard_axis(split)
            return shard_leaf(t, split, index, count)

        return tree_map(local, tree, specs)

    def state_partition_specs(self, ts: TrainState) -> TrainState:
        """The layout of `ts`: a `Split` (or None, replicated) for each
        parameter and optimizer leaf; BN state and the step replicate."""
        opt = ts.opt_state
        return TrainState(
            self._specs, tree_map(lambda _: None, ts.model_state),
            type(opt)(*(self._specs if _like_params(f, ts.params) else None
                        for f in opt)), None)

    # ------------------------------------------------------------ state

    def state_from_params(self, params, model_state) -> TrainState:
        """A step-0 state around the FULL `params`: this rank keeps its
        shards (`rules`) on the engine's device. ValueError when a
        sharded dimension does not split over the model ranks."""
        self._specs = shard_specs(params, self.rules)
        return super().state_from_params(
            self._shard_tree(params, self._specs), model_state)

    def _full_state(self, ts: TrainState) -> TrainState:
        """Every sharded leaf gathered over the shard axis (collective;
        on the host when the group is gloo, which carries CPU tensors)."""
        def gather(t, split):
            t = t.detach()
            group, m, _ = self._shard_axis(split)
            if split is None or m == 1:
                return t.to("cpu", copy=True)  # a snapshot, not a view
            if dist.get_backend(group) == "gloo":
                t = t.cpu()
            pieces = [torch.empty_like(t) for _ in range(m)]
            dist.all_gather(pieces, t.contiguous(), group=group)
            return unshard_leaf(pieces, split)

        opt = ts.opt_state
        return TrainState(
            tree_map(gather, ts.params, self._specs),
            tree_map(lambda t: gather(t, None), ts.model_state),
            type(opt)(*(tree_map(gather, f, self._specs)
                        if _like_params(f, ts.params) else gather(f, None)
                        for f in opt)),
            ts.step)

    def to_canonical(self, ts: TrainState) -> dict:
        """The reference's canonical checkpoint tree (numpy, full
        unsharded leaves in the reference layout). Collective: every rank
        of the world calls it."""
        return train_state_to_jax(self._full_state(ts))

    def _full_like(self, ts: TrainState, device="cpu") -> TrainState:
        """A state of empty FULL-shaped leaves (no collective): the
        template of the canonical tree's shapes, dtypes and layouts."""
        def full(t, split):
            if split is None:  # its layout too (channels-last convs)
                return torch.empty_like(t, device=device)
            _, m, _ = self._shard_axis(split)
            shape = list(t.shape)
            shape[split.dim] *= m
            return torch.empty(shape, dtype=t.dtype, device=device)

        opt = ts.opt_state
        return TrainState(
            tree_map(full, ts.params, self._specs), ts.model_state,
            type(opt)(*(tree_map(full, f, self._specs)
                        if _like_params(f, ts.params) else f for f in opt)),
            ts.step)

    def canonical_spec(self, ts: TrainState) -> dict:
        """`to_canonical(ts)`'s shapes and dtypes, without a collective
        (the restore template)."""
        return train_state_spec(self._full_like(ts, "meta"))

    def from_canonical(self, tree, like: Optional[TrainState] = None
                       ) -> TrainState:
        """A canonical tree (every rank holding the same values, as
        `training/checkpoint.restore_checkpoint` broadcasts them) re-sliced
        into this rank's shards on the engine's device, in the layouts
        of `like` (default: a fresh `init_state()`)."""
        like = like or self.init_state()
        full = train_state_from_jax(tree, self._full_like(like))

        def local(t, split):
            _, shards, m = self._shard_axis(split)
            return shard_leaf(t.detach(), split, m, shards).to(
                self.device).clone()

        opt = full.opt_state
        return TrainState(
            tree_map(lambda t, s: local(t, s).requires_grad_(True),
                     full.params, self._specs),
            tree_map(lambda t: t.to(self.device), full.model_state),
            type(opt)(*(tree_map(local, f, self._specs)
                        if _like_params(f, full.params)
                        else f.to(self.device) for f in opt)),
            full.step)


    def to_canonical_sharded(self, ts: TrainState) -> ShardedState:
        """The sharded checkpoint's view of `ts` (`checkpointing/
        sharded.py`): this rank's shards as (canonical path, global
        start, shape, tensor) regions, and every region's holders. No
        collective and no copy: the save's snapshot copies what this
        rank writes."""
        def place(split):
            _, count, index = self._shard_axis(split)
            return (count, index,
                    lambda m: self._holders(m, split),
                    self._axis_entry(split))

        return sharded_state(ts, self.state_partition_specs(ts),
                             place=place, mesh_axes=mesh_axes(self.mesh))


__all__ = ["MEGATRON_RULES", "Split", "TensorParallelEngine",
           "check_divisibility", "megatron_sp", "shard_leaf", "shard_specs", "shard_tree",
           "unshard_leaf"]
