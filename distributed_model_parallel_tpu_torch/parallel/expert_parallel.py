"""Expert parallelism (port of `parallel/expert_parallel.py`): the MoE
experts sharded over the mesh's `expert` axis, or over the data fabric
through the hand-written two-level exchange.

Two dispatch modes on one engine, the reference's:

* `dispatch="gspmd"` on `MeshSpec(data=-1, expert=N)` (rank =
  data_index * N + expert_index, `runtime/mesh.py`): the reference
  places `EXPERT_RULES` on the weight tree and lets XLA's partitioner
  move the tokens. Here each of the N ranks of an expert group holds
  E/N experts (the leading-E `Split` of the stacks) and a copy of every
  other leaf, sees its data index's rows, routes them all (the routing
  is replicated), runs its own experts on the tokens routed to them and
  all-reduces the combined output over the expert group: the tensor-
  parallel engine's f / g pattern (`ExpertGroupDispatch`). f (identity
  forward, all-reduce backward) takes the hidden states and the kept
  gates into the expert region in one collective, g (all-reduce
  forward, identity backward) brings the output back.
* `dispatch="hierarchical"` (+ `overlap=True`) on `MeshSpec(data=-1,
  dcn=K)`: the experts ride the data fabric, E/S a rank at rest, and
  each MoE layer's tokens move through `ops/expert_dispatch.py`'s
  explicit ici-then-dcn exchange (`ExpertDispatch`), optionally chunked
  so a chunk's FFN runs while the next moves, with `dcn_compression`
  coding the cross-slice hops. The `expert` axis must be 1.

The step has the reference's global-batch semantics (its engine is
GSPMD): each rank differentiates its tokens' share of the global loss,
the cross-entropy SUM over its valid rows divided by the valid count of
the whole data axis, plus the load-balance loss computed from counts
and gate mass summed over the data ranks (`models/moe.py`'s
`reduce_aux`, whose backward is the identity). The gradients are then
SUMMED over the data group. A hierarchical expert shard's gradient
already holds every rank's share (the exchange's backward brings it
home), so it is not reduced; the replicated leaves are. The metric sums
run over the data group. Dropout keys fold the step and the data index,
so the ranks of an expert group draw the same masks on the replicated
stream (every dropout site acts on a replicated tensor).

Checkpoints: `to_canonical` gathers the expert shards over the shard
axis (the expert group, or the data group in hierarchical mode) into the
reference's full stacks; `to_canonical_sharded` writes each shard as a
rectangle of its canonical leaf (`checkpointing/sharded.py`), and a
file saved at one S restores at another through `from_canonical`.

`ExpertParallelLMEngine` is the causal-LM engine on the same mesh:
`models/gpt.gpt_lm_model(GPTConfig(num_experts > 0))`, the next-token
loss over the flattened tokens, and `shard_batch` taking the GLOBAL ids
(the LM CLI's loader) and keeping its data index's rows, their targets
built on the host (`models/gpt.lm_targets`).

Refused: `MeshSpec(model > 1, expert > 1)` (EP x TP on one mesh, the
reference's `EXPERT_RULES + MEGATRON_RULES`) belongs to the composed-
plan slice, as does `collective_matmul` here.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.gpt import lm_targets
from distributed_model_parallel_tpu_torch.models.moe import dense_experts
from distributed_model_parallel_tpu_torch.ops.expert_dispatch import (
    ExpertDispatch,
    sum_aux_over,
)
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    check_compression,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    TrainState,
    _metrics,
    step_key,
    write_back,
)
from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
    MEGATRON_RULES,
    Split,
    TensorParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    EP_TP_ITEM,
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
)

# The stacked expert weights (`models/moe.py` paths .../moe/experts/*)
# split on their leading E axis, the reference's EXPERT_RULES.
EXPERT_RULES: Tuple[Tuple[str, Split], ...] = (
    (r"experts/w_in$", Split(0)),
    (r"experts/b_in$", Split(0)),
    (r"experts/w_out$", Split(0)),
    (r"experts/b_out$", Split(0)),
)


class _Enter(torch.autograd.Function):
    """Megatron's f over the expert group on a tuple of tensors packed in
    one f32 buffer: the identity forward, one all-reduce (SUM) of the
    packed gradients backward."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([
            (torch.zeros(shape, device=device) if g is None
             else g.float()).reshape(-1)
            for g, (shape, _, device) in zip(gs, ctx.meta)])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for shape, dtype, _ in ctx.meta:
            n = int(np.prod(shape))
            out.append(flat[at:at + n].view(shape).to(dtype))
            at += n
        return (None, *out)


@dataclasses.dataclass(frozen=True)
class ExpertGroupDispatch:
    """The gspmd-mode policy (module docstring): this rank's E/N experts
    over the rows of its data index; `enter` is f on the hidden states
    and the kept gates, the call's all-reduce of the output g; the aux
    statistics are summed over the data group."""

    expert_group: Any
    count: int
    index: int
    data_group: Any

    def enter(self, h, weights):
        if self.count == 1:
            return h, weights
        h, *weights = _Enter.apply(self.expert_group, h, *weights)
        return h, weights

    def __call__(self, h, dispatch, combine, w):
        if self.count == 1:
            return dense_experts(h, dispatch, combine, w)
        el = w["w_in"].shape[0]
        lo = self.index * el
        out = dense_experts(h, dispatch[:, :, lo:lo + el],
                            combine[:, :, lo:lo + el], w)
        return L.reduce_from_model_parallel(out, self.expert_group)

    def reduce_aux(self, f_sum, p_sum, n):
        return sum_aux_over(self.data_group, f_sum, p_sum, n)


@dataclasses.dataclass
class ExpertParallelEngine(TensorParallelEngine):
    """Expert (+ data) parallelism (module docstring), with the other
    engines' API. `mesh=None` takes this process's world as data ranks
    (expert 1). The state holds this rank's expert shards; `to_canonical`
    / `from_canonical` are the reference-layout tree, collective over the
    shard axis."""

    rules: Sequence[Tuple[str, Split]] = EXPERT_RULES
    # "gspmd": experts over the 'expert' axis; "hierarchical": over the
    # data fabric through the two-level exchange.
    dispatch: str = "gspmd"
    # Chunk the hierarchical exchange (FFN of chunk k beside the hops of
    # chunk k+1); hierarchical only.
    overlap: bool = False
    # Code the exchange's cross-slice hops ("none" | "bf16" | "int8");
    # hierarchical on a MeshSpec(dcn=K) mesh only.
    dcn_compression: str = "none"

    def __post_init__(self):
        if self.dispatch not in ("gspmd", "hierarchical"):
            raise ValueError(
                "dispatch must be 'gspmd' or 'hierarchical', got "
                f"{self.dispatch!r}")
        if self.overlap and self.dispatch != "hierarchical":
            raise ValueError(
                "overlap=True chunks the hierarchical exchange; it has "
                "no effect under dispatch='gspmd' — set "
                "dispatch='hierarchical' or drop overlap")
        check_compression(self.dcn_compression)
        if self.dcn_compression != "none" and \
                self.dispatch != "hierarchical":
            raise ValueError(
                "dcn_compression compresses the hierarchical "
                "exchange's cross-slice messages; the gspmd dispatch "
                "has no explicit 'dcn' hop — set "
                "dispatch='hierarchical' or drop dcn_compression")
        if self.collective_matmul:
            raise ValueError(
                "collective_matmul=True rings over a 'model' axis, which "
                "the expert-parallel engine does not carry: EP x TP on one "
                f"mesh is {EP_TP_ITEM}")
        if self.mesh is None:
            self.mesh = make_mesh(MeshSpec(data=-1))
        mesh = self.mesh
        if mesh.model > 1:
            raise ValueError(
                f"a mesh with model={mesh.model} composes tensor and expert "
                f"parallelism, which is {EP_TP_ITEM}")
        if self.dispatch == "hierarchical":
            if mesh.expert > 1:
                raise ValueError(
                    "dispatch='hierarchical' rides the (factored) data "
                    "fabric: experts shard over data_axis_names(mesh), "
                    "not 'expert' — build the mesh with expert=1 (got "
                    f"expert={mesh.expert})")
            policy = ExpertDispatch(mesh, overlap=self.overlap,
                                    dcn_compression=self.dcn_compression)
        else:
            policy = ExpertGroupDispatch(mesh.expert_group, mesh.expert,
                                         mesh.expert_index, mesh.group)
        self._setup(sync_bn=True)
        self._model_group = None
        self._specs = None
        self._matmul = None
        self._expert_dispatch = policy

    # ------------------------------------------------------ shard axis

    @property
    def _hierarchical(self) -> bool:
        return self.dispatch == "hierarchical"

    def _shard_axis(self):
        """(group, count, index) of the axis the expert stacks shard over:
        the expert group, or the data group in hierarchical mode."""
        m = self.mesh
        if self._hierarchical:
            return m.group, m.data, m.data_index
        return m.expert_group, m.expert, m.expert_index

    def _holders(self, m: int) -> Tuple[int, ...]:
        """The global ranks holding expert shard `m`: expert index m of
        every data index, or data rank m in hierarchical mode."""
        if self._hierarchical:
            return (m,)
        n = self.mesh.expert
        return tuple(d * n + m for d in range(self.mesh.data))

    def _axis_entry(self):
        if self._hierarchical:
            names = data_axis_names(self.mesh)
            return names if len(names) > 1 else names[0]
        return "expert"

    # ------------------------------------------------------------ steps

    def _ctx(self, train: bool, step=None) -> L.Context:
        return L.Context(train=train, dtype=self.compute_dtype,
                         expert_dispatch=self._expert_dispatch,
                         rng=(step_key(step, self.mesh.data_index)
                              if train else None))

    def _reduce_grads(self, grads: list) -> list:
        """The gradients SUMMED over the data group (one all-reduce): all
        of them in gspmd mode, the replicated ones in hierarchical mode
        (an expert shard's gradient is complete where it lies)."""
        group = self.mesh.group
        if group is None:
            return grads
        specs = list(tree_leaves(self._specs))
        pick = [i for i, s in enumerate(specs)
                if s is None or not self._hierarchical]
        flat = torch.cat([grads[i].reshape(-1) for i in pick])
        dist.all_reduce(flat, group=group)
        self.grad_reductions += 1
        out = list(grads)
        for i, piece in zip(pick, flat.split([grads[i].numel()
                                              for i in pick])):
            out[i] = piece.view(grads[i].shape)
        return out

    def grads(self, ts: TrainState, inputs, labels):
        """(metric sums over the data ranks, gradient tree) of one train
        step (module docstring); the kept aux values are updated in
        place."""
        x = self._input(inputs, ts.step, True)
        logits, new_state = self.model.apply(ts.params, ts.model_state, x,
                                             self._ctx(True, ts.step))
        ce, m = self.loss_and_metrics(logits, labels)
        loss = ce
        if self.mesh.data > 1:  # this rank's share of the global mean
            total = self._all_reduce(m["count"].detach().float().clone())
            loss = ce * m["count"] / total.clamp_min(1.0)
        aux = L.aux_loss(new_state)
        if torch.is_tensor(aux):
            loss = loss + aux
        leaves = list(tree_leaves(ts.params))
        grads = self._reduce_grads(list(torch.autograd.grad(loss, leaves)))
        write_back(ts.model_state, new_state)
        return self._sum_metrics(m), tree_like(ts.params, iter(grads))

    def train_step(self, ts: TrainState, inputs, labels, lr):
        """One optimizer step; parameters, optimizer state and the kept
        aux values are updated in place. Returns (state, metric sums over
        the data ranks)."""
        metrics, grads = self.grads(ts, inputs, labels)
        params, opt_state = self.optimizer.update(ts.params, ts.opt_state,
                                                  grads, lr)
        return TrainState(params, ts.model_state, opt_state,
                          ts.step + 1), metrics

    @torch.no_grad()
    def eval_step(self, ts: TrainState, inputs, labels) -> dict:
        logits, _ = self.model.apply(ts.params, ts.model_state,
                                     self._input(inputs, ts.step, False),
                                     self._ctx(False))
        return self._sum_metrics(self.loss_and_metrics(logits, labels)[1])


@dataclasses.dataclass
class ExpertParallelLMEngine(ExpertParallelEngine):
    """Causal-LM pretraining under expert (+ data) parallelism: the EP
    engine with the next-token loss over the flattened tokens, driving
    `models/gpt.gpt_lm_model(cfg)` with `GPTConfig(num_experts > 0)`."""

    pad_token_id: Optional[int] = None

    def __post_init__(self):
        self._lm_targets = partial(lm_targets,
                                   pad_token_id=self.pad_token_id)
        super().__post_init__()

    def loss_and_metrics(self, logits, targets):
        """logits (B, T, V) and targets (B, T) (pad targets -1) -> (local
        mean cross-entropy over the valid tokens, metric sums)."""
        b, t, v = logits.shape
        flat_logits = logits.reshape(b * t, v)
        flat_targets = targets.reshape(b * t)
        ce = cross_entropy(flat_logits, flat_targets)
        return ce, _metrics(ce.detach(), flat_logits.detach(), flat_targets)

    def shard_batch(self, ids, labels=None):
        """The GLOBAL ids (B, T) host array -> this data index's rows of
        ids and of their next-token targets, on the device. `labels` is
        ignored (the targets are the shifted ids)."""
        ids = np.asarray(ids)
        d = self.mesh.data
        if ids.shape[0] % d:
            raise ValueError(
                f"batch size {ids.shape[0]} must be divisible by the "
                f"'data' mesh axis ({d} ranks)")
        rows = ids.shape[0] // d
        i = self.mesh.data_index
        ids = ids[i * rows:(i + 1) * rows]
        return (self._place(ids.astype(np.int64)),
                self._place(self._lm_targets(ids).astype(np.int64)))


__all__ = ["EXPERT_RULES", "MEGATRON_RULES", "ExpertGroupDispatch",
           "ExpertParallelEngine", "ExpertParallelLMEngine"]
