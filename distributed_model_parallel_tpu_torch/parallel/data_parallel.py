"""Data-parallel engines over `torch.distributed` (port of
`parallel/data_parallel.py`): `DataParallelEngine` and `DDPEngine`, with
the reference's `init_state` / `shard_batch` / `train_step` /
`eval_step` API, plus `TrainState` and `_metrics`, which the LM engine
shares.

One process per rank (`runtime/dist.py`), each holding the whole model
and its own slice of the global batch (the Loader's rank shard); the
collectives run over the mesh's process group (`runtime/mesh.py`: NCCL
on the card, gloo on the CPU). A step, per rank:

* forward and backward of the LOCAL mean cross-entropy;
* the gradients flattened into one buffer and all-reduced, SUM / world:
  the reference's "monolithic" `lax.pmean` of the gradient tree. Under
  `DDPEngine(grad_reduction="bucketed")` the mean goes through the
  bucketed Reducer instead (`ops/grad_reduction.py`: ~`bucket_mb` flat
  buckets in reverse order, each reduce-scattered and all-gathered over
  the slice, hierarchically over a `MeshSpec(dcn=K)` mesh, the
  cross-slice hop optionally compressed); under "overlapped" the same
  buckets are issued from a stagewise backward
  (`models/staging.stagewise_value_and_grad`), each segment's as soon
  as its gradients exist, and waited for before the update;
* per-replica BN (`DDPEngine(sync_bn=False)`, `nn.DataParallel`'s
  semantics): each rank normalizes with its own batch statistics, and
  the new running stats are averaged over the ranks before they are
  kept, so every rank keeps the same state;
* SyncBN (`sync_bn=True`): the batch statistics are averaged over the
  ranks inside the differentiated function (`models/layers.
  batchnorm2d`), so the step is the global-batch step;
* the in-place optimizer update, identical on every rank;
* the metric sums all-reduced (SUM).

`DataParallelEngine` is the global-batch semantics: on one rank, the
whole batch; over N ranks, the DDP step with SyncBN (the reference's
`test_ddp_syncbn_matches_gspmd`). SyncBN's per-layer all-reduces are
skipped on a world of one, where they are the identity; the gradient,
state and metric all-reduces run whenever there is a process group, so
one GPU runs the collective code of N. Features of later slices are
refused with a ValueError naming the slice. The dropout key folds the
rank, which on a factored mesh is the reference's dcn-major replica
index (`ops/grad_reduction.data_replica_index`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.ops.expert_dispatch import (
    GlobalAux,
    LocalExpertDispatch,
)
from distributed_model_parallel_tpu_torch.ops.grad_reduction import (
    MONOLITHIC_BUCKET_MB,
    Reducer,
)
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    check_compression,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh, make_mesh
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
    topk_correct,
    valid_count,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_map,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_like as _like,
)

GRAD_REDUCTIONS = ("monolithic", "bucketed", "overlapped")


class TrainState(NamedTuple):
    """params, model_state (BN running stats; empty for the GPT),
    optimizer state, and the step count. The step is a host int between
    steps (the reference keeps an int32 device scalar inside its jitted
    step); a captured step (`training/multistep.py`) is handed an int64
    device scalar in its place, so the dropout key it folds lives on the
    device and each replay draws its own step's bits."""

    params: Any
    model_state: Any
    opt_state: Any
    step: int


def _metrics(loss, logits, labels) -> dict:
    """Metric SUMS of one batch: `loss` is the mean over valid rows, so
    loss_sum = loss * count; rows labelled -1 count nowhere."""
    n = valid_count(labels)
    return {
        "loss_sum": loss * n,
        "correct1": topk_correct(logits, labels, 1),
        "correct5": topk_correct(logits, labels, 5),
        "count": n,
    }


def place(a, device: torch.device) -> torch.Tensor:
    """A host array -> a tensor on `device`, through pinned memory and an
    asynchronous copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def apply_input_transform(tf, x, step, train: bool):
    """The engine's `input_transform` on a placed batch, before the
    compute-dtype cast: a transform with `wants_ctx = True` (the device
    cache's gather and augmentation, `data/device_cache.py`) is called
    as `tf(x, step=step, train=train)`, where `step` is the state's step
    (a host int, or the device scalar a captured step advances); a plain
    one (`data/loader.device_normalizer`) as `tf(x)`."""
    if tf is None:
        return x
    if getattr(tf, "wants_ctx", False):
        return tf(x, step=step, train=train)
    return tf(x)


def step_key(step, rank: int = 0):
    """The dropout key of a train step on one data rank: the step (host
    int or device scalar) and the rank folded into the root key, as the
    reference's engines fold `ts.step` and the replica index into
    `PRNGKey(0)`."""
    return L.fold_in(L.fold_in(L.root_key(0), step), rank)


@torch.no_grad()
def write_back(old_tree, new_tree) -> None:
    """Copy a step's new BN statistics into the state's own tensors, so
    the state a step holds is updated in place (a captured step replays
    into the same memory)."""
    for old, new in zip(tree_leaves(old_tree), tree_leaves(new_tree)):
        if old is not new:
            old.copy_(new)


class _DataParallel:
    """The step both engines run; `_sync_bn` picks the BN semantics."""

    def _setup(self, sync_bn: bool, grad_reduction: str = "monolithic",
               bucket_mb: float = 25.0, overlap_stages: int = 0,
               dcn_compression: str = "none") -> None:
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None, float32 or "
                             f"bfloat16, got {self.compute_dtype}")
        self.device = torch.device(self.device)
        self.mesh = self.mesh or make_mesh()
        self._sync_bn = sync_bn
        self._bn_group = (self.mesh.group
                          if sync_bn and self.mesh.data > 1 else None)
        #: the tensor-parallel model group the layers' f and g run over
        #: (`TensorParallelEngine`); None for the data-parallel engines
        self._model_group = None
        #: the MoE policy (`Context.expert_dispatch`): None runs every
        #: expert here with the rank's own aux loss (the DDP engines); the
        #: global-batch engines set `GlobalAux`
        self._expert_dispatch = None
        #: gradient collectives issued: one all-reduce a step
        #: (monolithic, with a process group), or the Reducer's count
        self.grad_reductions = 0
        self._grad_reduction = grad_reduction
        self._reducer = None
        if grad_reduction != "monolithic" or dcn_compression != "none":
            # Monolithic + compression: one flat bucket per dtype through
            # the hierarchical path, so the 'dcn' hop has a seam.
            self._reducer = Reducer(
                self.mesh.ici_group, self.mesh.dcn_group,
                bucket_mb=(bucket_mb if grad_reduction != "monolithic"
                           else MONOLITHIC_BUCKET_MB),
                dcn_compression=dcn_compression)
        if grad_reduction == "overlapped":
            parts = self.model.parts
            n_stages = staging.resolve_overlap_stages(
                parts, overlap_stages, type(self).__name__)
            self._cuts = staging.split_points(n_stages, None,
                                              len(parts.blocks))

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters and BN state from `seed` (the same on every
        rank, so no broadcast is needed)."""
        params, model_state = self.model.init(
            torch.Generator().manual_seed(seed))
        return self.state_from_params(params, model_state)

    def state_from_params(self, params, model_state) -> TrainState:
        """A step-0 state around `params` and `model_state`, moved to the
        engine's device; each parameter becomes a leaf that requires
        grad. Layouts (channels-last conv weights) are kept."""
        params = tree_map(
            lambda t: t.detach().to(self.device, torch.float32)
            .clone().requires_grad_(True), params)
        model_state = tree_map(
            lambda t: t.detach().to(self.device, torch.float32).clone(),
            model_state)
        return TrainState(params, model_state, self.optimizer.init(params), 0)

    def shard_batch(self, images, labels):
        """This rank's host batch (numpy) -> tensors on the device, through
        pinned memory and an asynchronous copy on the card."""
        return tuple(self._place(a) for a in (images, labels))

    def _place(self, a) -> torch.Tensor:
        return place(a, self.device)

    # ------------------------------------------------------- collectives

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """SUM over the mesh's ranks, in place (the identity without a
        process group)."""
        if self.mesh.group is not None:
            dist.all_reduce(flat, group=self.mesh.group)
        return flat

    def _mean_over_ranks(self, tensors):
        """One flat buffer of `tensors`, all-reduced (SUM / world), split
        back into their shapes."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = self._all_reduce(flat) / self.mesh.data
        return [piece.view(t.shape) for piece, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def _sum_metrics(self, m: dict) -> dict:
        keys = sorted(m)
        flat = self._all_reduce(torch.stack([m[k].float() for k in keys]))
        return dict(zip(keys, flat.unbind()))

    # ------------------------------------------------------------- steps

    def loss_and_metrics(self, logits, labels):
        """The differentiated loss of one batch (the local mean
        cross-entropy) and its metric sums, the reference's hook."""
        ce = cross_entropy(logits, labels)
        return ce, _metrics(ce.detach(), logits.detach(), labels)

    def _input(self, images, step, train: bool):
        x = apply_input_transform(self.input_transform, images, step, train)
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        return x

    def _rank(self) -> int:
        return (0 if self.mesh.group is None
                else dist.get_rank(self.mesh.group))

    def _reduced(self, pending):
        self.grad_reductions += pending.collectives
        return pending.wait()

    def _forward_params(self, params, grad: bool = True):
        """The parameters the forward runs on: the state's own here;
        `FSDPEngine` gathers its shards."""
        return params

    def _local_grads(self, grads):
        """The slice of the mean gradients this rank's state updates:
        all of them here; `FSDPEngine` keeps its shards'."""
        return grads

    def _overlapped_grads(self, ts: TrainState, x, labels, ctx):
        """The stagewise backward, each stage's buckets issued from the
        hook; returns (logits, ce, mean gradients, new BN state)."""
        cuts = self._cuts
        pending = []

        def loss_head(logits):
            ce = cross_entropy(logits, labels)
            return ce, logits.detach()

        def reduce_stage(k, stage_grads):
            pending.append(self._reducer.issue(stage_grads, mean=True))

        ce, logits, _, stage_states = staging.stagewise_value_and_grad(
            staging.stage_apply_fns(self.model.parts, cuts, ctx), loss_head,
            staging.partition_tree(ts.params, cuts),
            staging.partition_tree(ts.model_state, cuts), x,
            aux_of_state=L.aux_loss, on_stage_grads=reduce_stage)
        stage_grads = [self._reduced(p) for p in reversed(pending)]
        return (logits, ce, staging.unpartition_tree(stage_grads, cuts),
                staging.unpartition_tree(stage_states, cuts))

    def train_step(self, ts: TrainState, images, labels, lr):
        """One optimizer step; parameters, BN state and optimizer state
        are updated in place. `lr` is a float or an f32 device scalar.
        Dropout draws from the key of (step, rank). Returns (state,
        metric sums over every rank). No host read of a device value:
        the step can be captured in a CUDA graph."""
        ctx = L.Context(train=True, dtype=self.compute_dtype,
                        bn_group=self._bn_group,
                        model_group=self._model_group,
                        expert_dispatch=self._expert_dispatch,
                        rng=step_key(ts.step, self._rank()))
        x = self._input(images, ts.step, True)
        if self._grad_reduction == "overlapped":
            logits, ce, grads, new_state = self._overlapped_grads(
                ts, x, labels, ctx)
            m = _metrics(ce.detach(), logits, labels)
        else:
            params = self._forward_params(ts.params)
            logits, new_state = self.model.apply(
                params, ts.model_state, x, ctx)
            ce, m = self.loss_and_metrics(logits, labels)
            aux = L.aux_loss(new_state)  # MoE load balance, else 0.0
            loss = ce + aux if torch.is_tensor(aux) else ce
            grads = torch.autograd.grad(loss, list(tree_leaves(params)))
            if self._reducer is not None:
                grads = self._reduced(self._reducer.issue(
                    _like(params, iter(grads)), mean=True))
            else:
                if self.mesh.group is not None:
                    self.grad_reductions += 1
                grads = _like(params, iter(self._mean_over_ranks(grads)))
            grads = self._local_grads(grads)
        state_leaves = [t.detach() for t in tree_leaves(new_state)]
        if not self._sync_bn and state_leaves:
            # Per-replica stats (and MoE aux values) averaged before they
            # are kept.
            new_state = _like(new_state, iter(self._mean_over_ranks(
                state_leaves)))
        write_back(ts.model_state, new_state)
        params, opt_state = self.optimizer.update(
            ts.params, ts.opt_state, grads, lr)
        return TrainState(params, ts.model_state, opt_state,
                          ts.step + 1), self._sum_metrics(m)

    @torch.no_grad()
    def eval_step(self, ts: TrainState, images, labels) -> dict:
        ctx = L.Context(train=False, dtype=self.compute_dtype,
                        model_group=self._model_group,
                        expert_dispatch=self._expert_dispatch)
        logits, _ = self.model.apply(self._forward_params(ts.params, False),
                                     ts.model_state,
                                     self._input(images, ts.step, False),
                                     ctx)
        return self._sum_metrics(self.loss_and_metrics(logits, labels)[1])


@dataclasses.dataclass
class DataParallelEngine(_DataParallel):
    """Global-batch data parallelism: BN statistics over the whole
    (global) batch. `mesh=None` takes this process's world
    (`runtime/mesh.make_mesh`)."""

    model: L.Layer
    optimizer: Any  # SGD | AdamW (training/optim.py)
    mesh: Optional[Mesh] = None
    # Activations in this dtype (bf16), parameters f32 masters cast per
    # use; None keeps the input dtype.
    compute_dtype: Optional[torch.dtype] = None
    # Applied to the batch on the device before the compute-dtype cast
    # (`data/loader.device_normalizer` for uint8 batches, or the device
    # cache's index transform: `apply_input_transform`).
    input_transform: Any = None
    device: Any = "cuda"

    def __post_init__(self):
        self._setup(sync_bn=True)
        self._expert_dispatch = GlobalAux(self.mesh.group)


@dataclasses.dataclass
class DDPEngine(_DataParallel):
    """Explicit-collective data parallelism: per-rank forward and
    backward, then the gradient mean over the ranks. `sync_bn=False`
    keeps per-replica BN; `sync_bn=True` is SyncBatchNorm.

    `grad_reduction`: "monolithic" is one all-reduce of the flattened
    gradients; "bucketed" is DDP's Reducer (`ops/grad_reduction.py`,
    `bucket_mb` MiB buckets, hierarchical over a `MeshSpec(dcn=K)`
    mesh); "overlapped" issues those buckets from a stagewise backward
    cut into `overlap_stages` segments (0 = min(4, the model's blocks)),
    late layers first. The same mean in all three, held against the
    reference engine in `tests/test_torch_port_grad_reduction.py`. `dcn_compression` ("none" | "bf16" |
    "int8", `ops/wire_codec.py`) compresses the cross-slice hop and
    needs a factored mesh; under "monolithic" it routes the reduction
    through one flat bucket per dtype.

    MoE models (`models/moe.py`): the aux loss of each rank's shard is
    added to its loss (the reference's shard_map semantics), and the aux
    values kept in the state are averaged over the ranks.
    `expert_dispatch="hierarchical"` runs each MoE layer's experts 1/S
    over the data fabric through the two-level exchange
    (`ops/expert_dispatch.LocalExpertDispatch`: whole weights in storage,
    each rank its E/S block); `expert_overlap=True` chunks the exchange
    so the FFN of one chunk runs while the next moves. It composes with
    every `grad_reduction` and with `dcn_compression`, which then codes
    the exchange's cross-slice hops too."""

    model: L.Layer
    optimizer: Any
    mesh: Optional[Mesh] = None
    sync_bn: bool = False
    compute_dtype: Optional[torch.dtype] = None  # see DataParallelEngine
    input_transform: Any = None                  # see DataParallelEngine
    grad_reduction: str = "monolithic"
    bucket_mb: float = 25.0
    overlap_stages: int = 0
    dcn_compression: str = "none"
    expert_dispatch: Optional[str] = None
    expert_overlap: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        if self.grad_reduction not in GRAD_REDUCTIONS:
            raise ValueError(
                "grad_reduction must be 'monolithic', 'bucketed' or "
                f"'overlapped', got {self.grad_reduction!r}"
            )
        check_compression(self.dcn_compression)
        if self.expert_dispatch not in (None, "hierarchical"):
            raise ValueError(
                "expert_dispatch must be None or 'hierarchical', got "
                f"{self.expert_dispatch!r}"
            )
        if self.expert_overlap and self.expert_dispatch is None:
            raise ValueError(
                "expert_overlap=True chunks the hierarchical MoE "
                "exchange; set expert_dispatch='hierarchical'"
            )
        self._setup(self.sync_bn, self.grad_reduction, self.bucket_mb,
                    self.overlap_stages, self.dcn_compression)
        if self.expert_dispatch == "hierarchical":
            self._expert_dispatch = LocalExpertDispatch(
                self.mesh.ici_group, self.mesh.dcn_group,
                overlap=self.expert_overlap,
                dcn_compression=self.dcn_compression)


__all__ = ["DDPEngine", "DataParallelEngine", "GRAD_REDUCTIONS",
           "TrainState", "_metrics", "apply_input_transform",
           "place", "step_key", "write_back"]
