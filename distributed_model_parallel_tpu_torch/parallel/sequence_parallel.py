"""Causal-LM training engine (port of `CausalLMSequenceParallelEngine`
and `ATTENTION` from `parallel/sequence_parallel.py`): one sequence
shard, and a data axis over `torch.distributed` ranks (the mesh's
`group`, factored into `ici_group` x `dcn_group` by `MeshSpec(dcn=K)`).

The reference's step semantics are kept:

* each rank takes its rows of the global batch (`shard_batch`: rank r
  gets rows [rB/D, (r+1)B/D), the reference's dcn-major data sharding);
  targets are built on the host (`gpt.lm_targets`) and placed beside the
  ids;
* the LOCAL token-loss SUM is differentiated (no reduction before the
  gradient). The gradients are then SUMMED over the data ranks and
  divided by max(global valid tokens, 1), the count all-reduced on the
  device: `grad_reduction="monolithic"` is one all-reduce of the
  flattened gradients, "bucketed" the Reducer's buckets
  (`ops/grad_reduction.py`, hierarchical over a factored mesh, the
  cross-slice hop optionally compressed), "overlapped" the same buckets
  issued from a stagewise backward whose segments are the decoder
  blocks cut at `split_points` (the stem opening the first, the LM head
  closing the last); at one rank with no process group every reduction
  is the identity;
* the metric sums are summed over the data ranks;
* `optimizer.update` (in place here), metrics returned as sums;
* `compute_dtype` bf16 runs bf16 activations on f32 parameters;
* `remat=True` checkpoints each decoder block (`models/gpt.py
  decoder_blocks`): its forward, the flash kernel K1 included, runs
  again in the backward pass;
* dropout draws from the key of (step, rank) (`step_key`), so a
  recompute and a graph replay draw the masks of the original forward.

The attention core comes from `ATTENTION`, the reference's registry:
`ulysses_flash` and `ring_flash` run the flash kernels
(`ops/flash_attention.py`), `ring` and `ulysses` plain torch. Features
of later slices are refused with a ValueError naming the slice.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models.gpt import (
    block_apply,
    decoder_blocks,
    head_apply,
    init_params,
    lm_targets,
    stem_apply,
)
from distributed_model_parallel_tpu_torch.ops.grad_reduction import (
    MONOLITHIC_BUCKET_MB,
    Reducer,
)
from distributed_model_parallel_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from distributed_model_parallel_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_flash_attention,
    ulysses_attention,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    GRAD_REDUCTIONS,
    TrainState,
    _like,
    _metrics,
    step_key,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh, make_mesh
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_map,
)

# Later port slices (ROADMAP.md), named by the refusals below.
CM_SLICE = "the collective-matmul slice"
MOE_SLICE = "the expert-parallel slice"


def _ulysses_flash(*args, **kw):
    return ulysses_attention(*args, attention_impl=flash_attention, **kw)


ATTENTION = {
    "ring": ring_attention,
    "ring_flash": ring_flash_attention,  # flash kernels per hop
    "ulysses": ulysses_attention,
    "ulysses_flash": _ulysses_flash,     # flash kernels as the core
}


def _not_ported(knob: str, later: str) -> ValueError:
    return ValueError(
        f"{knob} is not ported to the PyTorch package yet: it belongs to "
        f"{later} (ROADMAP.md)"
    )


@dataclasses.dataclass
class CausalLMSequenceParallelEngine:
    """GPT next-token training over the data ranks of `mesh` (default:
    this process's world, `runtime/mesh.make_mesh`), one sequence shard
    each. Parameters are the `gpt_lm` tree (`models/gpt.py`), so the
    reference's parameters cross with `models/convert.from_jax_params`.
    More than one sequence shard is the sequence-parallel slice's work
    (the LM CLI refuses --seq-shards > 1). `grad_reduction`, `bucket_mb`,
    `overlap_stages` (0 = min(4, cfg.num_layers)) and `dcn_compression`
    are the reference's, as on `DDPEngine`."""

    cfg: Any  # models.gpt.GPTConfig
    optimizer: Any  # SGD | AdamW (training/optim.py)
    attention: str = "ring"
    compute_dtype: Optional[torch.dtype] = None
    remat: bool = False
    collective_matmul: bool = False
    grad_reduction: str = "monolithic"
    dcn_compression: str = "none"
    device: Any = "cuda"
    mesh: Optional[Mesh] = None
    bucket_mb: float = 25.0
    overlap_stages: int = 0

    def __post_init__(self):
        if self.attention not in ATTENTION:
            raise ValueError(
                f"attention must be one of {sorted(ATTENTION)}, "
                f"got {self.attention!r}"
            )
        if self.grad_reduction not in GRAD_REDUCTIONS:
            raise ValueError(
                "grad_reduction must be 'monolithic', 'bucketed' or "
                f"'overlapped', got {self.grad_reduction!r}"
            )
        if self.collective_matmul:
            raise _not_ported("collective_matmul", CM_SLICE)
        if getattr(self.cfg, "num_experts", 0) > 0:
            raise _not_ported("GPTConfig.num_experts > 0", MOE_SLICE)
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be None, float32 or bfloat16, got "
                f"{self.compute_dtype}"
            )
        self.mesh = self.mesh or make_mesh()
        overlapped = self.grad_reduction == "overlapped"
        if overlapped:
            if self.cfg.num_layers < 2:
                raise ValueError(
                    "CausalLMSequenceParallelEngine: grad_reduction="
                    "'overlapped' splits the decoder stack into >= 2 "
                    f"backward segments; cfg.num_layers={self.cfg.num_layers}"
                )
            n_over = staging.resolve_overlap_segments(
                self.cfg.num_layers, self.overlap_stages,
                "CausalLMSequenceParallelEngine", noun="decoder blocks")
            self._cuts = staging.split_points(n_over, None,
                                              self.cfg.num_layers)
        # Monolithic + compression routes the data reduction through one
        # flat bucket per dtype, so the 'dcn' hop has a seam to compress.
        self._reducer = None
        if self.grad_reduction != "monolithic" or \
                self.dcn_compression != "none":
            self._reducer = Reducer(
                self.mesh.ici_group, self.mesh.dcn_group,
                bucket_mb=(self.bucket_mb if self.grad_reduction !=
                           "monolithic" else MONOLITHIC_BUCKET_MB),
                dcn_compression=self.dcn_compression)
        #: gradient collectives issued (one all-reduce a step under
        #: monolithic with a process group, else the Reducer's buckets)
        self.grad_reductions = 0
        self.device = torch.device(self.device)
        self._attn = partial(ATTENTION[self.attention], causal=True)

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters from `seed` (models/gpt.init_params)."""
        return self.state_from_params(
            init_params(self.cfg, seed, device=self.device))

    def state_from_params(self, params) -> TrainState:
        """A step-0 state around `params` (moved to the engine's device;
        each leaf becomes a leaf tensor that requires grad)."""
        params = tree_map(
            lambda t: t.detach().to(self.device, torch.float32)
            .clone().requires_grad_(True),
            params,
        )
        return TrainState(params, {}, self.optimizer.init(params), 0)

    def _rank(self) -> int:
        return (0 if self.mesh.group is None
                else dist.get_rank(self.mesh.group))

    def shard_batch(self, ids, labels=None):
        """The GLOBAL ids (B, T) host array -> this rank's rows and their
        next-token targets, on the device. `labels` is ignored (the
        targets are the shifted ids)."""
        if ids.shape[1] > self.cfg.max_position:
            raise ValueError(
                f"sequence length {ids.shape[1]} exceeds the position "
                f"table (max_position={self.cfg.max_position})"
            )
        d = self.mesh.data
        if ids.shape[0] % d:
            raise ValueError(
                f"batch size {ids.shape[0]} must be divisible by the "
                f"'data' mesh axis ({d} ranks)")
        rows = ids.shape[0] // d
        r = self._rank()
        ids = np.asarray(ids)[r * rows:(r + 1) * rows]
        targets = lm_targets(ids, pad_token_id=self.cfg.pad_token_id)
        to = partial(torch.as_tensor, device=self.device)
        return to(ids).long(), to(targets).long()

    # ------------------------------------------------------------- math

    def forward(self, params, ids, ctx: L.Context) -> torch.Tensor:
        """ids (B, T) -> logits (B, T, vocab) f32. The position slice
        starts at this shard's offset, 0 at one shard."""
        t = ids.shape[1]
        x = stem_apply(params["stem"], ids, self.cfg, ctx.child(0),
                       positions=params["stem"]["position"][:t])
        h, _ = decoder_blocks(params["blocks"], x, self.cfg, ctx.child(1),
                              self._attn, remat=self.remat)
        return head_apply(params["head"], h)

    @staticmethod
    def local_sums(logits, targets) -> dict:
        b, t, v = logits.shape
        flat_logits = logits.reshape(b * t, v)
        flat_t = targets.reshape(b * t)
        return _metrics(cross_entropy(flat_logits, flat_t), flat_logits,
                        flat_t)

    def _segment_fns(self, ctx: L.Context):
        """The overlapped backward's segments: the decoder blocks cut at
        `self._cuts`, the stem opening the first and the LM head closing
        the last, with `forward`'s `Context.child` chain. Segment trees
        are `partition_tree`'s ('0' the stem on the first, blocks, then
        the head); the (hidden, mask) pair rides between segments."""
        cuts, cfg, n = self._cuts, self.cfg, len(self._cuts) - 1
        block_ctx = ctx.child(1)

        def segment(i):
            def fn(p, _state, x):
                k = 0
                if i == 0:
                    t = x.shape[1]
                    x = stem_apply(p["0"], x, cfg, ctx.child(0),
                                   positions=p["0"]["position"][:t])
                    k = 1
                for j in range(cuts[i], cuts[i + 1]):
                    x = block_apply(p[str(k)], x, cfg, block_ctx.child(j),
                                    self._attn, remat=self.remat)
                    k += 1
                if i == n - 1:
                    x = head_apply(p[str(k)], x[0])
                return x, {}

            return fn

        return [segment(i) for i in range(n)]

    def _sum_over_ranks(self, flat: torch.Tensor) -> torch.Tensor:
        if self.mesh.group is not None:
            dist.all_reduce(flat, group=self.mesh.group)
        return flat

    def _sum_metrics(self, m: dict) -> dict:
        """Metric sums over the data ranks (one all-reduce)."""
        if self.mesh.group is None:
            return {k: v.detach() for k, v in m.items()}
        keys = sorted(m)
        return dict(zip(keys, self._sum_over_ranks(
            torch.stack([m[k].detach().float() for k in keys])).unbind()))

    def grads(self, ts: TrainState, ids, targets):
        """(metric sums over the data ranks, gradient tree) of one
        training step: the gradient of the local loss SUM, summed over
        the data ranks and divided by max(global valid tokens, 1).
        Dropout draws from the key of (step, rank)."""
        ctx = L.Context(train=True, dtype=self.compute_dtype,
                        rng=step_key(ts.step, self._rank()))
        leaves = list(tree_leaves(ts.params))
        if self.grad_reduction == "overlapped":
            pending = []

            def loss_head(logits):
                m = self.local_sums(logits, targets)
                return m["loss_sum"], m

            def reduce_segment(k, seg_grads):
                pending.append(self._reducer.issue(seg_grads))

            _, m, _, _ = staging.stagewise_value_and_grad(
                self._segment_fns(ctx), loss_head,
                staging.partition_tree(ts.params, self._cuts),
                [None] * (len(self._cuts) - 1), ids,
                on_stage_grads=reduce_segment)
            seg = [self._wait(p) for p in reversed(pending)]
            grads = list(tree_leaves(staging.unpartition_tree(
                seg, self._cuts)))
        else:
            m = self.local_sums(self.forward(ts.params, ids, ctx), targets)
            grads = torch.autograd.grad(m["loss_sum"], leaves)
            if self._reducer is not None:
                grads = list(tree_leaves(self._wait(self._reducer.issue(
                    _like(ts.params, iter(grads))))))
            elif self.mesh.group is not None:
                self.grad_reductions += 1
                flat = self._sum_over_ranks(
                    torch.cat([g.reshape(-1) for g in grads]))
                grads = [p.view(g.shape) for p, g in zip(
                    flat.split([g.numel() for g in grads]), grads)]
        sums = self._sum_metrics(m)
        n = sums["count"].clamp_min(1.0)
        return sums, _like(ts.params, iter(g / n for g in grads))

    def _wait(self, pending):
        self.grad_reductions += pending.collectives
        return pending.wait()

    def train_step(self, ts: TrainState, ids, targets, lr):
        """One optimizer step; the state's parameters and optimizer state
        are updated in place. Returns (state, metric sums)."""
        metrics, grad_tree = self.grads(ts, ids, targets)
        params, opt_state = self.optimizer.update(
            ts.params, ts.opt_state, grad_tree, lr)
        return TrainState(params, ts.model_state, opt_state,
                          ts.step + 1), metrics

    @torch.no_grad()
    def eval_step(self, ts: TrainState, ids, targets) -> dict:
        ctx = L.Context(train=False, dtype=self.compute_dtype)
        return self._sum_metrics(
            self.local_sums(self.forward(ts.params, ids, ctx), targets))


__all__ = ["ATTENTION", "CausalLMSequenceParallelEngine"]
