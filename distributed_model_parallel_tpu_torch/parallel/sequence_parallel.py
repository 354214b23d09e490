"""Sequence-parallel training engines (port of
`parallel/sequence_parallel.py`): `CausalLMSequenceParallelEngine` (GPT
next-token training), `SequenceParallelEngine` (BERT classification)
and the `ATTENTION` registry, over a (data, seq) mesh of
`torch.distributed` ranks (`runtime/mesh.py`: rank = data_index * S +
seq_index; `seq_group` the S shards of a sequence, `group` the data
ranks of this rank's seq index, factored into `ici_group` x `dcn_group`
by `MeshSpec(dcn=K)`).

Token activations are sharded T/S a rank: each rank embeds its columns
of the sequence with the position rows of its offset (seq_index * T/S)
and runs the blocks on them; attention is the only cross-token op and
runs through the registry's ring or Ulysses over `seq_group`
(`ops/ring_attention.py`). Parameters are replicated. The reference's
step semantics are kept:

* `shard_batch` takes this rank's rows of the global batch (the data
  index's, the reference's dcn-major data sharding), builds the LM's
  next-token targets on the host from those GLOBAL rows (shard-boundary
  tokens included), then keeps this shard's columns;
* the LOCAL token-loss SUM is differentiated (no reduction before the
  gradient). The gradients are then SUMMED over the seq shards (each
  holds a complementary piece: other shards' tokens reach its K/V
  through the rings) and over the data ranks, and divided by max(global
  valid tokens, 1), the count summed over the mesh on the device.
  `grad_reduction="monolithic"` is one all-reduce of the flattened
  gradients over the mesh's `data_seq_group` (seq x data); "bucketed" is
  an all-reduce over `seq_group`, then the Reducer's buckets over the
  data groups (`ops/grad_reduction.py`, hierarchical over a factored
  mesh, the cross-slice hop optionally compressed); "overlapped" the
  same issued from a stagewise backward whose segments are the decoder
  blocks cut at `split_points` (the stem opening the first, the LM head
  closing the last). There the seq all-reduce of a segment runs
  synchronously on the compute stream before its data buckets are
  issued, so at S > 1 only the data part overlaps the backward. At one
  rank with no process group every reduction is the identity;
* the metric sums are summed over the seq shards and the data ranks;
* `optimizer.update` (in place here), metrics returned as sums;
* `compute_dtype` bf16 runs bf16 activations on f32 parameters;
* `remat=True` checkpoints each block (`models/gpt.py
  decoder_blocks`): its forward, the ring hops and the flash kernel K1
  included, runs again in the backward pass, on every rank alike;
* dropout draws from the key of (step, data index) (`step_key`), with
  the seq index folded in when S > 1 (the reference folds step, data
  index and seq index), so the shards draw different masks and a
  recompute and a graph replay draw the masks of the original forward.

`SequenceParallelEngine` is the BERT classifier on the same mesh: the
[CLS] token lives on seq shard 0, so the loss and the metrics are those
of shard 0 (every shard computes its head, masked by `is_cls`); the
gradients are summed over the seq shards and averaged over the data
ranks in one all-reduce over the mesh's `data_seq_group`, as the
reference's `pmean(psum(g, 'seq'), 'data')`.

The attention core comes from `ATTENTION`, the reference's registry:
`ulysses_flash` and `ring_flash` run the flash kernels
(`ops/flash_attention.py`), `ring` and `ulysses` plain torch.
`collective_matmul=True` runs the FFN pair of every block on the rings
over the seq group (`ops/collective_matmul.LocalCollectiveMatmul`: each
rank's column / row block of the whole weights, gathered over every
rank's positions and reduce-scattered back), the attention projections
unchanged; the FFN width must divide by S (the reference's message).
MoE configs are refused with the reference's NotImplementedError:
per-shard routing under 'seq' sharding would break the dense capacity
semantics, and the MoE text path is `parallel/expert_parallel.py`.
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
from distributed_model_parallel_tpu_torch.models.bert import (
    BertConfig,
    _cls_head,
    _embeddings,
    _encoder_blocks,
    embed_apply,
)
from distributed_model_parallel_tpu_torch.models.bert import (
    head_apply as cls_head_apply,
)
from distributed_model_parallel_tpu_torch.models.gpt import (
    block_apply,
    decoder_blocks,
    head_apply,
    init_params,
    lm_targets,
    stem_apply,
)
from distributed_model_parallel_tpu_torch.ops.collective_matmul import (
    LocalCollectiveMatmul,
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
    place,
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

def _ulysses_flash(*args, **kw):
    return ulysses_attention(*args, attention_impl=flash_attention, **kw)


ATTENTION = {
    "ring": ring_attention,
    "ring_flash": ring_flash_attention,  # flash kernels per hop
    "ulysses": ulysses_attention,
    "ulysses_flash": _ulysses_flash,     # flash kernels as the core
}


def _check_seq_len(ids, max_position: int, cfg_name: str) -> None:
    """Refuse global sequence lengths past the position table: a later
    seq shard would slice position rows the table does not have (the
    reference's message; its `dynamic_slice` would clamp and reuse the
    last rows)."""
    if ids.shape[1] > max_position:
        raise ValueError(
            f"global sequence length {ids.shape[1]} exceeds the "
            f"position table (max_position={max_position}); later 'seq' "
            f"shards would silently reuse position rows. Raise "
            f"{cfg_name}.max_position to at least the sequence length."
        )


def _seq_matmul_policy(enabled: bool, ffn_dim: int, mesh: Mesh):
    """The collective-matmul policy of the SP engines (None when off):
    `LocalCollectiveMatmul` over the seq group, the FFN pair only,
    validated here so a non-divisible FFN width fails at construction
    (the reference's message)."""
    if not enabled:
        return None
    if ffn_dim % mesh.seq:
        raise ValueError(
            f"collective_matmul=True chunks the FFN width over the "
            f"'seq' axis: intermediate/ffn dim {ffn_dim} must be "
            f"divisible by the {mesh.seq} sequence shards"
        )
    return LocalCollectiveMatmul(group=mesh.seq_group)


class _SeqAxis:
    """What both engines do with the (data, seq) mesh."""

    def _check_config(self, num_heads: int, ffn_dim: int) -> None:
        """The attention name, Ulysses' whole heads a shard (the
        reference's message), and the collective-matmul policy."""
        if self.attention not in ATTENTION:
            raise ValueError(
                f"attention must be one of {sorted(ATTENTION)}, "
                f"got {self.attention!r}"
            )
        n = self.mesh.seq
        if self.attention.startswith("ulysses") and num_heads % n:
            raise ValueError(f"ulysses needs heads ({num_heads}) divisible "
                             f"by 'seq' axis size ({n})")
        self._matmul = _seq_matmul_policy(self.collective_matmul, ffn_dim,
                                          self.mesh)

    def _ctx(self, train: bool, step=None) -> L.Context:
        """The context of a step: dropout keyed by `_key(step)` in
        training, the collective-matmul policy on the FFN pair."""
        return L.Context(train=train, dtype=self.compute_dtype,
                         rng=self._key(step) if train else None,
                         matmul=self._matmul)

    def _rank(self) -> int:
        """This rank's data index."""
        return (0 if self.mesh.group is None
                else dist.get_rank(self.mesh.group))

    def _key(self, step):
        """The dropout key of a train step: (step, data index), and the
        seq index when the sequence is sharded."""
        key = step_key(step, self._rank())
        return L.fold_in(key, self.mesh.seq_index) if self.mesh.seq > 1 \
            else key

    def _positions(self, table, t: int):
        """This shard's rows of a position table, for a local length t."""
        start = self.mesh.seq_index * t
        return table[start:start + t]

    def _rows(self, a) -> np.ndarray:
        """This rank's rows (its data index's) of a global host array."""
        a = np.asarray(a)
        d = self.mesh.data
        if a.shape[0] % d:
            raise ValueError(
                f"batch size {a.shape[0]} must be divisible by the "
                f"'data' mesh axis ({d} ranks)")
        rows = a.shape[0] // d
        return a[self._rank() * rows:(self._rank() + 1) * rows]

    def _cols(self, a) -> np.ndarray:
        """This shard's columns (its seq index's) of a (B, T) array."""
        n, t = self.mesh.seq, a.shape[1]
        if t % n:
            raise ValueError(
                f"sequence length {t} must be divisible by the 'seq' mesh "
                f"axis ({n} shards)")
        t //= n
        return a[:, self.mesh.seq_index * t:(self.mesh.seq_index + 1) * t]

    def _all_reduce(self, flat: torch.Tensor, group) -> torch.Tensor:
        if group is not None:
            dist.all_reduce(flat, group=group)
        return flat

    def _sum_metrics(self, m: dict) -> dict:
        """Metric sums over every rank of the mesh (one all-reduce)."""
        if self.mesh.data_seq_group is None:
            return {k: v.detach() for k, v in m.items()}
        keys = sorted(m)
        return dict(zip(keys, self._all_reduce(
            torch.stack([m[k].detach().float() for k in keys]),
            self.mesh.data_seq_group).unbind()))

    def _flat_sum(self, grads, group) -> list:
        """The gradients flattened, all-reduced over `group` and split
        back (one collective)."""
        self.grad_reductions += 1
        flat = self._all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                group)
        return [p.view(g.shape) for p, g in zip(
            flat.split([g.numel() for g in grads]), grads)]


@dataclasses.dataclass
class CausalLMSequenceParallelEngine(_SeqAxis):
    """GPT next-token training over the (data, seq) ranks of `mesh`
    (default: this process's world as data ranks of one shard,
    `runtime/mesh.make_mesh`). Parameters are the `gpt_lm` tree
    (`models/gpt.py`), so the reference's parameters cross with
    `models/convert.from_jax_params`. `grad_reduction`, `bucket_mb`,
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
        if self.grad_reduction not in GRAD_REDUCTIONS:
            raise ValueError(
                "grad_reduction must be 'monolithic', 'bucketed' or "
                f"'overlapped', got {self.grad_reduction!r}"
            )
        self.mesh = self.mesh or make_mesh()
        self._check_config(self.cfg.num_heads, self.cfg.ffn_dim)
        if getattr(self.cfg, "num_experts", 0) > 0:
            raise NotImplementedError(
                "GPTConfig.num_experts > 0 is not supported by "
                "CausalLMSequenceParallelEngine; train MoE LMs with "
                "parallel/expert_parallel.ExpertParallelLMEngine "
                "(cli/lm.py --moe-experts).")
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be None, float32 or bfloat16, got "
                f"{self.compute_dtype}"
            )
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
        #: monolithic with a process group, else the Reducer's buckets,
        #: plus one seq all-reduce a segment when S > 1)
        self.grad_reductions = 0
        self.device = torch.device(self.device)
        self._attn = partial(ATTENTION[self.attention], causal=True,
                             group=self.mesh.seq_group)

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

    def shard_batch(self, ids, labels=None):
        """The GLOBAL ids (B, T) host array -> this rank's block of ids
        and of their next-token targets, on the device: the data index's
        rows, their targets built from the whole rows, then the seq
        index's columns of both. `labels` is ignored (the targets are the
        shifted ids)."""
        _check_seq_len(ids, self.cfg.max_position, "GPTConfig")
        rows = self._rows(ids)
        targets = lm_targets(rows, pad_token_id=self.cfg.pad_token_id)
        to = partial(torch.as_tensor, device=self.device)
        return to(self._cols(rows)).long(), to(self._cols(targets)).long()

    # ------------------------------------------------------------- math

    def forward(self, params, ids, ctx: L.Context) -> torch.Tensor:
        """Local ids (B, T/S) -> local logits (B, T/S, vocab) f32. The
        position slice starts at this shard's offset, 0 at one shard."""
        x = stem_apply(params["stem"], ids, self.cfg, ctx.child(0),
                       positions=self._positions(params["stem"]["position"],
                                                 ids.shape[1]))
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
                    x = stem_apply(p["0"], x, cfg, ctx.child(0),
                                   positions=self._positions(
                                       p["0"]["position"], x.shape[1]))
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

    def _seq_summed(self, grads) -> list:
        """Gradients summed over the seq shards (the identity at one)."""
        grads = list(grads)
        if self.mesh.seq == 1:
            return grads
        return self._flat_sum(grads, self.mesh.seq_group)

    def grads(self, ts: TrainState, ids, targets):
        """(metric sums over the mesh, gradient tree) of one training
        step: the gradient of the local loss SUM, summed over the seq
        shards and the data ranks and divided by max(global valid
        tokens, 1). Dropout draws from `_key(step)`."""
        ctx = self._ctx(True, ts.step)
        leaves = list(tree_leaves(ts.params))
        if self.grad_reduction == "overlapped":
            pending = []

            def loss_head(logits):
                m = self.local_sums(logits, targets)
                return m["loss_sum"], m

            def reduce_segment(k, seg_grads):
                seg_grads = _like(seg_grads, iter(self._seq_summed(
                    tree_leaves(seg_grads))))
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
                    _like(ts.params, iter(self._seq_summed(grads)))))))
            elif self.mesh.data_seq_group is not None:
                grads = self._flat_sum(grads, self.mesh.data_seq_group)
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
        ctx = self._ctx(False)
        return self._sum_metrics(
            self.local_sums(self.forward(ts.params, ids, ctx), targets))


@dataclasses.dataclass
class SequenceParallelEngine(_SeqAxis):
    """BERT-family classification training with seq-sharded activations
    over the (data, seq) ranks of `mesh` (module docstring). Parameters
    and state are `bert_for_classification(num_classes, cfg)`'s, so
    checkpoints cross with `DDPEngine` and the reference. The global
    sequence length must be divisible by the seq axis (and, for
    Ulysses, the heads by it too)."""

    cfg: BertConfig
    num_classes: int
    optimizer: Any  # SGD | AdamW (training/optim.py)
    mesh: Optional[Mesh] = None
    attention: str = "ring"
    compute_dtype: Optional[torch.dtype] = None
    remat: bool = False
    collective_matmul: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        self.mesh = self.mesh or make_mesh()
        self._check_config(self.cfg.num_heads, self.cfg.intermediate_size)
        if self.cfg.num_experts > 0:
            raise NotImplementedError(
                "BertConfig.num_experts > 0 is not supported by "
                "SequenceParallelEngine; train MoE models with the "
                "DP / DDP / TensorParallel / ExpertParallel engines.")
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be None, float32 or bfloat16, got "
                f"{self.compute_dtype}"
            )
        self.device = torch.device(self.device)
        blocks = _encoder_blocks(self.cfg, partial(
            ATTENTION[self.attention], group=self.mesh.seq_group))
        if self.remat:
            blocks = [L.remat(b) for b in blocks]
        self._blocks = L.sequential(*blocks)
        self._init = L.named([
            ("stem", _embeddings(self.cfg)), ("blocks", self._blocks),
            ("head", _cls_head(self.cfg, self.num_classes))]).init
        #: gradient collectives issued (one all-reduce a step)
        self.grad_reductions = 0

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters from `seed`: `bert_for_classification`'s (and
        so `DDPEngine`'s) init, the same on every rank."""
        return self.state_from_params(
            *self._init(torch.Generator().manual_seed(seed)))

    def state_from_params(self, params, model_state=None) -> TrainState:
        """A step-0 state around `params`, on the engine's device; each
        leaf becomes a leaf tensor that requires grad."""
        params = tree_map(
            lambda t: t.detach().to(self.device, torch.float32)
            .clone().requires_grad_(True), params)
        if model_state is None:
            model_state = {"stem": {}, "blocks": {
                str(i): {} for i in range(self.cfg.num_layers)}, "head": {}}
        return TrainState(params, model_state, self.optimizer.init(params),
                          0)

    def shard_batch(self, ids, labels):
        """Global ids (B, T) and labels (B,) host arrays -> this rank's
        block of ids (data rows, seq columns) and its rows' labels, on
        the device."""
        _check_seq_len(ids, self.cfg.max_position, "BertConfig")
        return (place(self._cols(self._rows(ids)), self.device),
                place(self._rows(labels), self.device))

    # ------------------------------------------------------------- math

    def forward(self, params, model_state, ids, ctx: L.Context):
        """Local ids (B, T/S) -> ([CLS] logits (B, C) f32, is_cls): the
        dense model's stem / blocks / head with the position slice at
        this shard's offset; only shard 0's token 0 is the [CLS], so
        `is_cls` (1.0 on shard 0, else 0.0) masks the other shards'
        logits out of the loss and the metrics."""
        h, mask = embed_apply(
            params["stem"], ids, self.cfg, ctx.child(0),
            positions=self._positions(params["stem"]["position"],
                                      ids.shape[1]))
        (h, _), _ = self._blocks.apply(params["blocks"],
                                       model_state["blocks"], (h, mask),
                                       ctx.child(1))
        logits = cls_head_apply(params["head"], h[:, 0, :])
        return logits, float(self.mesh.seq_index == 0)

    def _masked_sums(self, ce, logits, labels, is_cls: float) -> dict:
        m = _metrics(ce.detach(), logits.detach(), labels)
        return self._sum_metrics({k: v * is_cls for k, v in m.items()})

    def train_step(self, ts: TrainState, ids, labels, lr):
        """One optimizer step; parameters and optimizer state are updated
        in place. The loss is shard 0's local mean cross-entropy; the
        gradients are summed over the seq shards and averaged over the
        data ranks (one all-reduce over `data_seq_group`). Returns
        (state, metric sums over the mesh)."""
        ctx = self._ctx(True, ts.step)
        logits, is_cls = self.forward(ts.params, ts.model_state, ids, ctx)
        ce = cross_entropy(logits, labels) * is_cls
        grads = torch.autograd.grad(ce, list(tree_leaves(ts.params)))
        if self.mesh.data_seq_group is not None:
            grads = self._flat_sum(grads, self.mesh.data_seq_group)
        params, opt_state = self.optimizer.update(
            ts.params, ts.opt_state,
            _like(ts.params, (g / self.mesh.data for g in grads)), lr)
        return (TrainState(params, ts.model_state, opt_state, ts.step + 1),
                self._masked_sums(ce, logits, labels, is_cls))

    @torch.no_grad()
    def eval_step(self, ts: TrainState, ids, labels) -> dict:
        logits, is_cls = self.forward(
            ts.params, ts.model_state, ids, self._ctx(False))
        ce = cross_entropy(logits, labels) * is_cls
        return self._masked_sums(ce, logits, labels, is_cls)


__all__ = ["ATTENTION", "CausalLMSequenceParallelEngine",
           "SequenceParallelEngine"]
