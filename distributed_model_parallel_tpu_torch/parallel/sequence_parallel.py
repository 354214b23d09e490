"""Causal-LM training engine (port of `CausalLMSequenceParallelEngine`
and `ATTENTION` from `parallel/sequence_parallel.py`) for one process on
one device: one sequence shard, one data replica.

The reference's step semantics are kept:

* targets are built on the host (`shard_batch` -> `gpt.lm_targets`) and
  placed beside the ids;
* the LOCAL token-loss SUM is differentiated (no reduction before the
  gradient), and the gradients are divided by max(valid tokens, 1) — at
  one shard and one replica the reference's psum over ('seq', data) is
  the identity;
* `optimizer.update` (in place here), metrics returned as sums;
* `compute_dtype` bf16 runs bf16 activations on f32 parameters;
* `remat=True` checkpoints each decoder block (`models/gpt.py
  decoder_blocks`): its forward, the flash kernel K1 included, runs
  again in the backward pass;
* dropout draws from the key of the step (`step_key`), so a recompute
  and a graph replay draw the masks of the original forward.

The attention core comes from `ATTENTION`, the reference's registry:
`ulysses_flash` and `ring_flash` run the flash kernels
(`ops/flash_attention.py`), `ring` and `ulysses` plain torch. Features
of later slices are refused with a ValueError naming the slice.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.gpt import (
    decoder_blocks,
    head_apply,
    init_params,
    lm_targets,
    stem_apply,
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
    TrainState,
    _like,
    _metrics,
    step_key,
)
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_map,
)

# Later port slices (ROADMAP.md), named by the refusals below.
CM_SLICE = "the collective-matmul slice"
GRAD_REDUCTION_SLICE = "the gradient-reduction slice"
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
    """GPT next-token training on one device. Parameters are the
    `gpt_lm` tree (`models/gpt.py`), so the reference's parameters cross
    with `models/convert.from_jax_params`. The reference's mesh is
    absent: more than one shard is the sequence-parallel and data-
    parallel slices' work (the LM CLI refuses --seq-shards > 1)."""

    cfg: Any  # models.gpt.GPTConfig
    optimizer: Any  # SGD | AdamW (training/optim.py)
    attention: str = "ring"
    compute_dtype: Optional[torch.dtype] = None
    remat: bool = False
    collective_matmul: bool = False
    grad_reduction: str = "monolithic"
    dcn_compression: str = "none"
    device: Any = "cuda"

    def __post_init__(self):
        if self.attention not in ATTENTION:
            raise ValueError(
                f"attention must be one of {sorted(ATTENTION)}, "
                f"got {self.attention!r}"
            )
        if self.collective_matmul:
            raise _not_ported("collective_matmul", CM_SLICE)
        if self.grad_reduction != "monolithic":
            raise _not_ported(f"grad_reduction={self.grad_reduction!r}",
                              GRAD_REDUCTION_SLICE)
        if self.dcn_compression != "none":
            raise _not_ported(f"dcn_compression={self.dcn_compression!r}",
                              GRAD_REDUCTION_SLICE)
        if getattr(self.cfg, "num_experts", 0) > 0:
            raise _not_ported("GPTConfig.num_experts > 0", MOE_SLICE)
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be None, float32 or bfloat16, got "
                f"{self.compute_dtype}"
            )
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

    def shard_batch(self, ids, labels=None):
        """ids (B, T) host array -> (ids, next-token targets) on the
        device. `labels` is ignored (the targets are the shifted ids)."""
        if ids.shape[1] > self.cfg.max_position:
            raise ValueError(
                f"sequence length {ids.shape[1]} exceeds the position "
                f"table (max_position={self.cfg.max_position})"
            )
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

    def grads(self, ts: TrainState, ids, targets):
        """(metric sums, gradient tree) of one training step: the
        gradient of the local loss SUM, divided by max(valid tokens, 1).
        Dropout draws from the key of the step."""
        ctx = L.Context(train=True, dtype=self.compute_dtype,
                        rng=step_key(ts.step))
        m = self.local_sums(self.forward(ts.params, ids, ctx), targets)
        grads = torch.autograd.grad(m["loss_sum"],
                                    list(tree_leaves(ts.params)))
        n = m["count"].clamp_min(1.0)
        grad_tree = _like(ts.params, iter(g / n for g in grads))
        return {k: v.detach() for k, v in m.items()}, grad_tree

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
        return self.local_sums(self.forward(ts.params, ids, ctx), targets)


__all__ = ["ATTENTION", "CausalLMSequenceParallelEngine"]
