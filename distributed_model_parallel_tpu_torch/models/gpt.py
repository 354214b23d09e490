"""Decoder-only causal language model, post-LN (port of `models/gpt.py`).

Parameters are the reference's `gpt_lm` tree as nested dicts of
tensors:

  {"stem":   {"word": (vocab, dim), "position": (max_position, dim)},
   "blocks": {"0": {"attn": {"qkv": {w, b}, "out": {w, b}},
                    "ln1": {scale, bias},
                    "ffn": {"in": {w, b}, "out": {w, b}},
                    "ln2": {scale, bias}}, "1": ...},
   "head":   {"w": (dim, vocab)}}

with linear weights stored (K, N). `models/convert.py` moves a tree
between the packages. ids (B, T) int -> logits (B, T, vocab) f32.

The pipeline engine takes the same model as `Layer` stages
(`split_stages`): the stem (ids -> (hidden, mask)), one `Layer` per
decoder block, and a head that flattens the logits to (B*T, vocab);
each block runs the same `_block` body as `decoder_blocks`.
`gpt_lm_model` is the whole model as one `Layer` (the reference's
`gpt_lm(cfg)`: `staging.staged_model` of stem, blocks and head), which
the expert-parallel LM engine drives.

Mixture-of-Experts: `num_experts > 0` makes every `moe_every`-th block
(1-based) a routed MoE block (`models/moe.py`, eps 1e-5), whose
parameters are {"attn", "ln1", "moe": {"router", "experts"}, "ln2"} and
whose state carries the load-balance loss ("moe_aux"). MoE stacks run as
`Layer`s only (`gpt_lm_model`, `decoder_block_layers`): the functional
forward (`decoder_blocks`, `gpt_lm`) has no state to return it through
and refuses them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import moe
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models.transformer import (
    AttentionFn,
    encoder_layer,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
)

# The block's LayerNorm epsilon (the reference passes eps=1e-5).
EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Defaults are GPT-2 small's published widths (the reference's
    defaults): vocab 50257, dim 768, 12 layers, 12 heads, ffn 3072,
    1024 positions."""

    vocab_size: int = 50257
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position: int = 1024
    dropout_rate: float = 0.1
    # id treated as padding in the attention mask; None = every
    # position is real.
    pad_token_id: Optional[int] = None
    # Mixture-of-Experts: num_experts > 0 swaps the FFN of every
    # `moe_every`-th block for a routed MoE (`models/moe.py`).
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25


def _normal(g: torch.Generator, *shape) -> torch.Tensor:
    return 0.02 * torch.randn(shape, generator=g, device=g.device)


def _init_stem(cfg: GPTConfig, g: torch.Generator) -> dict:
    return {"word": _normal(g, cfg.vocab_size, cfg.dim),
            "position": _normal(g, cfg.max_position, cfg.dim)}


def _init_block(cfg: GPTConfig, g: torch.Generator,
                moe_block: bool = False) -> dict:
    device = g.device

    def normal(*shape):
        return _normal(g, *shape)

    def linear(d_in, d_out):
        return {"w": normal(d_in, d_out),
                "b": torch.zeros(d_out, device=device)}

    def norm():
        return {"scale": torch.ones(cfg.dim, device=device),
                "bias": torch.zeros(cfg.dim, device=device)}

    block = {"attn": {"qkv": linear(cfg.dim, 3 * cfg.dim),
                      "out": linear(cfg.dim, cfg.dim)},
             "ln1": norm()}  # drawn first: a seed gives the same weights
    if moe_block:
        block["moe"] = moe.moe_params(g, cfg.dim, cfg.ffn_dim,
                                      cfg.num_experts)
    else:
        block["ffn"] = {"in": linear(cfg.dim, cfg.ffn_dim),
                        "out": linear(cfg.ffn_dim, cfg.dim)}
    block["ln2"] = norm()
    return block


def _init_head(cfg: GPTConfig, g: torch.Generator) -> dict:
    return {"w": _normal(g, cfg.dim, cfg.vocab_size)}


def is_moe_block(cfg: GPTConfig, i: int) -> bool:
    """Whether block i is a MoE block: every `moe_every`-th, 1-based."""
    return cfg.num_experts > 0 and (i + 1) % cfg.moe_every == 0


def _check_moe_every(cfg) -> None:
    if cfg.num_experts > 0 and cfg.moe_every < 1:
        raise ValueError(
            f"moe_every must be >= 1 when num_experts > 0, got "
            f"{cfg.moe_every} (1 = every layer, 2 = every other, ...)")


def init_params(cfg: GPTConfig, seed: int = 0, device="cpu") -> dict:
    """Fresh parameters from `seed` (0.02-scaled normals for embeddings,
    head and projection weights; zero biases; unit LayerNorm scales),
    drawn on `device` by a `torch.Generator`. The reference's init draws
    from jax.random, so the numbers differ; parity runs carry one tree
    across with `models/convert.py`."""
    _check_moe_every(cfg)
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    blocks = {str(i): _init_block(cfg, g, is_moe_block(cfg, i))
              for i in range(cfg.num_layers)}
    return {"stem": _init_stem(cfg, g), "blocks": blocks,
            "head": _init_head(cfg, g)}


def stem_apply(params, ids: torch.Tensor, cfg: GPTConfig, ctx: L.Context,
               *, positions: Optional[torch.Tensor] = None):
    """Token + position embeddings, then dropout. `positions` (T, dim)
    replaces the table's first T rows (a sequence shard passes its own
    slice). Returns (hidden, mask)."""
    mask = (
        torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        if cfg.pad_token_id is None else ids != cfg.pad_token_id
    )
    pos = (params["position"][: ids.shape[1]] if positions is None
           else positions)
    h = params["word"][ids] + pos[None]
    if ctx.dtype is not None:
        h = h.to(ctx.dtype)
    return L.dropout(h, cfg.dropout_rate, ctx), mask


def head_apply(params, h: torch.Tensor) -> torch.Tensor:
    """Untied vocabulary projection; logits in f32."""
    return h.float() @ params["w"]


def _attention(attention_fn: Optional[AttentionFn]):
    return attention_fn or partial(dot_product_attention, causal=True)


def _dense_only(cfg: GPTConfig, what: str) -> None:
    if cfg.num_experts > 0:
        raise NotImplementedError(
            f"{what} runs dense decoder blocks only: a MoE stack "
            "(num_experts > 0) returns its load-balance loss through the "
            "layer state, so it runs as a Layer (gpt_lm_model, the "
            "expert-parallel LM engine)")


def _block(params, x, cfg: GPTConfig, ctx: L.Context, attn):
    """One post-LN decoder block over (hidden, mask)."""
    return encoder_layer(params, x, ctx, num_heads=cfg.num_heads,
                         dropout_rate=cfg.dropout_rate, eps=EPS,
                         attention_fn=attn)


def decoder_blocks(params, x, cfg: GPTConfig, ctx: L.Context,
                   attention_fn: Optional[AttentionFn] = None, *,
                   remat: bool = False):
    """Run the block stack `params` ({"0": ..., "1": ...}) over
    (hidden, mask); the default core is causal dense attention. Blocks
    apply in order, so a stateful `attention_fn` (the cache recorders)
    sees layer 0, 1, ... in turn; block i draws its dropout bits as the
    reference's child i of the stack. `remat=True` checkpoints each
    block (`layers.remat`: its forward, the attention kernel included,
    runs again in the backward pass)."""
    _dense_only(cfg, "decoder_blocks")
    attn = _attention(attention_fn)
    for i in range(cfg.num_layers):
        x = block_apply(params[str(i)], x, cfg, ctx.child(i), attn,
                        remat=remat)
    return x


def block_apply(params, x, cfg: GPTConfig, ctx: L.Context, attn, *,
                remat: bool = False):
    """One decoder block over (hidden, mask), under
    `torch.utils.checkpoint` when `remat` and autograd is on."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(_block, params, x, cfg, ctx, attn,
                          use_reentrant=False, preserve_rng_state=False)
    return _block(params, x, cfg, ctx, attn)


def _lm_stem(cfg: GPTConfig) -> L.Layer:
    """Token + position embeddings, dropout: ids -> (hidden, mask)."""

    def init(gen):
        return _init_stem(cfg, gen), {}

    def apply(params, state, ids, ctx):
        return stem_apply(params, ids, cfg, ctx), state

    return L.Layer(init, apply)


def decoder_block_layers(cfg: GPTConfig,
                         attention_fn: Optional[AttentionFn] = None):
    """The decoder blocks as a list of `Layer`s over (hidden, mask), for
    the pipeline stages and `gpt_lm_model`; the dense ones run the same
    block body as `decoder_blocks`, every `moe_every`-th is
    `moe.moe_encoder_layer` (eps 1e-5) when `num_experts > 0`."""
    _check_moe_every(cfg)
    attn = _attention(attention_fn)

    def init(gen):
        return _init_block(cfg, gen), {}

    def apply(params, state, x, ctx):
        return _block(params, x, cfg, ctx, attn), state

    dense = L.Layer(init, apply)
    return [moe.moe_encoder_layer(
        cfg.dim, cfg.num_heads, cfg.ffn_dim, cfg.num_experts,
        top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
        dropout_rate=cfg.dropout_rate, eps=EPS, attention_fn=attn)
        if is_moe_block(cfg, i) else dense for i in range(cfg.num_layers)]


def _lm_head(cfg: GPTConfig) -> L.Layer:
    """The untied head over (hidden, mask): logits (B, T, vocab) f32."""

    def init(gen):
        return _init_head(cfg, gen), {}

    def apply(params, state, x, ctx):
        return head_apply(params, x[0]), state

    return L.Layer(init, apply)


def gpt_lm_model(cfg: GPTConfig, *,
                 attention_fn: Optional[AttentionFn] = None,
                 remat: bool = False) -> L.Layer:
    """The whole LM as one `Layer` (the reference's `gpt_lm(cfg)`): ids
    (B, T) -> logits (B, T, vocab) f32, the tree {"stem", "blocks":
    {"0", ...}, "head"} of `init_params` and state {"stem": {},
    "blocks": {i: {} or {"moe": {"moe_aux"}}}, "head": {}}. `remat=True`
    checkpoints each block (`layers.remat`)."""
    blocks = decoder_block_layers(cfg, attention_fn)
    if remat:
        blocks = [L.remat(b) for b in blocks]
    return staging.staged_model(_lm_stem(cfg), blocks, _lm_head(cfg),
                                nhwc=False)


def _lm_head_flat(cfg: GPTConfig) -> L.Layer:
    """The untied head for pipeline stages: the `head_apply` logits
    flattened (B, T, vocab) -> (B*T, vocab), the pipeline engine's
    (rows, classes) last-stage contract; targets are flattened the same
    way (`lm_targets(ids).reshape(-1)`)."""

    def init(gen):
        return _init_head(cfg, gen), {}

    def apply(params, state, x, ctx):
        logits = head_apply(params, x[0])
        b, t, v = logits.shape
        return logits.reshape(b * t, v), state

    return L.Layer(init, apply)


def split_stages(num_stages: int, cfg: GPTConfig, *, boundaries=None,
                 attention_fn: Optional[AttentionFn] = None):
    """Pipeline stages of the decoder LM (`models/staging.py`): the stem
    on stage 0, the blocks spread, the flattening head on the last. The
    wire carries the (hidden, mask) pair between stages."""
    blocks = decoder_block_layers(cfg, attention_fn)
    cuts = staging.split_points(num_stages, boundaries, len(blocks))
    return staging.assemble_stages(blocks, _lm_stem(cfg), _lm_head_flat(cfg),
                                   cuts)


def gpt_lm(params, ids: torch.Tensor, cfg: GPTConfig,
           ctx: Optional[L.Context] = None, *,
           attention_fn: Optional[AttentionFn] = None) -> torch.Tensor:
    """Full-sequence forward: ids (B, T) -> logits (B, T, vocab) f32 (the
    recompute oracle the cached decode is held against)."""
    _dense_only(cfg, "gpt_lm")
    ctx = ctx or L.Context()
    x = stem_apply(params["stem"], ids, cfg, ctx.child(0))
    h, _ = decoder_blocks(params["blocks"], x, cfg, ctx.child(1),
                          attention_fn)
    return head_apply(params["head"], h)


def lm_targets(ids, pad_token_id: Optional[int] = None) -> np.ndarray:
    """Per-position next-token targets on the host: targets[t] =
    ids[t+1], the last position and pad targets -1 (the label
    `cross_entropy` excludes). int32 before the -1 fill, so an unsigned
    ids dtype cannot wrap the sentinel."""
    ids = np.asarray(ids).astype(np.int32)
    targets = np.concatenate(
        [ids[:, 1:], np.full((ids.shape[0], 1), -1, np.int32)], axis=1
    )
    if pad_token_id is not None:
        targets = np.where(targets == pad_token_id, -1, targets)
    return targets.astype(np.int32)


def lm_loss(logits: torch.Tensor, ids: torch.Tensor,
            pad_token_id: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy: position t predicts ids[t+1]; pad
    targets are excluded through the -1 label."""
    targets = ids[:, 1:]
    if pad_token_id is not None:
        targets = torch.where(targets == pad_token_id,
                              torch.full_like(targets, -1), targets)
    logits = logits[:, :-1, :]
    b, t, v = logits.shape
    return cross_entropy(logits.reshape(b * t, v), targets.reshape(b * t))


def lm_loss_fn(cfg: GPTConfig):
    """`lm_loss` bound to the config's pad_token_id, so loss masking
    follows the attention mask."""
    return partial(lm_loss, pad_token_id=cfg.pad_token_id)


__all__ = [
    "EPS",
    "GPTConfig",
    "block_apply",
    "decoder_block_layers",
    "decoder_blocks",
    "gpt_lm",
    "gpt_lm_model",
    "head_apply",
    "init_params",
    "is_moe_block",
    "lm_loss",
    "lm_loss_fn",
    "lm_targets",
    "split_stages",
    "stem_apply",
]
