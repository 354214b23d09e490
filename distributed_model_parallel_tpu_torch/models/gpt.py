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
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.transformer import (
    AttentionFn,
    encoder_layer,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
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
    # Mixture-of-Experts fields, kept so configs cross between the
    # packages; num_experts > 0 is refused (expert-parallel slice).
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25


def init_params(cfg: GPTConfig, seed: int = 0, device="cpu") -> dict:
    """Fresh parameters from `seed` (0.02-scaled normals for embeddings,
    head and projection weights; zero biases; unit LayerNorm scales),
    drawn on `device` by a `torch.Generator`. The reference's init draws
    from jax.random, so the numbers differ; parity runs carry one tree
    across with `models/convert.py`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=g, device=device)

    def linear(d_in, d_out):
        return {"w": normal(d_in, d_out),
                "b": torch.zeros(d_out, device=device)}

    def norm():
        return {"scale": torch.ones(cfg.dim, device=device),
                "bias": torch.zeros(cfg.dim, device=device)}

    blocks = {}
    for i in range(cfg.num_layers):
        blocks[str(i)] = {
            "attn": {"qkv": linear(cfg.dim, 3 * cfg.dim),
                     "out": linear(cfg.dim, cfg.dim)},
            "ln1": norm(),
            "ffn": {"in": linear(cfg.dim, cfg.ffn_dim),
                    "out": linear(cfg.ffn_dim, cfg.dim)},
            "ln2": norm(),
        }
    return {
        "stem": {"word": normal(cfg.vocab_size, cfg.dim),
                 "position": normal(cfg.max_position, cfg.dim)},
        "blocks": blocks,
        "head": {"w": normal(cfg.dim, cfg.vocab_size)},
    }


def stem_apply(params, ids: torch.Tensor, cfg: GPTConfig, ctx: L.Context):
    """Token + position embeddings (dropout identity in eval). Returns
    (hidden, mask)."""
    mask = (
        torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        if cfg.pad_token_id is None else ids != cfg.pad_token_id
    )
    h = params["word"][ids] + params["position"][: ids.shape[1]][None]
    if ctx.dtype is not None:
        h = h.to(ctx.dtype)
    return L.dropout(h, cfg.dropout_rate, ctx), mask


def head_apply(params, h: torch.Tensor) -> torch.Tensor:
    """Untied vocabulary projection; logits in f32."""
    return h.float() @ params["w"]


def decoder_blocks(params, x, cfg: GPTConfig, ctx: L.Context,
                   attention_fn: Optional[AttentionFn] = None):
    """Run the block stack `params` ({"0": ..., "1": ...}) over
    (hidden, mask); the default core is causal dense attention. Blocks
    apply in order, so a stateful `attention_fn` (the cache recorders)
    sees layer 0, 1, ... in turn."""
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE decoder blocks (num_experts > 0) are not ported yet "
            "(expert-parallel slice)"
        )
    attn = attention_fn or partial(dot_product_attention, causal=True)
    for i in range(cfg.num_layers):
        x = encoder_layer(
            params[str(i)], x, ctx, num_heads=cfg.num_heads,
            dropout_rate=cfg.dropout_rate, eps=EPS, attention_fn=attn,
        )
    return x


def gpt_lm(params, ids: torch.Tensor, cfg: GPTConfig,
           ctx: Optional[L.Context] = None, *,
           attention_fn: Optional[AttentionFn] = None) -> torch.Tensor:
    """Full-sequence forward: ids (B, T) -> logits (B, T, vocab) f32 (the
    recompute oracle the cached decode is held against)."""
    ctx = ctx or L.Context()
    x = stem_apply(params["stem"], ids, cfg, ctx)
    h, _ = decoder_blocks(params["blocks"], x, cfg, ctx, attention_fn)
    return head_apply(params["head"], h)


__all__ = [
    "EPS",
    "GPTConfig",
    "decoder_blocks",
    "gpt_lm",
    "head_apply",
    "init_params",
    "stem_apply",
]
