"""Transformer encoder building blocks (port of `models/transformer.py`).

Blocks operate on a `(hidden, mask)` pair exactly as the reference's
do, the mask a (B, T) bool of valid keys (or None); the attention core
is the `attention_fn(q, k, v, mask)` seam, so the serving recorders
(`serving/decode.py`) drive the same block code the full-sequence model
runs. Every projection routes through `layers.project`, where the int8
decode policy plugs in, with its Megatron role ("column" for qkv and
ffn-in, "row" for attn-out and ffn-out): under a tensor-parallel model
group (`Context.model_group`) the block runs on its rank's shard
(`parallel/tensor_parallel.py`), its local heads counted from the qkv
shard's width.

Two surfaces over one body: the functions `multi_head_attention`,
`feed_forward` and `encoder_layer` take a block's parameters directly
(the GPT and the serving recorders call them), and
`encoder_layer_block` wraps the post-LN block as a `Layer` with the
reference's init (`_linear_params`: 0.02-scaled normal weights, zero
biases), which BERT stacks. Attention is the plain
`ops/attention.dot_product_attention` by default, as in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)

AttentionFn = Callable[..., torch.Tensor]


def _linear_params(gen: torch.Generator, d_in: int, d_out: int,
                   scale: float = 0.02) -> dict:
    """{"w": scale * N(0, 1) of (d_in, d_out), "b": zeros}, drawn on the
    CPU from `gen` (the reference draws from jax.random: parity carries
    weights across with `models/convert.py`)."""
    return {"w": scale * torch.randn((d_in, d_out), generator=gen),
            "b": torch.zeros(d_out)}


def norm_params(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def attention_params(gen: torch.Generator, dim: int) -> dict:
    return {"qkv": _linear_params(gen, dim, 3 * dim),
            "out": _linear_params(gen, dim, dim)}


def ffn_params(gen: torch.Generator, dim: int, hidden_dim: int) -> dict:
    return {"in": _linear_params(gen, dim, hidden_dim),
            "out": _linear_params(gen, hidden_dim, dim)}


def multi_head_attention(
    params, x, ctx: L.Context, *, num_heads: int,
    dropout_rate: float = 0.0,
    attention_fn: AttentionFn = dot_product_attention,
):
    """Self-attention over (hidden, mask): fused QKV projection, per-head
    attention via `attention_fn`, output projection. `params` may be a
    tensor-parallel shard ([q | k | v] columns of this rank's heads, the
    matching rows of the output projection): the heads are counted from
    the qkv width."""
    h, mask = x
    dim = h.shape[-1]
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
    dh = dim // num_heads
    local = params["qkv"]["w"].shape[1] // 3
    if local % dh:
        raise ValueError(
            f"a qkv shard of {local} columns per projection does not hold "
            f"whole heads of {dh}: {num_heads} heads must split evenly "
            "over the model shards")
    heads = local // dh
    qkv = L.project(h, params["qkv"]["w"], params["qkv"]["b"], ctx,
                    role="column", scope="attn")
    # Batch and length come from the projection: under the collective
    # matmul rings h holds this rank's slots (the decode rings,
    # `serving/decode.DecodeCollectiveMatmul`) or positions (Megatron-SP,
    # `ops/collective_matmul.CollectiveMatmul`), and the column
    # projection gathers every slot's or position's rows.
    q, k, v = (a.reshape(*qkv.shape[:2], heads, dh)
               for a in torch.split(qkv, local, dim=-1))
    o = attention_fn(q, k, v, mask)
    o = L.project(o.reshape(*o.shape[:2], local), params["out"]["w"],
                  params["out"]["b"], ctx, role="row", scope="attn")
    return L.dropout(o, dropout_rate, ctx), mask


def feed_forward(params, x, ctx: L.Context, *, dropout_rate: float = 0.0):
    """Position-wise FFN (dense -> exact gelu -> dense) on (hidden, mask)."""
    h, mask = x
    y = L.gelu(L.project(h, params["in"]["w"], params["in"]["b"], ctx,
                         role="column", scope="ffn"))
    y = L.project(y, params["out"]["w"], params["out"]["b"], ctx,
                  role="row", scope="ffn")
    return L.dropout(y, dropout_rate, ctx), mask


def encoder_layer(
    params, x, ctx: L.Context, *, num_heads: int,
    dropout_rate: float = 0.0, eps: float = 1e-12,
    attention_fn: AttentionFn = dot_product_attention,
):
    """Post-LN block: LN(h + Attn(h)); LN(h + FFN(h)). The attention and
    the FFN draw their dropout bits as the reference's children 0 and
    1."""
    h, mask = x
    a, _ = multi_head_attention(
        params["attn"], (h, mask), ctx.child(0), num_heads=num_heads,
        dropout_rate=dropout_rate, attention_fn=attention_fn,
    )
    h = L.layernorm(params["ln1"], h + a, eps,
                    per_position=ctx.norm_per_position)
    f, _ = feed_forward(params["ffn"], (h, mask), ctx.child(1),
                        dropout_rate=dropout_rate)
    h = L.layernorm(params["ln2"], h + f, eps,
                    per_position=ctx.norm_per_position)
    return h, mask


def encoder_layer_block(
    dim: int, num_heads: int, hidden_dim: int, *,
    dropout_rate: float = 0.0, eps: float = 1e-12,
    attention_fn: AttentionFn = dot_product_attention,
) -> L.Layer:
    """The post-LN `encoder_layer` as a `Layer` over (hidden, mask), with
    the reference's parameter tree {attn, ln1, ffn, ln2} and init (the
    reference's `encoder_layer` constructor)."""
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")

    def init(gen):
        return {"attn": attention_params(gen, dim),
                "ln1": norm_params(dim),
                "ffn": ffn_params(gen, dim, hidden_dim),
                "ln2": norm_params(dim)}, {}

    def apply(params, state, x, ctx):
        return encoder_layer(params, x, ctx, num_heads=num_heads,
                             dropout_rate=dropout_rate, eps=eps,
                             attention_fn=attention_fn), state

    return L.Layer(init, apply)


__all__ = [
    "AttentionFn",
    "attention_params",
    "encoder_layer",
    "encoder_layer_block",
    "feed_forward",
    "ffn_params",
    "multi_head_attention",
    "norm_params",
]
