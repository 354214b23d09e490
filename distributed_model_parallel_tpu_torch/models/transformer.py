"""Post-LN transformer block (port of `models/transformer.py`).

Blocks operate on a `(hidden, mask)` pair exactly as the reference's
do; the attention core is the `attention_fn(q, k, v, mask)` seam, so
the serving recorders (`serving/decode.py`) drive the same block code
the full-sequence model runs. Every projection routes through
`layers.project`, where the int8 decode policy plugs in.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)

AttentionFn = Callable[..., torch.Tensor]


def multi_head_attention(
    params, x, ctx: L.Context, *, num_heads: int,
    dropout_rate: float = 0.0,
    attention_fn: AttentionFn = dot_product_attention,
):
    """Self-attention over (hidden, mask): fused QKV projection, per-head
    attention via `attention_fn`, output projection."""
    h, mask = x
    b, t, dim = h.shape
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
    dh = dim // num_heads
    qkv = L.project(h, params["qkv"]["w"], params["qkv"]["b"], ctx)
    q, k, v = torch.split(qkv, dim, dim=-1)
    q = q.reshape(b, t, num_heads, dh)
    k = k.reshape(b, t, num_heads, dh)
    v = v.reshape(b, t, num_heads, dh)
    o = attention_fn(q, k, v, mask)
    o = L.project(
        o.reshape(b, t, dim), params["out"]["w"], params["out"]["b"], ctx
    )
    return L.dropout(o, dropout_rate, ctx), mask


def feed_forward(params, x, ctx: L.Context, *, dropout_rate: float = 0.0):
    """Position-wise FFN (dense -> exact gelu -> dense) on (hidden, mask)."""
    h, mask = x
    y = L.gelu(L.project(h, params["in"]["w"], params["in"]["b"], ctx))
    y = L.project(y, params["out"]["w"], params["out"]["b"], ctx)
    return L.dropout(y, dropout_rate, ctx), mask


def encoder_layer(
    params, x, ctx: L.Context, *, num_heads: int,
    dropout_rate: float = 0.0, eps: float = 1e-12,
    attention_fn: AttentionFn = dot_product_attention,
):
    """Post-LN block: LN(h + Attn(h)); LN(h + FFN(h))."""
    h, mask = x
    a, _ = multi_head_attention(
        params["attn"], (h, mask), ctx, num_heads=num_heads,
        dropout_rate=dropout_rate, attention_fn=attention_fn,
    )
    h = L.layernorm(params["ln1"], h + a, eps)
    f, _ = feed_forward(params["ffn"], (h, mask), ctx,
                        dropout_rate=dropout_rate)
    h = L.layernorm(params["ln2"], h + f, eps)
    return h, mask


__all__ = [
    "AttentionFn",
    "encoder_layer",
    "feed_forward",
    "multi_head_attention",
]
