"""Mixture-of-Experts feed-forward (port of `models/moe.py`): the routed
FFN behind expert parallelism (`parallel/expert_parallel.py`).

The reference's dense-dispatch GShard / Switch formulation, kept as it
is: routing builds one-hot dispatch and combine tensors, the tokens are
packed into per-expert buffers by an einsum, the experts run as batched
matmuls over a leading E axis, and a second einsum scatters their
outputs back, gate-weighted. When an engine threads a policy into
`Context.expert_dispatch`, the pack -> FFN -> unpack runs through it
instead (`ops/expert_dispatch.py`'s two-level token exchange, or the
expert-group policy of `parallel/expert_parallel.py`); the routing here
is the same either way.

Routing per token (top-k with capacity), in f32 whatever the compute
dtype:
  * router logits -> softmax gates, masked tokens zeroed;
  * k rounds of argmax (ties to the first index) over the gates not yet
    picked; a token with a live gate claims the next slot of its
    expert's buffer by a cumulative count over the sequence, offset by
    the slots earlier rounds kept; tokens past the capacity C = ceil(k
    * T * capacity_factor / E) are dropped (combine weight 0: the
    residual stream carries them, the Switch behaviour). A round
    retires its PICK, kept or not, so a token whose first choice
    overflowed falls to its genuine second choice;
  * the kept gates renormalize over the kept experts (+1e-9);
  * dropout on the layer's output draws from `ctx.child(1)`.

The Switch load-balance loss, aux_loss_weight * E * sum_e f_e * p_e over
the valid tokens, with f_e from the round-0 PRE-capacity picks, returns
through the layer state under `layers.AUX_KEY` ("moe_aux"); the engines
add every such leaf to the loss they differentiate (`layers.aux_loss`).
A policy with a `reduce_aux` method (the expert-parallel engines') sums
the counts and the gate mass over its data ranks before the product, as
the reference's GSPMD computes them over the global batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.transformer import (
    AttentionFn,
    attention_params,
    multi_head_attention,
    norm_params,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)

AUX_KEY = L.AUX_KEY


def expert_ffn(w, xin: torch.Tensor, dtype=None) -> torch.Tensor:
    """The per-expert FFN (dense -> exact gelu -> dense), batched over the
    leading expert axis: xin (E', rows, C, D) -> (E', rows, C, D) with
    weight leaves leading E' (the whole stack, or a rank's block inside
    the exchange). Parameters are f32 masters cast per use."""
    dt = dtype if dtype is not None else xin.dtype
    y = torch.einsum("ebcd,edh->ebch", xin, w["w_in"].to(dt))
    y = L.gelu(y + w["b_in"][:, None, None, :].to(dt))
    y = torch.einsum("ebch,ehd->ebcd", y, w["w_out"].to(dt))
    return y + w["b_out"][:, None, None, :].to(dt)


def capacity(t: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Buffer slots an expert has per sample: ceil(k * T * cf / E)."""
    return max(1, math.ceil(top_k * t * capacity_factor / num_experts))


def route(h: torch.Tensor, mask, router_w: torch.Tensor, num_experts: int,
          top_k: int, cap: int):
    """The reference's routing (module docstring): returns (gates (B, T,
    E) f32, the kept rounds [(gate (B, T), kept one-hot (B, T, E),
    slot (B, T))], the round-0 pre-capacity picks (B, T, E))."""
    b, _, _ = h.shape
    e = num_experts
    gates = torch.softmax(h.float() @ router_w.float(), dim=-1)
    if mask is not None:
        gates = gates * mask[..., None]
    remaining = gates
    counts = torch.zeros((b, e), dtype=torch.int64, device=h.device)
    chosen = []
    top1 = None
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)                       # (B, T)
        raw = F.one_hot(idx, e)                              # (B, T, E)
        gate = remaining.gather(-1, idx[..., None])[..., 0]  # (B, T)
        # Only a live gate claims a slot: a masked token's zero row
        # argmaxes to expert 0 and must not take a later token's slot.
        eligible = raw * (gate > 0)[..., None]
        pos_in_e = (torch.cumsum(eligible, dim=1) - eligible
                    + counts[:, None, :])
        pos = (pos_in_e * eligible).sum(dim=-1)
        if top1 is None:
            top1 = eligible
        keep = (pos < cap) & (gate > 0)
        kept = eligible * keep[..., None]
        counts = counts + kept.sum(dim=1)
        chosen.append((gate * keep, kept, pos))
        remaining = remaining * (1 - eligible.to(gates.dtype))
    return gates, chosen, top1


def combine_tensor(weights, chosen, cap: int) -> torch.Tensor:
    """(B, T, E, C) f32: each kept pick's normalized gate at its
    expert's slot. `weights` are the rounds' gate / denominator."""
    out = 0
    for wt, (_, oh, pos) in zip(weights, chosen):
        # A dropped pick's slot may lie past the buffer; its one-hot row
        # is all zero there, so any in-range slot does.
        slot = F.one_hot(pos.clamp(max=cap - 1), cap).to(wt.dtype)
        out = out + (wt[..., None, None] * oh[..., None]
                     * slot[:, :, None, :])
    return out


def dense_experts(h, dispatch, combine, w) -> torch.Tensor:
    """Every expert here: pack, FFN, gate-weighted unpack."""
    xin = torch.einsum("btec,btd->ebcd", dispatch, h)
    y = expert_ffn(w, xin, dtype=h.dtype)
    return torch.einsum("btec,ebcd->btd", combine, y)


def moe_params(gen: torch.Generator, dim: int, hidden_dim: int,
               num_experts: int) -> dict:
    """The reference's tree: {"router": {"w"}, "experts": {"w_in",
    "b_in", "w_out", "b_out"}}, 0.02-scaled normal weights, zero biases,
    drawn on `gen`'s device (parity carries weights across)."""
    e, device = num_experts, gen.device

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device=device)

    return {"router": {"w": normal(dim, e)},
            "experts": {"w_in": normal(e, dim, hidden_dim),
                        "b_in": torch.zeros(e, hidden_dim, device=device),
                        "w_out": normal(e, hidden_dim, dim),
                        "b_out": torch.zeros(e, dim, device=device)}}


def moe_state() -> dict:
    return {AUX_KEY: torch.zeros(())}


def moe_feed_forward(params, x, ctx: L.Context, *, num_experts: int,
                     top_k: int = 2, capacity_factor: float = 1.25,
                     aux_loss_weight: float = 1e-2,
                     dropout_rate: float = 0.0):
    """The routed FFN over (hidden, mask): returns ((out, mask), {"moe_aux":
    the load-balance loss}) (module docstring)."""
    if not 1 <= top_k <= num_experts:
        raise ValueError(
            f"top_k {top_k} must be in [1, num_experts {num_experts}]")
    h, mask = x
    group = (getattr(ctx.matmul, "group", None)
             if ctx.seq_shard is not None else None)
    if group is not None and torch.distributed.get_world_size(group) > 1:
        return _sequence_sharded(
            params, x, ctx, group, num_experts=num_experts, top_k=top_k,
            capacity_factor=capacity_factor,
            aux_loss_weight=aux_loss_weight, dropout_rate=dropout_rate)
    b, t, _ = h.shape
    e = num_experts
    cap = capacity(t, e, top_k, capacity_factor)
    gates, chosen, top1 = route(h, mask, params["router"]["w"], e, top_k,
                                cap)
    denom = sum(g for g, _, _ in chosen) + 1e-9
    weights = [g / denom for g, _, _ in chosen]
    policy = ctx.expert_dispatch
    enter = getattr(policy, "enter", None)
    if enter is not None:
        h_in, weights = enter(h, weights)
    else:
        h_in = h
    combine = combine_tensor(weights, chosen, cap)
    dispatch = (combine > 0).to(h.dtype)
    w = params["experts"]
    if policy is not None:
        out = policy(h_in, dispatch, combine.to(h.dtype), w)
    else:
        out = dense_experts(h, dispatch, combine.to(h.dtype), w)
    out = L.dropout(out, dropout_rate, ctx.child(1))

    # Switch load balance over the VALID tokens, f_e from the pre-capacity
    # top-1 picks (post-drop counts saturate at C exactly when an expert
    # is overloaded).
    n = (mask.float().sum() if mask is not None
         else torch.tensor(float(b * t), device=h.device))
    f_sum = top1.float().sum(dim=(0, 1))
    p_sum = gates.sum(dim=(0, 1))
    reduce = getattr(policy, "reduce_aux", None)
    if reduce is not None:
        f_sum, p_sum, n = reduce(f_sum, p_sum, n)
    n_valid = n + 1e-9
    f_e = f_sum / n_valid
    p_e = p_sum / n_valid
    aux = aux_loss_weight * e * torch.sum(f_e * p_e)
    return (out, mask), {AUX_KEY: aux}


def _sequence_sharded(params, x, ctx: L.Context, group, **kw):
    """The routed FFN under Megatron-SP (`parallel/tensor_parallel.
    megatron_sp`: this rank holds T/M positions of the residual stream,
    `ctx.seq_shard`): the reference routes every token of the WHOLE
    sequence against one capacity, so the positions are gathered over
    the model group, routed and run there on every rank alike, and this
    rank keeps its own rows of the output. The gather's backward sums
    the ranks' cotangents (`gather_seq_summed`), so each rank's MoE
    gradients hold its own rows' share, and the engine sums them over
    the model group. The load-balance loss, computed whole on every
    rank, keeps its value and contributes 1/M of its gradient on each."""
    from distributed_model_parallel_tpu_torch.ops.collective_matmul import (
        gather_seq_summed,
    )

    h, mask = x
    start, _ = ctx.seq_shard
    full = gather_seq_summed(h, group)
    (out, mask), st = moe_feed_forward(
        params, (full, mask), dataclasses.replace(ctx, seq_shard=None), **kw)
    aux = st[AUX_KEY]
    m = torch.distributed.get_world_size(group)
    aux = aux / m + (aux - aux / m).detach()
    return (out[:, start:start + h.shape[1]], mask), {AUX_KEY: aux}


def moe_block(params, state, x, ctx: L.Context, *, num_heads: int,
              num_experts: int, top_k: int = 2,
              capacity_factor: float = 1.25, aux_loss_weight: float = 1e-2,
              dropout_rate: float = 0.0, eps: float = 1e-12,
              attention_fn: AttentionFn = dot_product_attention):
    """Post-LN block with the FFN routed: LN(h + Attn(h)); LN(h +
    MoE(h)). Returns ((hidden, mask), {"moe": {"moe_aux": ...}})."""
    h, mask = x
    a, _ = multi_head_attention(params["attn"], (h, mask), ctx.child(0),
                                num_heads=num_heads,
                                dropout_rate=dropout_rate,
                                attention_fn=attention_fn)
    h = L.layernorm(params["ln1"], h + a, eps)
    (f, mask), moe_st = moe_feed_forward(
        params["moe"], (h, mask), ctx.child(1), num_experts=num_experts,
        top_k=top_k, capacity_factor=capacity_factor,
        aux_loss_weight=aux_loss_weight, dropout_rate=dropout_rate)
    h = L.layernorm(params["ln2"], h + f, eps)
    return (h, mask), {"moe": moe_st}


def moe_block_params(gen: torch.Generator, dim: int, hidden_dim: int,
                     num_experts: int) -> dict:
    """{"attn", "ln1", "moe", "ln2"}, drawn in the reference's order."""
    return {"attn": attention_params(gen, dim), "ln1": norm_params(dim),
            "moe": moe_params(gen, dim, hidden_dim, num_experts),
            "ln2": norm_params(dim)}


def moe_encoder_layer(dim: int, num_heads: int, hidden_dim: int,
                      num_experts: int, *, top_k: int = 2,
                      capacity_factor: float = 1.25,
                      aux_loss_weight: float = 1e-2,
                      dropout_rate: float = 0.0, eps: float = 1e-12,
                      attention_fn: AttentionFn = dot_product_attention
                      ) -> L.Layer:
    """`moe_block` as a `Layer` over (hidden, mask), shape-compatible with
    `transformer.encoder_layer_block`, so MoE and dense blocks interleave
    in one stack; its state is {"moe": {"moe_aux": 0}}."""
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
    if not 1 <= top_k <= num_experts:
        raise ValueError(
            f"top_k {top_k} must be in [1, num_experts {num_experts}]")

    def init(gen):
        return (moe_block_params(gen, dim, hidden_dim, num_experts),
                {"moe": moe_state()})

    def apply(params, state, x, ctx):
        return moe_block(params, state, x, ctx, num_heads=num_heads,
                         num_experts=num_experts, top_k=top_k,
                         capacity_factor=capacity_factor,
                         aux_loss_weight=aux_loss_weight,
                         dropout_rate=dropout_rate, eps=eps,
                         attention_fn=attention_fn)

    return L.Layer(init, apply)


__all__ = ["AUX_KEY", "capacity", "combine_tensor", "dense_experts",
           "expert_ffn", "moe_block", "moe_block_params",
           "moe_encoder_layer", "moe_feed_forward", "moe_params",
           "moe_state", "route"]
