"""Ring, Ulysses and ring-flash attention for ONE sequence shard (port of
`ops/ring_attention.py` at N = 1).

With one shard the reference's rings have no hop and its all-to-alls are
the identity, so each op reduces to its local core:

* `ring_attention`: the local block's online softmax in f32 (q scaled
  before the dot, the causal triangle on the resident block), divided by
  the guarded denominator; autograd differentiates it as JAX does.
* `ulysses_attention`: the identity re-shard around `attention_impl`
  (dense `dot_product_attention` by default; the flash kernels for the
  `ulysses_flash` entry).
* `ring_flash_attention`: the flash core under the ring's LSE contract
  (`_pair_fwd` / `_pair_bwd`): the forward returns (out, lse), the LSE's
  +inf empty-row sentinel becomes -inf for the hop merge and +inf again
  for the backward, which runs on the external (B, H, Tq) LSE. Shapes
  the kernels do not take (a length not a multiple of 8) run the dense
  pair math with the same semantics (empty rows give 0, not mean(V)).

`seq_shards > 1` — the rings proper, over `torch.distributed` — is the
sequence-parallel slice, and is refused.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.ops.flash_attention import (
    flash_backward,
    flash_forward_lse,
    kernel_viable,
)

_NEG = torch.finfo(torch.float32).min
SP_SLICE = "the sequence-parallel slice"


def _one_shard(seq_shards: int, name: str) -> None:
    if seq_shards != 1:
        raise ValueError(
            f"{name} over {seq_shards} sequence shards is not ported to the "
            f"PyTorch package yet: it belongs to {SP_SLICE} (ROADMAP.md); "
            "this port runs one shard"
        )


def ring_attention(q, k, v, mask=None, *, scale: Optional[float] = None,
                   causal: bool = False, seq_shards: int = 1):
    """The reference's ring at N = 1: the resident block's online-softmax
    step from the running (finfo.min, 0, 0) state, in f32."""
    _one_shard(seq_shards, "ring_attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, tq, h, dh = q.shape
    qf = q.float() * scale
    kb, vb = k.float(), v.float()
    maskb = (mask if mask is not None
             else torch.ones(k.shape[:2], dtype=torch.bool, device=k.device))
    m = torch.full((b, h, tq), _NEG, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
    logits = logits.masked_fill(~maskb[:, None, None, :], _NEG)
    if causal:
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(k.shape[1], device=q.device)[None, :])
        logits = logits.masked_fill(~tri[None, None], _NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    l = p.sum(dim=-1)  # the running l and o start at 0
    o = torch.einsum("bhqk,bkhd->bqhd", p, vb)
    denom = torch.where(l > 0, l, torch.ones_like(l))
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, mask=None, *, scale: Optional[float] = None,
                      causal: bool = False, attention_impl=None,
                      seq_shards: int = 1):
    """The reference's Ulysses at N = 1: its all-to-alls are the
    identity, so this is `attention_impl` on the local tensors."""
    _one_shard(seq_shards, "ulysses_attention")
    impl = attention_impl or dot_product_attention
    return impl(q, k, v, mask, scale=scale, causal=causal)


def _dense_pair_fwd(q, k, v, maskb, scale, causal):
    """One block pair in plain torch: normalized f32 output and the LSE
    (B, H, Tq), -inf for rows the block gives nothing."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if maskb is not None:
        s = s.masked_fill(~maskb[:, None, None, :], _NEG)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~tri[None, None], _NEG)
    m = s.amax(dim=-1)
    p = torch.where(s == _NEG, torch.zeros_like(s), torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = o / safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(safe),
                      torch.full_like(l, -math.inf))
    return o, lse


def _dense_pair_bwd(q, k, v, maskb, out, lse, g, scale, causal):
    """Backward twin of `_dense_pair_fwd` under the given LSE."""
    qf, kf, vf = q.float(), k.float(), v.float()
    gf, of = g.float(), out.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    if maskb is not None:
        s = s.masked_fill(~maskb[:, None, None, :], _NEG)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~tri[None, None], _NEG)
    p = torch.exp(s - lse[..., None])  # +inf lse -> 0
    delta = (gf * of).sum(dim=-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq, dk, dv


def _pair_fwd(q, k, v, maskb, scale, causal):
    """(o f32, lse (B, H, Tq) with -inf for empty rows): the flash
    kernels where the lengths tile, dense math otherwise."""
    if not kernel_viable(q.shape[1], k.shape[1]):
        return _dense_pair_fwd(q, k, v, maskb, scale, causal)
    out, lse = flash_forward_lse(q, k, v, maskb, scale=scale, causal=causal)
    # kernel sentinel: +inf for empty rows; the hop merge wants -inf
    return out.float(), torch.where(torch.isposinf(lse),
                                    torch.full_like(lse, -math.inf), lse)


def _pair_bwd(q, k, v, maskb, out, lse, g, scale, causal):
    """(dq, dk, dv) of one block pair under the external LSE ((B, H, Tq),
    +inf for empty rows)."""
    if not kernel_viable(q.shape[1], k.shape[1]):
        return _dense_pair_bwd(q, k, v, maskb, out, lse, g, scale, causal)
    return flash_backward(q, k, v, maskb, out, lse, g, scale=scale,
                          causal=causal)


class _RingFlash(torch.autograd.Function):
    """The reference's `_ring_flash` custom_vjp at N = 1."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float, causal: bool):
        o_acc, lse_acc = _pair_fwd(q, k, v, mask, scale, causal)
        out = o_acc.to(q.dtype)
        # backward sentinel: rows nothing contributed to carry +inf
        lse = torch.where(torch.isneginf(lse_acc),
                          torch.full_like(lse_acc, math.inf), lse_acc)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _pair_bwd(q, k, v, mask, out, lse, g, ctx.scale,
                               ctx.causal)
        return (dq.float().to(q.dtype), dk.float().to(k.dtype),
                dv.float().to(v.dtype), None, None, None)


def ring_flash_attention(q, k, v, mask=None, *,
                         scale: Optional[float] = None, causal: bool = False,
                         seq_shards: int = 1):
    """The ring with the flash kernels as its per-hop core, at N = 1."""
    _one_shard(seq_shards, "ring_flash_attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingFlash.apply(q, k, v, mask, scale, causal)


__all__ = ["SP_SLICE", "ring_attention", "ring_flash_attention",
           "ulysses_attention"]
