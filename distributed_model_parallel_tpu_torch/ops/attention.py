"""Scaled dot-product attention core (port of `ops/attention.py`).

Same (B, T, H, Dh) convention and the same `attention_fn(q, k, v, mask)`
seam as the JAX package, so the decode recorders
(`serving/decode.py`) wrap it unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def default_scale(dh: int) -> float:
    """1/sqrt(dh) rounded to f32 exactly as the reference computes it
    (`1.0 / jnp.sqrt(dh).astype(f32)`, both steps in f32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over (B, T, H, Dh) tensors.

    `mask`: boolean (B, Tkv) key-validity mask (True = attend) or a
    broadcastable boolean of shape (B, 1|H, Tq, Tkv). `causal=True`
    additionally restricts each query to keys at its own position or
    earlier. Computed in f32 whatever the input dtype; masked logits
    take `finfo(f32).min` (never -inf, so a fully masked row stays
    finite), and the result is cast back to q.dtype."""
    scale = default_scale(q.shape[-1]) if scale is None else scale
    qf = q.float()
    kf = k.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    neg = torch.finfo(torch.float32).min
    if mask is not None:
        if mask.dim() == 2:  # (B, Tkv) key mask
            mask = mask[:, None, None, :]
        logits = logits.masked_fill(~mask, neg)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (
            torch.arange(tq, device=q.device)[:, None]
            >= torch.arange(tk, device=q.device)[None, :]
        )
        logits = logits.masked_fill(~tri[None, None], neg)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)


__all__ = ["default_scale", "dot_product_attention"]
