"""Layer primitives the GPT path uses (port of `models/layers.py`).

The reference's `Layer(init, apply)` pairs become plain functions on
tensors over the same parameter dictionaries (`{"w", "b"}` linears
stored (K, N), `{"scale", "bias"}` norms), so the parameter tree crosses
between the packages unchanged (`models/convert.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Context:
    """Per-call context threaded through the layers."""

    train: bool = False
    # Activation dtype. None => follow the input dtype; when set, the
    # embedding (a layer whose output dtype comes from params) casts to
    # it and everything downstream follows x.dtype.
    dtype: Optional[torch.dtype] = None
    # Projection policy (`ops/quant_matmul.QuantMatmul`) consumed by
    # `project`; None => every projection is a plain dot.
    matmul: Optional[Any] = None


def layernorm(params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (GPT passes 1e-5)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, `jax.nn.gelu(approximate=False)`."""
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, ctx: Context) -> torch.Tensor:
    """Identity in eval, and for rate 0 — the only uses on this path
    (serving and parity runs set dropout 0). Training-time dropout
    belongs to the LM-training slice."""
    if ctx.train and rate > 0.0:
        raise NotImplementedError(
            "train-mode dropout is not ported yet (LM-training slice); "
            "use rate 0 or Context(train=False)"
        )
    return x


def project(h, w, b, ctx: Context):
    """Dense projection `h @ w + b`, or `ctx.matmul(h, w, b)` when a
    projection policy is threaded."""
    w = w.to(h.dtype)
    b = b.to(h.dtype)
    if ctx.matmul is not None:
        return ctx.matmul(h, w, b)
    return h @ w + b


__all__ = ["Context", "dropout", "gelu", "layernorm", "project"]
