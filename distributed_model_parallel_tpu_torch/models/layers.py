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
    # Random bits for train-mode dropout: a torch.Generator on the
    # activations' device, seeded per step by the engine (the reference
    # folds the step into a PRNG key instead). Each dropout call draws
    # the next bits from it, so sibling layers get independent masks.
    # None => dropout is the identity, as with the reference's rng=None.
    generator: Optional[torch.Generator] = None


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
    """Inverted dropout: in training, zero each element with probability
    `rate` and scale the kept ones by 1/(1 - rate). The identity in eval,
    for rate 0, and without a generator. The bits come from
    `ctx.generator` and cannot match jax.random's; parity runs use
    rate 0."""
    if not ctx.train or rate == 0.0 or ctx.generator is None:
        return x
    keep = torch.rand(x.shape, generator=ctx.generator,
                      device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def project(h, w, b, ctx: Context):
    """Dense projection `h @ w + b`, or `ctx.matmul(h, w, b)` when a
    projection policy is threaded."""
    w = w.to(h.dtype)
    b = b.to(h.dtype)
    if ctx.matmul is not None:
        return ctx.matmul(h, w, b)
    return h @ w + b


__all__ = ["Context", "dropout", "gelu", "layernorm", "project"]
