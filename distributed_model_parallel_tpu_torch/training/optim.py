"""Optimizers and the LR schedule (port of `training/optim.py`).

They act on the port's parameter tree (nested dicts of tensors) and its
gradient tree of the same shape. Unlike the reference's pure functions,
`update` writes the new parameters and optimizer state IN PLACE, under
`torch.no_grad()`, and returns them: a training step then holds one
copy of parameters and moments instead of two. The arithmetic follows
the reference term for term, in the same order, so a step rounds as the
JAX step does; `torch.optim` is not used (its AdamW applies the decay
before the moment step, a different rounding and a different order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, NamedTuple

import torch


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """Leaves of a tree of dicts and tuples (the pipeline's per-stage
    tuples), dicts in key order (sorted, so two trees of the same
    structure line up leaf for leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif type(tree) is tuple:
        for t in tree:
            yield from tree_leaves(t)
    else:
        yield tree


def tree_like(tree, leaves_in_order):
    """A tree shaped like `tree` whose leaves come from the iterator, in
    `tree_leaves` order (the inverse of `tree_leaves`)."""
    if isinstance(tree, dict):
        return {k: tree_like(tree[k], leaves_in_order) for k in sorted(tree)}
    if type(tree) is tuple:
        return tuple(tree_like(t, leaves_in_order) for t in tree)
    return next(leaves_in_order)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and of same-shaped `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if type(tree) is tuple:
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)


class SGDState(NamedTuple):
    momentum: Any  # tree like params


@dataclasses.dataclass(frozen=True)
class SGD:
    """torch-semantics SGD: buf = m*buf + g + wd*p; p -= lr*buf. Weight
    decay applies to every parameter, as in the reference."""

    momentum: float = 0.9
    weight_decay: float = 1e-4

    def init(self, params) -> SGDState:
        return SGDState(tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, params, opt_state: SGDState, grads, lr):
        """In place: params and the momentum buffers are overwritten."""
        m, wd = self.momentum, self.weight_decay
        for p, buf, g in zip(tree_leaves(params),
                             tree_leaves(opt_state.momentum),
                             tree_leaves(grads)):
            buf.mul_(m).add_(g).add_(p * wd)
            p.sub_(lr * buf)
        return params, opt_state


class AdamWState(NamedTuple):
    mu: Any     # first moment, tree like params
    nu: Any     # second moment, tree like params
    count: Any  # int32 scalar tensor: steps taken (bias correction)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Decoupled-decay AdamW: moments in f32,
    p -= lr * ((m/c1) / (sqrt(v/c2) + eps) + wd*p), c = 1 - beta**count."""

    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2

    def init(self, params) -> AdamWState:
        device = next(tree_leaves(params)).device
        return AdamWState(
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params),
            torch.zeros((), dtype=torch.int32, device=device),
        )

    @torch.no_grad()
    def update(self, params, opt_state: AdamWState, grads, lr):
        """In place: params, moments and the count are overwritten."""
        b1, b2, eps, wd = self.beta1, self.beta2, self.eps, self.weight_decay
        count = opt_state.count
        count.add_(1)
        cf = count.float()
        c1 = 1.0 - torch.full_like(cf, b1) ** cf
        c2 = 1.0 - torch.full_like(cf, b2) ** cf
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(opt_state.mu),
                              tree_leaves(opt_state.nu), tree_leaves(grads)):
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(g.square() * (1.0 - b2))
            # The count lives on the first leaf's device; pipeline stages
            # may sit on others.
            c1p, c2p = c1.to(p.device), c2.to(p.device)
            upd = (m / c1p) / ((v / c2p).sqrt() + eps) + wd * p
            p.sub_(lr * upd)
        return params, opt_state


def cosine_warmup_schedule(
    base_lr: float, t_max: int = 90, warmup_period: int = 10
) -> Callable[[int], float]:
    """Per-epoch LR: base * (1 + cos(pi*epoch/t_max))/2 *
    min(1, (epoch+1)/warmup_period), evaluated in f32 as the reference
    does; returned as a Python float holding that f32 value."""

    def lr(epoch) -> float:
        e = torch.tensor(float(epoch), dtype=torch.float32)
        cos = 0.5 * (1.0 + torch.cos(math.pi * e / t_max))
        warm = torch.clamp_max((e + 1.0) / warmup_period, 1.0)
        return float(base_lr * cos * warm)

    return lr


__all__ = ["SGD", "AdamW", "AdamWState", "SGDState",
           "cosine_warmup_schedule", "tree_leaves", "tree_like", "tree_map"]
