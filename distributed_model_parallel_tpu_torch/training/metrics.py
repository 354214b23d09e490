"""Loss and accuracy metrics (port of `training/metrics.py`).

Rows labelled -1 are padding (or, for the LM, the last position of a
window and pad targets): they contribute no loss and no count.
"""

from __future__ import annotations

import dataclasses

import torch


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """Number of real (label >= 0) rows, as an f32 scalar."""
    return (labels >= 0).float().sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the valid rows, computed in f32.
    logits (N, C), labels (N,) int with -1 for excluded rows."""
    logits = logits.float()
    valid = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe[:, None])[:, 0]
    per_example = (logz - true_logit) * valid
    return per_example.sum() / valid.sum().clamp_min(1.0)


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Count (a sum, not a percentage) of valid rows whose label is
    among the top-k logits; k is clamped to the number of classes."""
    pred = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    hit = (pred == labels[:, None].long()).any(dim=-1)
    return (hit.float() * (labels >= 0).float()).sum()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             topk=(1,)) -> list:
    """Percentage top-k accuracies over all rows."""
    n = labels.shape[0]
    return [100.0 * topk_correct(logits, labels, k) / n for k in topk]


@dataclasses.dataclass
class Meter:
    """Streaming average (host-side)."""

    total: float = 0.0
    count: int = 0

    def update(self, value: float, n: int = 1) -> None:
        self.total += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


__all__ = ["Meter", "accuracy", "cross_entropy", "topk_correct",
           "valid_count"]
