"""The training state and per-batch metric sums shared by the engines
(port of `TrainState` and `_metrics` from `parallel/data_parallel.py`;
the data-parallel engines themselves belong to the DDP slice).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from distributed_model_parallel_tpu_torch.training.metrics import (
    topk_correct,
    valid_count,
)


class TrainState(NamedTuple):
    """params, model_state (empty for the GPT), optimizer state, and the
    step count. The step is a host int here (the reference keeps an int32
    device scalar inside its jitted step): the port's engine reads it on
    the host to seed the step's dropout generator."""

    params: Any
    model_state: Any
    opt_state: Any
    step: int


def _metrics(loss, logits, labels) -> dict:
    """Metric SUMS of one batch: `loss` is the mean over valid rows, so
    loss_sum = loss * count; rows labelled -1 count nowhere."""
    n = valid_count(labels)
    return {
        "loss_sum": loss * n,
        "correct1": topk_correct(logits, labels, 1),
        "correct5": topk_correct(logits, labels, 5),
        "count": n,
    }


__all__ = ["TrainState", "_metrics"]
