"""Tiny CNN, the cheap model every CPU engine test uses (port of
`models/tinycnn.py`): four 3x3 conv-BN-ReLU blocks of width 16 (the
last with stride 2), global average pool, linear head; and its
pipeline split (`split_stages`, `partition_pytree`).
"""

from __future__ import annotations

from typing import List, Sequence

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging

WIDTH = 16
N_BLOCKS = 4


def _stem() -> L.Layer:
    return L.sequential(
        L.conv2d(3, WIDTH, 3, stride=1, padding=1),
        L.batchnorm2d(WIDTH),
        L.relu(),
    )


def _block(i: int) -> L.Layer:
    stride = 2 if i == N_BLOCKS - 1 else 1
    return L.sequential(
        L.conv2d(WIDTH, WIDTH, 3, stride=stride, padding=1),
        L.batchnorm2d(WIDTH),
        L.relu(),
    )


def _head(num_classes: int) -> L.Layer:
    return L.sequential(L.global_avg_pool(), L.linear(WIDTH, num_classes))


def tiny_cnn(num_classes: int = 10, *, remat: bool = False) -> L.Layer:
    blocks = [_block(i) for i in range(N_BLOCKS)]
    if remat:
        blocks = [L.remat(b) for b in blocks]
    return staging.staged_model(_stem(), blocks, _head(num_classes))


def split_stages(num_stages: int, num_classes: int = 10, *,
                 boundaries: Sequence[int] | None = None) -> List[L.Layer]:
    """Pipeline stages (`models/staging.py`); stage 0 takes the NHWC
    batch."""
    blocks = [_block(i) for i in range(N_BLOCKS)]
    cuts = staging.split_points(num_stages, boundaries, len(blocks))
    return staging.assemble_stages(blocks, staging.nhwc_input(_stem()),
                                   _head(num_classes), cuts)


def partition_pytree(tree, num_stages: int, *,
                     boundaries: Sequence[int] | None = None) -> List[dict]:
    """A whole-model params or state tree -> the `split_stages` trees."""
    cuts = staging.split_points(num_stages, boundaries, N_BLOCKS)
    return staging.partition_tree(tree, cuts)


__all__ = ["partition_pytree", "split_stages", "tiny_cnn"]
