"""Tiny CNN, the cheap model every CPU engine test uses (port of
`models/tinycnn.py`): four 3x3 conv-BN-ReLU blocks of width 16 (the
last with stride 2), global average pool, linear head.
"""

from __future__ import annotations

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.staging import staged_model

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


def tiny_cnn(num_classes: int = 10) -> L.Layer:
    return staged_model(_stem(), [_block(i) for i in range(N_BLOCKS)],
                        _head(num_classes))


__all__ = ["tiny_cnn"]
