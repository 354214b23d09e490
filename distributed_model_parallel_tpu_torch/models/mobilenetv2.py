"""MobileNetV2, CIFAR variant (port of `models/mobilenetv2.py`): the
reference's 17-block `CFG` (stride 1 in the stem and in stage 2, pool
window 4), about 2.2 M parameters at 10 classes, and the no-BN variant,
which keeps the BN inside the projection shortcut as the reference does;
and the pipeline split (`split_stages`, `partition_pytree`).
"""

from __future__ import annotations

from typing import List, Sequence

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging

# (expansion, out_planes, num_blocks, stride)
CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 1),  # stride 2 -> 1 for CIFAR10
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _block(in_planes: int, out_planes: int, expansion: int, stride: int,
           batchnorm: bool = True) -> L.Layer:
    """Inverted residual: expand 1x1, depthwise 3x3, project 1x1; BN
    after each conv (except in the no-BN variant), ReLU after the first
    two, a residual add when the stride is 1."""
    planes = expansion * in_planes
    body = L.named([
        ("conv1", L.conv2d(in_planes, planes, 1)),
        *([("bn1", L.batchnorm2d(planes))] if batchnorm else []),
        ("relu1", L.relu()),
        ("conv2", L.conv2d(planes, planes, 3, stride=stride, padding=1,
                           groups=planes)),
        *([("bn2", L.batchnorm2d(planes))] if batchnorm else []),
        ("relu2", L.relu()),
        ("conv3", L.conv2d(planes, out_planes, 1)),
        *([("bn3", L.batchnorm2d(out_planes))] if batchnorm else []),
    ])
    if stride != 1:
        return body  # no residual when downsampling
    if in_planes != out_planes:
        shortcut = L.named([
            ("conv", L.conv2d(in_planes, out_planes, 1)),
            ("bn", L.batchnorm2d(out_planes)),  # kept in the nobn variant
        ])
    else:
        shortcut = None
    return L.residual(body, shortcut)


def _make_blocks(in_planes: int = 32, batchnorm: bool = True) -> List[L.Layer]:
    blocks = []
    for expansion, out_planes, num_blocks, stride in CFG:
        for s in [stride] + [1] * (num_blocks - 1):
            blocks.append(_block(in_planes, out_planes, expansion, s,
                                 batchnorm))
            in_planes = out_planes
    return blocks


def _stem(batchnorm: bool) -> L.Layer:
    return L.named([
        ("conv1", L.conv2d(3, 32, 3, stride=1, padding=1)),
        *([("bn1", L.batchnorm2d(32))] if batchnorm else []),
        ("relu", L.relu()),
    ])


def _head(num_classes: int, batchnorm: bool) -> L.Layer:
    return L.named([
        ("conv2", L.conv2d(320, 1280, 1)),
        *([("bn2", L.batchnorm2d(1280))] if batchnorm else []),
        ("reshape", L.reshape_head(4)),  # relu + avgpool(4) + flatten
        ("linear", L.linear(1280, num_classes)),
    ])


def mobilenet_v2(num_classes: int = 10, *, batchnorm: bool = True,
                 remat: bool = False) -> L.Layer:
    """The whole network; `remat=True` checkpoints each inverted-residual
    block (`layers.remat`)."""
    blocks = _make_blocks(batchnorm=batchnorm)
    if remat:
        blocks = [L.remat(b) for b in blocks]
    return staging.staged_model(_stem(batchnorm), blocks,
                                _head(num_classes, batchnorm))


def mobilenet_v2_nobn(num_classes: int = 10, *,
                      remat: bool = False) -> L.Layer:
    return mobilenet_v2(num_classes, batchnorm=False, remat=remat)


def split_stages(num_stages: int, num_classes: int = 10, *,
                 batchnorm: bool = True,
                 boundaries: Sequence[int] | None = None) -> List[L.Layer]:
    """Pipeline stages (`models/staging.py`): the 17 blocks as evenly as
    possible, the stem on stage 0 and the head on the last;
    `boundaries=[3, 9, 15]` is the reference's ws=4 split
    (`model_parallel.py:102-104,129,143-144`). Stage 0 takes the NHWC
    batch."""
    blocks = _make_blocks(batchnorm=batchnorm)
    cuts = staging.split_points(num_stages, boundaries, len(blocks))
    return staging.assemble_stages(
        blocks, staging.nhwc_input(_stem(batchnorm)),
        _head(num_classes, batchnorm), cuts)


def partition_pytree(tree, num_stages: int, *,
                     boundaries: Sequence[int] | None = None) -> List[dict]:
    """A whole-model params or state tree -> the `split_stages` trees."""
    cuts = staging.split_points(num_stages, boundaries, 17)
    return staging.partition_tree(tree, cuts)


__all__ = ["CFG", "mobilenet_v2", "mobilenet_v2_nobn", "partition_pytree",
           "split_stages"]
