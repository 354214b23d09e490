"""ResNet family (port of `models/resnet.py`): BasicBlock for 18/34,
Bottleneck (expansion 4) for 50/101/152, torchvision's definitions,
with the CIFAR stem (3x3 stride 1, no maxpool) for `cifar=True`; and
the pipeline split (`split_stages`, `partition_pytree`).
"""

from __future__ import annotations

from typing import List, Sequence

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging


def _basic_block(in_planes: int, planes: int, stride: int) -> L.Layer:
    """conv3x3-BN-ReLU-conv3x3-BN (+projection shortcut), ReLU after add."""
    body = L.named([
        ("conv1", L.conv2d(in_planes, planes, 3, stride=stride, padding=1)),
        ("bn1", L.batchnorm2d(planes)),
        ("relu", L.relu()),
        ("conv2", L.conv2d(planes, planes, 3, stride=1, padding=1)),
        ("bn2", L.batchnorm2d(planes)),
    ])
    shortcut = None
    if stride != 1 or in_planes != planes:
        shortcut = L.named([
            ("conv", L.conv2d(in_planes, planes, 1, stride=stride)),
            ("bn", L.batchnorm2d(planes)),
        ])
    return L.sequential(L.residual(body, shortcut), L.relu())


def _bottleneck(in_planes: int, planes: int, stride: int) -> L.Layer:
    """1x1 reduce, 3x3, 1x1 expand (x4); ReLU after the residual add."""
    out_planes = planes * 4
    body = L.named([
        ("conv1", L.conv2d(in_planes, planes, 1)),
        ("bn1", L.batchnorm2d(planes)),
        ("relu1", L.relu()),
        ("conv2", L.conv2d(planes, planes, 3, stride=stride, padding=1)),
        ("bn2", L.batchnorm2d(planes)),
        ("relu2", L.relu()),
        ("conv3", L.conv2d(planes, out_planes, 1)),
        ("bn3", L.batchnorm2d(out_planes)),
    ])
    shortcut = None
    if stride != 1 or in_planes != out_planes:
        shortcut = L.named([
            ("conv", L.conv2d(in_planes, out_planes, 1, stride=stride)),
            ("bn", L.batchnorm2d(out_planes)),
        ])
    return L.sequential(L.residual(body, shortcut), L.relu())


_SPECS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _make_blocks(depth: int) -> tuple:
    kind, counts = _SPECS[depth]
    block = _basic_block if kind == "basic" else _bottleneck
    expansion = 1 if kind == "basic" else 4
    blocks: List[L.Layer] = []
    in_planes = 64
    for stage_i, (planes, n) in enumerate(zip([64, 128, 256, 512], counts)):
        for b in range(n):
            stride = 2 if (stage_i > 0 and b == 0) else 1
            blocks.append(block(in_planes, planes, stride))
            in_planes = planes * expansion
    return blocks, in_planes


def _stem(cifar: bool) -> L.Layer:
    if cifar:
        return L.named([
            ("conv1", L.conv2d(3, 64, 3, stride=1, padding=1)),
            ("bn1", L.batchnorm2d(64)),
            ("relu", L.relu()),
        ])
    return L.named([
        ("conv1", L.conv2d(3, 64, 7, stride=2, padding=3)),
        ("bn1", L.batchnorm2d(64)),
        ("relu", L.relu()),
        ("maxpool", L.max_pool2d(3, 2, padding=1)),
    ])


def _head(feat: int, num_classes: int) -> L.Layer:
    return L.named([
        ("avgpool", L.global_avg_pool()),
        ("fc", L.linear(feat, num_classes)),
    ])


def resnet(depth: int, num_classes: int = 1000, *,
           cifar: bool = False, remat: bool = False) -> L.Layer:
    """ResNet-{18,34,50,101,152}; `cifar=True` swaps in the 3x3 stride-1
    stem with no maxpool; `remat=True` checkpoints each residual block
    (`layers.remat`)."""
    blocks, feat = _make_blocks(depth)
    if remat:
        blocks = [L.remat(b) for b in blocks]
    return staging.staged_model(_stem(cifar), blocks,
                                _head(feat, num_classes))


def resnet18(num_classes: int = 10, *, cifar: bool = True,
             remat: bool = False) -> L.Layer:
    return resnet(18, num_classes, cifar=cifar, remat=remat)


def resnet50(num_classes: int = 1000, *, cifar: bool = False,
             remat: bool = False) -> L.Layer:
    return resnet(50, num_classes, cifar=cifar, remat=remat)


def split_stages(depth: int, num_stages: int, num_classes: int = 1000, *,
                 cifar: bool = False,
                 boundaries: Sequence[int] | None = None) -> List[L.Layer]:
    """Pipeline stages (`models/staging.py`), the stem on stage 0 and the
    head on the last. Stage 0 takes the NHWC batch."""
    blocks, feat = _make_blocks(depth)
    cuts = staging.split_points(num_stages, boundaries, len(blocks))
    return staging.assemble_stages(
        blocks, staging.nhwc_input(_stem(cifar)), _head(feat, num_classes),
        cuts)


def partition_pytree(tree, depth: int, num_stages: int, *,
                     boundaries: Sequence[int] | None = None) -> List[dict]:
    """A whole-model params or state tree -> the `split_stages` trees."""
    _, counts = _SPECS[depth]
    cuts = staging.split_points(num_stages, boundaries, sum(counts))
    return staging.partition_tree(tree, cuts)


__all__ = ["partition_pytree", "resnet", "resnet18", "resnet50",
           "split_stages"]
