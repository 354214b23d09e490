"""The stem / blocks / head composition the image models share (port of
`staged_model` from `models/staging.py`; the stage splits and the
stagewise backward belong to the pipeline and gradient-reduction
slices).
"""

from __future__ import annotations

from typing import Sequence

from distributed_model_parallel_tpu_torch.models import layers as L


def staged_model(stem: L.Layer, blocks: Sequence[L.Layer],
                 head: L.Layer) -> L.Layer:
    """`named([stem, blocks, head])` over an NHWC batch: the input is
    viewed as NCHW with `permute(0, 3, 1, 2)` (channels-last strides, no
    copy) before the stem, so every layer sees the NCHW view."""
    model = L.named([
        ("stem", stem),
        ("blocks", L.sequential(*blocks)),
        ("head", head),
    ])

    def apply(params, state, x, ctx):
        return model.apply(params, state, x.permute(0, 3, 1, 2), ctx)

    return L.Layer(model.init, apply)


__all__ = ["staged_model"]
