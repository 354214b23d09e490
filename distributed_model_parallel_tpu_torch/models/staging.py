"""Stem / blocks / head composition and pipeline-stage partitioning
(port of `models/staging.py`; the stagewise backward belongs to the
gradient-reduction slice).

Every image family (tinycnn, MobileNetV2, ResNet) and the GPT share one
cut-point algorithm and one stage / tree assembly convention, so a
whole-model tree always splits into the trees of the matching pipeline
run and back: stage i = blocks[cuts[i]:cuts[i+1]], the stem prepended
on stage 0 and the head appended on the last, each stage a
`sequential` whose keys are '0', '1', ... in that part order. With an
interleaved virtual pipeline the stages are CHUNKS, S·V of them, dealt
round-robin to the S devices (`chunk_owner`).

Image batches are NHWC; `nhwc_input` views one as NCHW (channels-last
strides, no copy) before the stem, so every layer sees the NCHW view.
"""

from __future__ import annotations

from typing import List, Sequence

from distributed_model_parallel_tpu_torch.models import layers as L


def chunk_owner(logical: int, num_stages: int) -> int:
    """Physical stage that owns logical chunk `logical` under the
    interleaved placement (Megatron SC'21): device s owns logicals
    {s, s+S, s+2S, ...}; with V = 1 the identity."""
    return logical % num_stages


def row_of_logical(logical: int, num_stages: int,
                   virtual_stages: int) -> int:
    """Device-major storage row of logical chunk `logical`: row s·V + v
    holds device s's v-th chunk (logical v·S + s)."""
    s = logical % num_stages
    v = logical // num_stages
    return s * virtual_stages + v


def logical_of_row(row: int, num_stages: int, virtual_stages: int) -> int:
    """Inverse of `row_of_logical`."""
    s = row // virtual_stages
    v = row % virtual_stages
    return v * num_stages + s


def split_points(num_stages: int, boundaries: Sequence[int] | None,
                 n_blocks: int) -> List[int]:
    """Cut points [0, ..., n_blocks] delimiting each stage's block range:
    blocks as evenly as possible, earlier stages taking the remainder,
    unless `boundaries` (num_stages - 1 cut points) is given; [3, 9, 15]
    is the reference's ws=4 MobileNetV2 split. `num_stages` counts
    chunks (S·V for an interleaved pipeline)."""
    if num_stages < 1 or num_stages > n_blocks:
        raise ValueError(f"num_stages must be in [1,{n_blocks}]")
    if boundaries is None:
        base, rem = divmod(n_blocks, num_stages)
        counts = [base + (1 if i < rem else 0) for i in range(num_stages)]
        boundaries = []
        acc = 0
        for c in counts[:-1]:
            acc += c
            boundaries.append(acc)
    if len(boundaries) != num_stages - 1:
        raise ValueError("need num_stages-1 boundaries")
    return [0, *boundaries, n_blocks]


def assemble_stages(blocks: Sequence[L.Layer], stem: L.Layer, head: L.Layer,
                    cuts: Sequence[int]) -> List[L.Layer]:
    """Stage i = blocks[cuts[i]:cuts[i+1]], the stem prepended on stage 0
    and the head appended on the last (the reference's header / medium /
    last roles)."""
    num_stages = len(cuts) - 1
    stages = []
    for i in range(num_stages):
        parts = list(blocks[cuts[i]:cuts[i + 1]])
        if i == 0:
            parts.insert(0, stem)
        if i == num_stages - 1:
            parts.append(head)
        stages.append(L.sequential(*parts))
    return stages


def partition_tree(tree, cuts: Sequence[int]) -> List[dict]:
    """A whole-model `{stem, blocks: {'0'..}, head}` params or state tree
    -> the `assemble_stages` trees (sequential keys, same part order)."""
    num_stages = len(cuts) - 1
    out = []
    for i in range(num_stages):
        parts = []
        if i == 0:
            parts.append(tree["stem"])
        parts.extend(tree["blocks"][str(b)]
                     for b in range(cuts[i], cuts[i + 1]))
        if i == num_stages - 1:
            parts.append(tree["head"])
        out.append({str(j): p for j, p in enumerate(parts)})
    return out


def unpartition_tree(stage_trees: Sequence[dict],
                     cuts: Sequence[int]) -> dict:
    """Inverse of `partition_tree`."""
    num_stages = len(cuts) - 1
    out: dict = {"blocks": {}}
    for i, stage in enumerate(stage_trees):
        k = 0
        if i == 0:
            out["stem"] = stage[str(k)]
            k += 1
        for b in range(cuts[i], cuts[i + 1]):
            out["blocks"][str(b)] = stage[str(k)]
            k += 1
        if i == num_stages - 1:
            out["head"] = stage[str(k)]
    return out


def nhwc_input(layer: L.Layer) -> L.Layer:
    """`layer` applied to the NCHW view of an NHWC batch
    (`permute(0, 3, 1, 2)`: channels-last strides, no copy)."""

    def apply(params, state, x, ctx):
        return layer.apply(params, state, x.permute(0, 3, 1, 2), ctx)

    return L.Layer(layer.init, apply)


def staged_model(stem: L.Layer, blocks: Sequence[L.Layer],
                 head: L.Layer, *, nhwc: bool = True) -> L.Layer:
    """`named([stem, blocks, head])`, over an NHWC batch (the image
    families) or, with `nhwc=False`, over the input as it is (token ids:
    BERT)."""
    model = L.named([
        ("stem", stem),
        ("blocks", L.sequential(*blocks)),
        ("head", head),
    ])
    return nhwc_input(model) if nhwc else model


__all__ = ["assemble_stages", "chunk_owner", "logical_of_row",
           "nhwc_input", "partition_tree", "row_of_logical",
           "split_points", "staged_model", "unpartition_tree"]
