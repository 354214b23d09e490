"""Stem / blocks / head composition, pipeline-stage partitioning and
the stagewise backward (port of `models/staging.py`).

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

The stagewise backward (`stagewise_value_and_grad`) is the substrate of
`grad_reduction="overlapped"`: the forward is cut at the pipeline's
block boundaries, and the backward runs segment by segment, late layers
first, handing each segment's gradients to the bucketed reducer
(`ops/grad_reduction.py`) before the earlier segments' backward is
issued: the Reducer's autograd-hook overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_like,
)


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


# ------------------------------------------------- stagewise backward


@dataclasses.dataclass(frozen=True)
class StageParts:
    """The stem / blocks / head anatomy of a composed model, attached to
    it by `staged_model`, so that the overlapped engines cut the SAME
    layers (same parameter layout, same `Context.child` chain) into
    backward segments. On the image families `stem` includes the NHWC ->
    NCHW view that the whole model applies first."""

    stem: L.Layer
    blocks: Tuple[L.Layer, ...]
    head: L.Layer


def staged_model(stem: L.Layer, blocks: Sequence[L.Layer],
                 head: L.Layer, *, nhwc: bool = True) -> L.Layer:
    """`named([stem, blocks, head])` with its `StageParts` attached, over
    an NHWC batch (the image families) or, with `nhwc=False`, over the
    input as it is (token ids: BERT)."""
    model = L.named([
        ("stem", stem),
        ("blocks", L.sequential(*blocks)),
        ("head", head),
    ])
    if nhwc:
        model, stem = nhwc_input(model), nhwc_input(stem)
    return dataclasses.replace(
        model, parts=StageParts(stem, tuple(blocks), head))


def resolve_overlap_segments(n_blocks: int, overlap_stages: int,
                             label: str, noun: str = "blocks") -> int:
    """The stagewise segment count: 0 = auto (min(4, n_blocks));
    otherwise at least 2 and at most one block a segment."""
    if n_blocks < 2:
        raise ValueError(
            f"{label}: grad_reduction='overlapped' splits the backward "
            f"into >= 2 segments; the model has only {n_blocks} "
            f"{noun[:-1]}(s)"
        )
    if overlap_stages == 0:
        return min(4, n_blocks)
    if overlap_stages < 2 or overlap_stages > n_blocks:
        raise ValueError(
            f"{label}: overlap_stages must be in [2, {n_blocks}] "
            f"({noun}), got {overlap_stages}"
        )
    return overlap_stages


def resolve_overlap_stages(parts: Optional[StageParts],
                           overlap_stages: int, label: str) -> int:
    """`resolve_overlap_segments` over a model's `StageParts` (raises
    when the model never went through `staged_model`)."""
    if parts is None:
        raise ValueError(
            f"{label}: grad_reduction='overlapped' needs a model that "
            "exposes its stem/blocks/head anatomy "
            "(models/staging.staged_model); this model has no .parts"
        )
    return resolve_overlap_segments(len(parts.blocks), overlap_stages, label)


def stage_apply_fns(parts: StageParts, cuts: Sequence[int],
                    ctx: L.Context) -> List[Callable]:
    """Per-stage closures `fn(stage_params, stage_state, x) -> (y,
    new_stage_state)` over `partition_tree` trees, with the composed
    model's `Context.child` chain (stem -> child(0), block j ->
    child(1).child(j), head -> child(2)), so dropout draws the monolithic
    forward's masks."""
    num_stages = len(cuts) - 1
    block_ctx = ctx.child(1)
    fns = []
    for i in range(num_stages):
        entries = []
        if i == 0:
            entries.append((parts.stem, ctx.child(0)))
        for j in range(cuts[i], cuts[i + 1]):
            entries.append((parts.blocks[j], block_ctx.child(j)))
        if i == num_stages - 1:
            entries.append((parts.head, ctx.child(2)))

        def fn(params, state, x, entries=entries):
            new_state = {}
            for k, (layer, c) in enumerate(entries):
                x, new_state[str(k)] = layer.apply(params[str(k)],
                                                   state[str(k)], x, c)
            return x, new_state

        fns.append(fn)
    return fns


def _float_leaves(tree) -> list:
    return [t for t in tree_leaves(tree)
            if t is not None and t.is_floating_point()]


def _cut(tree):
    """A stage boundary: each tensor detached from the graph before it,
    the floating ones made leaves that take a gradient (None, a ViT's
    absent mask, passes)."""
    if type(tree) is tuple:
        return tuple(_cut(t) for t in tree)
    if tree is None:
        return None
    t = tree.detach()
    return t.requires_grad_() if t.is_floating_point() else t


def stagewise_value_and_grad(
    stage_fns: Sequence[Callable],
    loss_fn: Callable,
    stage_params: Sequence[Any],
    stage_states: Sequence[Any],
    x: Any,
    *,
    aux_of_state: Optional[Callable] = None,
    on_stage_grads: Optional[Callable] = None,
):
    """Segment-by-segment value and gradient, late layers first.

    `stage_fns[k](params_k, state_k, x) -> (y, new_state_k)`; `loss_fn(
    y_last) -> (loss, loss_aux)`, the scalar differentiated. The forward
    runs stage by stage, each later stage's input detached and made a
    leaf (a stage's I/O is a tensor or a tuple such as (hidden, mask);
    stage 0's input takes no gradient). The backward is one
    `torch.autograd.grad` a stage, from the loss through the last stage,
    then each earlier stage from the gradient of its output.
    `on_stage_grads(k, grads_k)` runs as soon as stage k's gradients
    exist, before stage k-1's backward is issued; what it returns takes
    their place. Returns (loss, loss_aux, stage_grads, stage_new_states)
    in `partition_tree` layout (reassemble with `unpartition_tree`); in
    f32 the gradients equal one `torch.autograd.grad` over the whole
    model bit for bit.

    Differentiable penalties riding the state (`moe_aux`) enter through
    `aux_of_state(new_state_k) -> scalar` (the reference's channel):
    each stage's aux joins its backward with a unit cotangent, which
    adds its gradient exactly as a monolithic `loss + sum(aux)` would."""
    n = len(stage_fns)
    inputs, outputs, new_states, auxes = [], [], [], []
    y = x
    for k in range(n):
        if k:
            y = _cut(y)
        inputs.append(y)
        y, ns = stage_fns[k](stage_params[k], stage_states[k], y)
        outputs.append(y)
        new_states.append(ns)
        a = aux_of_state(ns) if aux_of_state is not None else None
        auxes.append(a if torch.is_tensor(a) and a.requires_grad else None)
    loss, loss_aux = loss_fn(y)
    grads: List[Any] = [None] * n
    outs, cot = [loss], [torch.ones_like(loss)]
    for k in reversed(range(n)):
        p_leaves = list(tree_leaves(stage_params[k]))
        x_leaves = _float_leaves(inputs[k]) if k else []
        if auxes[k] is not None:
            outs = outs + [auxes[k]]
            cot = cot + [torch.ones_like(auxes[k])]
        got = torch.autograd.grad(outs, p_leaves + x_leaves,
                                  grad_outputs=cot)
        g = tree_like(stage_params[k], iter(got[:len(p_leaves)]))
        grads[k] = g if on_stage_grads is None else on_stage_grads(k, g)
        if k:
            outs = _float_leaves(outputs[k - 1])
            cot = list(got[len(p_leaves):])
    return loss.detach(), loss_aux, grads, new_states


__all__ = ["StageParts", "assemble_stages", "chunk_owner", "logical_of_row",
           "nhwc_input", "partition_tree", "resolve_overlap_segments",
           "resolve_overlap_stages", "row_of_logical", "split_points",
           "stage_apply_fns", "staged_model", "stagewise_value_and_grad",
           "unpartition_tree"]
