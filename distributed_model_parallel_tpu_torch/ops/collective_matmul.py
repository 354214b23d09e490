"""Latency-hiding collective matmul: chunked permutation rings that
overlap tensor/sequence-parallel collectives with the matmuls that
consume them (port of `ops/collective_matmul.py`).

Where a declarative engine would all-gather an operand and then
multiply, or multiply and then reduce-scatter, the rings DECOMPOSE the
collective (Wang et al., ASPLOS 2023): the gathered operand travels in
S per-rank chunks, one hop at a time round the ring of the group's S
ranks, and the partial matmul of the chunk already on hand runs while
the next hop is in flight.

* `ag_matmul(x, w, group)` — all-gather-then-matmul. x (..., T/S, D)
  holds this rank's rows, w (D, F/S) its column block; returns
  (..., T, F/S). Chunks of x travel the ring; each arrival's dot fills
  the rows it carries.
* `matmul_rs(x, w, group)` — matmul-then-reduce-scatter. x (..., T,
  F/S), w (F/S, D) a row block; returns (..., T/S, D). Partial-sum
  accumulators travel toward the rank whose rows they are, and each rank
  adds its own partial product of the rows an arriving accumulator is
  destined for.

Each ring is exactly S - 1 hops. When S is even, the chunks go both
ways at once (a bidirectional ring, S/2 hops up and S/2 - 1 down): the
up and down hops of one step are one `batch_isend_irecv`, so the S - 1
hops take S/2 steps. Odd S runs one ring. A group of one rank (or None)
is a plain dot.

The reference's `shard_map` + `lax.ppermute` becomes a process group and
the batched isend / irecv of `ops/wire_codec` that the rings of
`ops/ring_attention.py` ride, the up and down hops of a step in one
batch (`_ppermutes_start`): each step's hop is started before the fold
of the chunk already on hand, and waited for after it, so the transfer
overlaps the dot. On a gloo group a CUDA tensor is staged through the
host (`host_staged`). The folds run in the reference's order (the
resident chunk, then hop r's up and down arrivals), so every f32 sum
adds in the reference's order.

`ag_matmul` and `matmul_rs` are `torch.autograd.Function`s whose
backward runs the DUAL ring (the reference's custom VJPs), never the
forward hop by hop transposed: d(ag_matmul)/dx is a matmul_rs ring and
its dw an x-ring; d(matmul_rs)/dx and /dw fold off ONE dy-ring.
`ag_matmul_quant` / `matmul_rs_quant` take an injected chunk GEMM
(`ops/quant_matmul.quant_dot`: the int8 kernel, K4, on each chunk) and
are forward only (the serving decode step). `naive_ag_matmul` /
`naive_matmul_rs` are the monolithic baselines the tests hold the rings
against.

Engine policies over the rings (all opt-in, `collective_matmul=True`),
threaded through `models.layers.Context.matmul` and consumed by
`layers.project`, the one projection hook of the transformer layers:

* `CollectiveMatmul` — `TensorParallelEngine`: each block's four
  Megatron projections over the model group. Between the column and row
  projections of a block the activations are head- / feature-sharded,
  as without the rings; outside the pair the residual stream rides
  sequence-sharded over the group (Megatron-SP, Korthikanti et al.
  2022): the engine scatters it after the embedding and gathers it
  before the head (`scatter_seq` / `gather_seq`).
* `LocalCollectiveMatmul` — the sequence-parallel engines: weights stay
  whole on every rank; each rank slices its column / row block of the
  FFN pair by its index and runs gather->matmul / matmul->scatter over
  the seq group. The attention projections stay local (`attn=False`):
  their outputs feed the K/V ring, which needs sequence-sharded,
  all-head activations.
* `serving/decode.DecodeCollectiveMatmul` — the tp serving layout's
  decode and verify steps, ringing over the slot batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    _ppermutes_start,
    host_staged,
)

#: permutation hops issued by the rings (one per direction a step), for
#: the tests and the smoke run to count against `S - 1` a ring.
hops = 0

Dot = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _split(size: int) -> Tuple[int, int]:
    """(hops on the ascending ring, hops on the descending ring): both
    directions when the size is even, one ring when odd."""
    if size % 2 == 0:
        n_up = size // 2
        return n_up, size - 1 - n_up
    return size - 1, 0


def _plain(a, b):
    return a @ b


def _step_start(up: Optional[torch.Tensor], dn: Optional[torch.Tensor],
                group):
    """Starts one ring step: `up` sent to rank i + 1 (received from
    i - 1) and `dn` to i - 1 (received from i + 1), either may be None,
    in one `batch_isend_irecv`. Returns the function that waits and
    gives (up received, dn received)."""
    global hops
    n = _size(group)
    sent = [(x, tuple((i, (i + shift) % n) for i in range(n)))
            for x, shift in ((up, 1), (dn, -1)) if x is not None]
    hops += len(sent)
    finish = _ppermutes_start(sent, group)

    def received():
        got = iter(finish())
        return tuple(None if x is None else next(got) for x in (up, dn))

    return received


def _ring_fold(seed: torch.Tensor, group, carry, fold):
    """The ring skeleton the kernels here share: `seed` (this rank's
    chunk) travels S - 1 hops round `group` (both ways when S is even),
    and `carry = fold(carry, chunk, offset)` runs on the resident chunk
    (offset 0) and on each arrival; `offset` is the signed ring distance
    of the chunk's origin (an up arrival at hop r came from rank i - r,
    offset -r; a down one from i + r, offset +r). Folds run in the
    reference's order; each step's hop is in flight during the folds of
    the chunks that arrived before it."""
    size = _size(group)
    if size == 1:
        return fold(carry, seed, 0)
    n_up, n_dn = _split(size)
    pending = _step_start(seed, seed if n_dn else None, group)
    carry = fold(carry, seed, 0)
    for r in range(1, n_up + 1):
        fwd, bwd = pending()
        if r < n_up:
            pending = _step_start(fwd, bwd if r < n_dn else None, group)
        carry = fold(carry, fwd, -r)
        if bwd is not None:
            carry = fold(carry, bwd, +r)
    return carry


def _rows(x: torch.Tensor, c: int, tl: int) -> torch.Tensor:
    """Rows [c tl, (c + 1) tl) of x along its second-to-last axis."""
    return x.narrow(-2, c * tl, tl)


def _flat(a: torch.Tensor) -> torch.Tensor:
    """(..., R, C) -> (prod(...) R, C): the contraction view for dw."""
    return a.reshape(-1, a.shape[-1])


# --------------------------------------------------------------- forward


def _ag_matmul_impl(x, w, group, dot: Optional[Dot] = None):
    """All-gather-then-matmul, the gather decomposed into S - 1 hops.
    `dot` is the chunk GEMM seam (None: `chunk @ w`); the hops never see
    it."""
    dot = dot or _plain
    size = _size(group)
    if size == 1:
        return dot(x, w)
    i, tl = _index(group), x.shape[-2]
    out: List[Optional[torch.Tensor]] = [None] * size

    def fold(buf, chunk, off):
        # The chunk came from rank i + off; its rows belong there.
        buf[(i + off) % size] = dot(chunk, w)
        return buf

    return torch.cat(_ring_fold(x, group, out, fold), dim=-2)


def _matmul_rs_impl(x, w, group, dot: Optional[Dot] = None):
    """Matmul-then-reduce-scatter, the scatter decomposed into S - 1
    hops: accumulators travel toward their destination rank and each
    rank adds its partial product of the rows the arriving accumulator
    is bound for. The up and down chains advance in lockstep (one
    batched step), each adding in the reference's order; the result is
    (own + up chain) + down chain, as in the reference. Partial sums
    accumulate in the dot's output dtype (f32 for the dequantized int8
    chunks)."""
    dot = dot or _plain
    size = _size(group)
    if size == 1:
        return dot(x, w)
    i, t = _index(group), x.shape[-2]
    if t % size:
        raise ValueError(
            f"matmul_rs: row count {t} not divisible by the ring size "
            f"{size}")
    tl = t // size

    def pchunk(c):
        return dot(_rows(x, c % size, tl), w)

    n_up, n_dn = _split(size)
    out = pchunk(i)
    up = pchunk(i + n_up)
    dn = pchunk(i - n_dn) if n_dn else None
    dn_done = None
    for r in range(1, n_up + 1):
        # Hop r of each chain; the next partial products overlap it.
        pending = _step_start(up, dn, group)
        nxt_up = pchunk(i + n_up - r) if r < n_up else None
        nxt_dn = pchunk(i - (n_dn - r)) if dn is not None and r < n_dn \
            else None
        up_in, dn_in = pending()
        if r < n_up:
            up = up_in + nxt_up
        else:
            out = out + up_in
        if dn is not None:
            if r < n_dn:
                dn = dn_in + nxt_dn
            else:
                dn, dn_done = None, dn_in
    return out if dn_done is None else out + dn_done


# -------------------------------------------------------------- backward


def _ag_dw_ring(x, dy, group):
    """dw = gathered(x)^T @ dy without a gather: x's chunks travel the
    forward's ring and each arrival's outer product with the matching
    rows of the resident dy is folded in."""
    size, i, tl = _size(group), _index(group), x.shape[-2]

    def fold(dw, chunk, off):
        return dw + _flat(chunk).t() @ _flat(_rows(dy, (i + off) % size,
                                                   tl))

    dw = torch.zeros((x.shape[-1], dy.shape[-1]),
                     dtype=torch.result_type(x, dy), device=x.device)
    return _ring_fold(x, group, dw, fold)


def _rs_bwd_ring(x, w, dy, group):
    """matmul_rs's backward, both cotangents off ONE dy-ring:
    dx = gathered(dy) @ w^T (the dual ag_matmul) and dw = x^T @
    gathered(dy), folded per arriving chunk."""
    size, i, tl = _size(group), _index(group), dy.shape[-2]
    wt = w.t()

    def fold(carry, dyc, off):
        dx, dw = carry
        src = (i + off) % size
        dx[src] = dyc @ wt
        return dx, dw + _flat(_rows(x, src, tl)).t() @ _flat(dyc)

    dw = torch.zeros(w.shape, dtype=torch.result_type(x, dy),
                     device=w.device)
    dx, dw = _ring_fold(dy, group, ([None] * size, dw), fold)
    return torch.cat(dx, dim=-2), dw


# --------------------------------------------------------- public kernels


class _AgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.group = group
        ctx.save_for_backward(x, w)
        return _ag_matmul_impl(x, w, group)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _matmul_rs_impl(dy, w.t(), ctx.group)
        dw = _ag_dw_ring(x, dy, ctx.group)
        return dx.to(x.dtype), dw.to(w.dtype), None


class _MatmulRs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.group = group
        ctx.save_for_backward(x, w)
        return _matmul_rs_impl(x, w, group)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rs_bwd_ring(x, w, dy.contiguous(), ctx.group)
        return dx.to(x.dtype), dw.to(w.dtype), None


def ag_matmul(x, w, group=None):
    """gathered(x) @ w over `group`, the gather chunked into S - 1
    overlapped hops. x (..., T/S, D) this rank's rows, w (D, F/S);
    returns (..., T, F/S). Backward: dx by the dual matmul_rs ring, dw
    by an x-ring."""
    if _size(group) == 1:
        return x @ w
    return _AgMatmul.apply(x, w, group)


def matmul_rs(x, w, group=None):
    """reduce_scatter(x @ w) over `group`, the scatter chunked into S - 1
    overlapped hops. x (..., T, F/S), w (F/S, D); returns (..., T/S, D),
    this rank's rows. Backward: dx and dw off one dy-ring."""
    if _size(group) == 1:
        return x @ w
    return _MatmulRs.apply(x, w, group)


def ag_matmul_quant(x, w, group, dot: Optional[Dot]):
    """Forward-only `ag_matmul` with an injected chunk GEMM
    (`quant_dot`): the same hops carrying the same activation chunks in
    their own dtype; only the chunk dot's arithmetic changes."""
    return _ag_matmul_impl(x, w, group, dot=dot)


def matmul_rs_quant(x, w, group, dot: Optional[Dot]):
    """Forward-only `matmul_rs` with an injected chunk GEMM; the partial
    sums travel and accumulate in the dot's output dtype."""
    return _matmul_rs_impl(x, w, group, dot=dot)


# ----------------------------------------------------- naive references


def _all_gather_rows(x: torch.Tensor, group, dim: int = -2) -> torch.Tensor:
    """The group's x concatenated along `dim` in rank order (the
    reference's tiled `lax.all_gather`)."""
    n = _size(group)
    if n == 1:
        return x
    src = x.cpu() if host_staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def naive_ag_matmul(x, w, group=None):
    """The monolithic baseline: one all-gather, then the matmul."""
    return _all_gather_rows(x, group) @ w


def naive_matmul_rs(x, w, group=None):
    """The monolithic baseline: the matmul, then one sum and this rank's
    rows of it (the reference's `psum_scatter`)."""
    y = (x @ w).contiguous()
    n = _size(group)
    if n == 1:
        return y
    dist.all_reduce(y, group=group)
    return _rows(y, _index(group), y.shape[-2] // n)


# ------------------------------------------------------ engine policies


def _check_div(what: str, n: int, size: int, label: str) -> None:
    if n % size != 0:
        raise ValueError(
            f"collective_matmul: {label} ({n}) must be divisible by the "
            f"ring size ({size}) for the {what} chunking"
        )


class _ScatterSeq(torch.autograd.Function):
    """This rank's rows of the replicated (B, T, ...) along axis 1;
    backward: the rows' cotangents all-gathered (every rank's stem sees
    the whole sequence's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = _size(group)
        t = x.shape[1] // n
        return x.narrow(1, _index(group) * t, t).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_rows(g, ctx.group, dim=1), None


class _GatherSeq(torch.autograd.Function):
    """Every rank's rows of (B, T/S, ...) along axis 1, gathered in rank
    order; backward: this rank's rows of the cotangent (the head after
    the gather runs replicated, so every rank holds the same one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_rows(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        n = _size(ctx.group)
        t = g.shape[1] // n
        return g.narrow(1, _index(ctx.group) * t, t).contiguous(), None


def scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron-SP's entry: x (B, T, ...) replicated over `group` ->
    this rank's T/S positions. The sequence length must split over the
    ring (the reference's message)."""
    size = _size(group)
    _check_div("column", x.shape[1], size, "sequence length")
    return _ScatterSeq.apply(x, group) if size > 1 else x


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron-SP's exit: every rank's positions, in order."""
    return _GatherSeq.apply(x, group) if _size(group) > 1 else x


@dataclasses.dataclass(frozen=True)
class CollectiveMatmul:
    """`TensorParallelEngine`'s policy over the model group `group`
    (module doc): a column projection takes this rank's positions (B,
    T/S, D) and a column shard of the weight and returns (B, T, F/S)
    through the `ag_matmul` ring; a row projection takes (B, T, F/S) and
    a row shard and reduce-scatters the partial sums back onto this
    rank's positions, (B, T/S, D), the bias added once a row."""

    group: Any

    def column(self, h, w, b):
        return ag_matmul(h, w, self.group) + b

    def row(self, h, w, b):
        return matmul_rs(h, w, self.group) + b


@dataclasses.dataclass(frozen=True)
class LocalCollectiveMatmul:
    """The sequence-parallel engines' policy over the seq group `group`
    (module doc): weights whole in storage, so checkpoints and the
    dense twin interoperate; each rank slices its column / row block of
    the FFN pair, and the slice's backward scatters the block's gradient
    into the full-shape gradient, which the engine's sum over the seq
    ranks reassembles, like every other parameter's."""

    group: Any
    attn = False  # not a field: the attention projections stay local

    def column(self, h, w, b):
        """h (B, T/S, D) this rank's positions -> (B, T, F/S): this
        rank's column block over every rank's positions."""
        size = _size(self.group)
        _check_div("column", w.shape[-1], size, "output features")
        fl = w.shape[-1] // size
        i = _index(self.group)
        return ag_matmul(h, w.narrow(-1, i * fl, fl), self.group) \
            + b.narrow(0, i * fl, fl)

    def row(self, h, w, b):
        """h (B, T, F/S) -> (B, T/S, D): this rank's row block's partial
        sums, reduce-scattered onto its positions; the whole bias added
        once a row, on the rank that owns it."""
        size = _size(self.group)
        _check_div("row", w.shape[0], size, "input features")
        fl = w.shape[0] // size
        return matmul_rs(h, w.narrow(0, _index(self.group) * fl, fl),
                         self.group) + b


__all__ = [
    "CollectiveMatmul",
    "LocalCollectiveMatmul",
    "ag_matmul",
    "ag_matmul_quant",
    "matmul_rs",
    "matmul_rs_quant",
    "gather_seq",
    "naive_ag_matmul",
    "naive_matmul_rs",
    "scatter_seq",
]
