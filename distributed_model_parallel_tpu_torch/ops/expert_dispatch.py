"""Hierarchical, overlapped MoE expert dispatch (port of
`ops/expert_dispatch.py`): the hand-written two-level token exchange
over `torch.distributed`.

The expert-parallel world is the (factored) data fabric itself: the S =
K * I ranks of the data axis (`runtime/mesh.py`: K slices of I ranks,
rank = dcn_index * I + ici_index, the reference's dcn-major fabric
index) each own E/S experts. A rank's local dispatch buffer (E, b, C, D),
expert-major by destination, moves in two stages:

    intra-slice exchange over `ici_group`   I-1 hops, the 1/I of the
                                            buffer bound for one ici
                                            column each
    cross-slice exchange over `dcn_group`   K-1 hops on the regrouped
                                            buffer, each carrying the
                                            1/ici expert shard

so the slow fabric sees K-1 contiguous messages of |X|/K instead of the
flat exchange's (K-1) * I fragments. `_a2a_chunks` is the primitive of
both levels: an all-to-all of the leading axis's chunks as G-1
permutation hops, started together in one `batch_isend_irecv`
(`ops/wire_codec._ppermutes_start`; on a gloo group a CUDA tensor is
staged through the host). Chunk j goes to the rank at group index j and
the result is indexed by source; the map is its own inverse and its
own transpose. `wire` ("none" | "bf16" | "int8", `ops/wire_codec.py`)
encodes each cross-slice hop's payload, the int8 scale riding the same
permutation; the intra-slice stage always moves the math dtype.

* `dispatch_exchange` / `combine_exchange`: (E, b, C, D) -> (E/S, S*b,
  C, D) and back, each a `torch.autograd.Function` whose backward is the
  mirrored movement over the same wire (the reference's custom VJP).
* `overlapped_expert_ffn`: the exchange, the expert FFN and the return
  fused, chunk by chunk: on ring hop r the chunk from source i - r
  arrives and its FFN runs while the hop-(r+1) chunk and the hop-r
  return are in flight (the reference's `_ffn_ring`, the decomposition
  of `ops/collective_matmul.py`). One autograd Function a ring, whose
  backward runs the same ring on the cotangents (each chunk's FFN
  vector-Jacobian product where its forward ran), so every rank issues
  every backward hop in the same order. On a factored mesh the ici
  regroup runs first and the ring rides the dcn group: the slow hops are
  the hidden ones.
* `exchange_permutes(I, K)`: 2(I-1) + 2(K-1) hops a forward exchange
  pair, fused or not; `hops` counts the hops issued (payload hops; the
  int8 scale sidecars are not counted).
* `flat_expert_exchange` / `flat_expert_return`: the one-collective
  baseline (`all_to_all_single` over the whole data group), forward
  only, for the tests.

Two policies, threaded to `models/moe.py` through
`Context.expert_dispatch`:

* `ExpertDispatch`: `ExpertParallelEngine(dispatch="hierarchical")`. The
  rank holds its E/S expert block at rest; the load-balance statistics
  are summed over the data group (`reduce_aux`), as the reference's
  GSPMD computes them over the global batch.
* `LocalExpertDispatch`: the DDP engines. The weights stay whole on
  every rank; each slices its E/S block by fabric index, the slice's
  backward scatters the block gradient into the full-shape leaf, and the
  engine's data mean reassembles the replicated-dense gradient. The aux
  loss stays per rank (the reference's shard_map semantics).

Parity with the reference and with the dense layer at rtol 1e-5 in f32
(`tests/test_torch_port_moe_exchange.py`): the exchange is a permutation
of the buffers, so the math is the dense layer's up to batching order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.models.layers import (
    _AllReduceSum,
    reduce_from_model_parallel,
)
from distributed_model_parallel_tpu_torch.models.moe import (
    dense_experts,
    expert_ffn,
)
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    _ppermutes_start,
    host_staged,
    require_dcn_axis,
    wire_decode,
    wire_encode,
)

#: payload hops issued by the exchanges (forward and backward), for the
#: accounting checks against `exchange_permutes`
hops = 0


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _check_experts(e: int, s: int) -> int:
    if e % s:
        raise ValueError(
            f"expert dispatch: num_experts ({e}) must be divisible by "
            f"the expert-parallel fabric size ({s}) — each device owns "
            "an E/S expert block")
    return e // s


def _hops_start(pairs, group, wire: str = "none"):
    """Starts every (chunk, perm) hop of `pairs` in one batch, each payload
    through the wire codec; returns the function that waits and gives
    the decoded chunks received, in order."""
    global hops
    hops += len(pairs)
    sent, meta = [], []
    for x, perm in pairs:
        # contiguous: a chunk of a transposed buffer is a strided view,
        # and a host-staged (gloo) send copies the view as it is
        payload, scale = wire_encode(wire, x.contiguous())
        sent.append((payload, perm))
        if scale is not None:
            sent.append((scale.reshape(1), perm))
        meta.append((scale is not None, x.dtype))
    finish = _ppermutes_start(sent, group)

    def received() -> list:
        got = iter(finish())
        out = []
        for has_scale, dtype in meta:
            payload = next(got)
            scale = next(got).reshape(()) if has_scale else None
            out.append(wire_decode(wire, payload, scale, dtype))
        return out

    return received


def _shift(size: int, r: int) -> tuple:
    """The permutation of hop r: group index j sends to j + r."""
    return tuple((j, (j + r) % size) for j in range(size))


def _a2a_chunks(x: torch.Tensor, group, wire: str = "none") -> torch.Tensor:
    """(G, ...) dest-indexed -> (G, ...) source-indexed over `group` (G its
    size), as G-1 hops: hop r moves every rank's chunk for the rank r
    steps on. `wire` encodes each hop's payload."""
    size = _size(group)
    if x.shape[0] != size:
        raise ValueError(f"_a2a_chunks: leading axis {x.shape[0]} != group "
                         f"size {size}")
    if size == 1:
        return x
    i = _index(group)
    got = _hops_start([(x[(i + r) % size], _shift(size, r))
                       for r in range(1, size)], group, wire)()
    out = torch.empty_like(x)
    out[i] = x[i]
    for r, chunk in enumerate(got, start=1):
        out[(i - r) % size] = chunk
    return out


class _A2A(torch.autograd.Function):
    """`_a2a_chunks` under autograd: its own transpose."""

    @staticmethod
    def forward(ctx, x, group, wire):
        ctx.group, ctx.wire = group, wire
        return _a2a_chunks(x, group, wire)

    @staticmethod
    def backward(ctx, g):
        return _a2a_chunks(g.contiguous(), ctx.group, ctx.wire), None, None


def a2a_chunks(x: torch.Tensor, group, wire: str = "none") -> torch.Tensor:
    """Differentiable `_a2a_chunks` (the identity at one rank)."""
    return x if _size(group) == 1 else _A2A.apply(x, group, wire)


# --------------------------------------------- two-level movement ops


def _dispatch_impl(xin, ici, dcn, wire="none"):
    """(E, b, C, D) dest-expert-major -> (E/S, S*b, C, D): this rank's
    expert block's inputs from every source, sources in fabric order
    (dcn-major, as the batch shards). `wire` codes the dcn stage only."""
    n_i, n_k = _size(ici), _size(dcn)
    e, b, c, d = xin.shape
    s = n_i * n_k
    el = _check_experts(e, s)
    x = xin.reshape(n_k, n_i, el, b, c, d)
    x = _a2a_chunks(x.transpose(0, 1), ici)        # (I_src, K_dest, ...)
    x = x.transpose(0, 1)                          # (K_dest, I_src, ...)
    if dcn is not None:
        x = _a2a_chunks(x.contiguous(), dcn, wire)  # (K_src, I_src, ...)
    return x.movedim(2, 0).reshape(el, s * b, c, d)


def _combine_impl(y, ici, dcn, wire="none"):
    """Inverse of `_dispatch_impl`: (E/S, S*b, C, D) expert outputs back to
    (E, b, C, D) at each token's home rank."""
    n_i, n_k = _size(ici), _size(dcn)
    el, sb, c, d = y.shape
    s = n_i * n_k
    if sb % s:
        raise ValueError(
            f"combine: gathered batch {sb} not divisible by fabric {s}")
    b = sb // s
    x = y.reshape(el, n_k, n_i, b, c, d).movedim(0, 2)  # (K_src, I_src,..)
    if dcn is not None:
        x = _a2a_chunks(x.contiguous(), dcn, wire)   # (K_dest, I_src, ...)
    x = _a2a_chunks(x.transpose(0, 1), ici)          # (I_dest, K_dest, ...)
    return x.transpose(0, 1).reshape(el * s, b, c, d)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xin, ici, dcn, wire):
        ctx.groups = (ici, dcn, wire)
        return _dispatch_impl(xin, ici, dcn, wire)

    @staticmethod
    def backward(ctx, dy):
        return (_combine_impl(dy.contiguous(), *ctx.groups), None, None,
                None)


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ici, dcn, wire):
        ctx.groups = (ici, dcn, wire)
        return _combine_impl(y, ici, dcn, wire)

    @staticmethod
    def backward(ctx, dy):
        return (_dispatch_impl(dy.contiguous(), *ctx.groups), None, None,
                None)


def _one_rank(ici, dcn) -> bool:
    return _size(ici) * _size(dcn) == 1


def dispatch_exchange(xin, ici, dcn=None, wire: str = "none"):
    """Two-level token dispatch, (E, b, C, D) -> (E/S, S*b, C, D); the
    backward runs the combine-direction movement over the same wire. At
    one rank it is the identity and issues nothing."""
    if _one_rank(ici, dcn):
        return xin
    return _Dispatch.apply(xin, ici, dcn, wire)


def combine_exchange(y, ici, dcn=None, wire: str = "none"):
    """Two-level expert-output return, (E/S, S*b, C, D) -> (E, b, C, D);
    the backward runs the dispatch-direction movement."""
    if _one_rank(ici, dcn):
        return y
    return _Combine.apply(y, ici, dcn, wire)


def _flat_a2a(x: torch.Tensor, group) -> torch.Tensor:
    """(S, ...) dest-indexed -> source-indexed in ONE all_to_all_single."""
    host = host_staged(x, group)
    src = x.cpu() if host else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if host else out


def flat_expert_exchange(xin: torch.Tensor, group) -> torch.Tensor:
    """The monolithic baseline the two-level path replaces: one fused
    all-to-all over the whole data group, (E, b, C, D) -> (E/S, S*b, C,
    D) (the reference's tiled `lax.all_to_all`). Forward only."""
    s = _size(group)
    e, b, c, d = xin.shape
    el = _check_experts(e, s)
    x = _flat_a2a(xin.reshape(s, el, b, c, d), group)
    return x.movedim(1, 0).reshape(el, s * b, c, d)


def flat_expert_return(y: torch.Tensor, group) -> torch.Tensor:
    """Inverse of `flat_expert_exchange`."""
    s = _size(group)
    el, sb, c, d = y.shape
    x = y.reshape(el, s, sb // s, c, d).movedim(1, 0)
    return _flat_a2a(x.contiguous(), group).reshape(el * s, sb // s, c, d)


# -------------------------------------------------- overlapped kernel


def _chunk_ffn(ffn, ch: torch.Tensor) -> torch.Tensor:
    """The expert FFN on one ring chunk: (el, b, C, D) (flat ring) or (I,
    el, b, C, D) (the regrouped dcn ring), expert-major inside."""
    if ch.dim() == 4:
        return ffn(ch)
    n_i, el, b, c, d = ch.shape
    z = ch.movedim(1, 0).reshape(el, n_i * b, c, d)
    return ffn(z).reshape(el, n_i, b, c, d).movedim(0, 1)


def _ring(z: torch.Tensor, group, wire: str, fn) -> torch.Tensor:
    """The latency-hiding loop over `group`: z (G, ...) dest-indexed
    chunks; `fn(r, chunk)` runs on the chunk that hop r delivers (r 0:
    this rank's own) while the next hop and the previous return are in
    flight; slot g of the result is `fn`'s output for this rank's chunk
    g, back home."""
    size, i = _size(group), _index(group)

    def fwd(r):
        return _hops_start([(z[(i + r) % size], _shift(size, r))], group,
                           wire)

    out = torch.empty_like(z)
    pending = fwd(1) if size > 1 else None
    out[i] = fn(0, z[i])
    back, slot = None, None
    for r in range(1, size):
        recv = pending()[0]
        pending = fwd(r + 1) if r + 1 < size else None
        y = fn(r, recv)
        if back is not None:
            out[slot] = back()[0]
        back = _hops_start([(y, _shift(size, -r))], group, wire)
        slot = (i + r) % size
    if back is not None:
        out[slot] = back()[0]
    return out


class _FFNRing(torch.autograd.Function):
    """`_ring` with the expert FFN as `fn`. Each chunk's FFN runs on leaf
    copies of its input and of the weights, and its graph is kept; the
    backward runs `_ring` on the output cotangents with each chunk's
    vector-Jacobian product (input gradient sent home, weight gradients
    summed where the chunk ran)."""

    @staticmethod
    def forward(ctx, z, group, wire, keys, dtype, *w):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in w]
        params = dict(zip(keys, leaves))
        graphs = []

        def fn(r, ch):
            x = ch.detach().requires_grad_(True)
            with torch.enable_grad():
                y = _chunk_ffn(lambda t: expert_ffn(params, t, dtype), x)
            graphs.append((x, y))
            return y.detach()

        out = _ring(z, group, wire, fn)
        ctx.state = (group, wire, leaves, graphs)
        return out

    @staticmethod
    def backward(ctx, dout):
        group, wire, leaves, graphs = ctx.state
        wanted = [t for t in leaves if t.requires_grad]
        dw = [None] * len(wanted)

        def vjp(r, g):
            x, y = graphs[r]
            got = torch.autograd.grad(y, [x] + wanted, g)
            for j, t in enumerate(got[1:]):
                dw[j] = t if dw[j] is None else dw[j] + t
            return got[0]

        dz = _ring(dout.contiguous(), group, wire, vjp)
        ctx.state = None
        it = iter(dw)
        return ((dz, None, None, None, None)
                + tuple(next(it) if t.requires_grad else None
                        for t in leaves))


def _ffn_ring(z, w, group, wire="none", dtype=None):
    keys = tuple(w)
    return _FFNRing.apply(z, group, wire, keys, dtype,
                          *(w[k] for k in keys))


def overlapped_expert_ffn(xin, w, ici, dcn=None, wire: str = "none",
                          dtype=None):
    """Fused exchange + expert FFN + return with chunked overlap: the FFN
    on chunk k runs while chunk k+1 and the return of chunk k-1 move.
    One fabric: the ring over `ici` (S chunks). Factored: the ici regroup
    first (I-1 hops), the ring over `dcn` (K chunks, each the 1/ici
    regrouped shard), then the inverse regroup. The hop count is the
    unfused path's. `w` is this rank's E/S expert block."""
    n_i, n_k = _size(ici), _size(dcn)
    e, b, c, d = xin.shape
    el = _check_experts(e, n_i * n_k)
    if dcn is None:
        z = xin.reshape(n_i, el, b, c, d)
        return _ffn_ring(z, w, ici, dtype=dtype).reshape(e, b, c, d)
    x = xin.reshape(n_k, n_i, el, b, c, d).transpose(0, 1)
    x = a2a_chunks(x.contiguous(), ici)             # (I_src, K_dest, ...)
    z = x.transpose(0, 1).contiguous()              # (K_dest, I_src, ...)
    out = _ffn_ring(z, w, dcn, wire, dtype)         # (K_dest, I_src, ...)
    out = a2a_chunks(out.transpose(0, 1).contiguous(), ici)
    return out.transpose(0, 1).reshape(e, b, c, d)


def exchanged_expert_ffn(xin, w, ici, dcn=None, overlap: bool = False,
                         wire: str = "none", dtype=None):
    """One MoE layer's exchange + FFN + return on local buffers: the
    unfused two-level path (dispatch -> one FFN -> combine) or the
    chunked overlapped ring. Both issue `exchange_permutes(I, K)` hops
    forward and as many backward, whatever the wire."""
    if overlap and not _one_rank(ici, dcn):
        return overlapped_expert_ffn(xin, w, ici, dcn, wire, dtype)
    z = dispatch_exchange(xin, ici, dcn, wire)
    y = expert_ffn(w, z, dtype)
    return combine_exchange(y, ici, dcn, wire)


def exchange_permutes(ici_size: int, dcn_size: int = 1) -> int:
    """Hops of ONE forward exchange pair (dispatch + combine, fused or
    not): 2(I-1) + 2(K-1). A train step doubles it."""
    return 2 * (ici_size - 1) + 2 * (dcn_size - 1)


# ------------------------------------------------------------ policies


def _moe_local(h, dispatch, combine, w, *, ici, dcn, overlap, wire):
    """Per-rank MoE FFN around the exchange: local one-hot pack, the
    two-level (optionally overlapped) exchange + FFN, local weighted
    unpack. `w` is this rank's E/S expert block."""
    xin = torch.einsum("btec,btd->ebcd", dispatch, h)
    y = exchanged_expert_ffn(xin, w, ici, dcn, overlap, wire, h.dtype)
    return torch.einsum("btec,ebcd->btd", combine, y)


def sum_aux_over(group, f_sum, p_sum, n, mean_grads: bool = False):
    """The load-balance statistics (pick counts and gate mass (E,) each,
    valid-token count) summed over `group` in one all-reduce, so every
    rank holds the global loss. Its backward is the identity when the
    engine SUMS the ranks' gradients (each rank then differentiates the
    global loss's share of its own tokens), and an all-reduce (SUM) when
    it averages them (`mean_grads`), which the average undoes."""
    if group is None or dist.get_world_size(group) == 1:
        return f_sum, p_sum, n
    e = f_sum.numel()
    flat = torch.cat([f_sum, p_sum, n.reshape(1).to(p_sum.dtype)])
    flat = (_AllReduceSum.apply(flat, group) if mean_grads
            else reduce_from_model_parallel(flat, group))
    return flat[:e], flat[e:2 * e], flat[2 * e]


@dataclasses.dataclass(frozen=True)
class GlobalAux:
    """The policy of the global-batch engines (`DataParallelEngine`, the
    tensor-parallel engine): every expert runs here, dense, and the aux
    statistics are summed over `group` (the reference's GSPMD computes
    them over the global batch); the engine averages the gradients."""

    group: Any

    def __call__(self, h, dispatch, combine, w):
        return dense_experts(h, dispatch, combine, w)

    def reduce_aux(self, f_sum, p_sum, n):
        return sum_aux_over(self.group, f_sum, p_sum, n, mean_grads=True)


@dataclasses.dataclass(frozen=True)
class ExpertDispatch:
    """The policy of `ExpertParallelEngine(dispatch="hierarchical")` over
    `mesh`'s data fabric: the rank holds its E/S expert block at rest
    (`w`), the exchange runs over the mesh's ici and dcn groups, and the
    aux statistics are summed over the data group."""

    mesh: Any
    overlap: bool = False
    # Cross-slice wire ("none" | "bf16" | "int8"); needs MeshSpec(dcn=K).
    dcn_compression: str = "none"

    def __post_init__(self):
        require_dcn_axis(self.dcn_compression, self.mesh.dcn_group,
                         what="MoE exchange")

    def __call__(self, h, dispatch, combine, w):
        s = self.mesh.data
        _check_experts(dispatch.shape[2], s)
        if w["w_in"].shape[0] * s != dispatch.shape[2]:
            raise ValueError(
                f"hierarchical dispatch: an expert block of "
                f"{w['w_in'].shape[0]} for {dispatch.shape[2]} experts over "
                f"{s} ranks")
        return _moe_local(h, dispatch, combine, w,
                          ici=self.mesh.ici_group, dcn=self.mesh.dcn_group,
                          overlap=self.overlap, wire=self.dcn_compression)

    def reduce_aux(self, f_sum, p_sum, n):
        return sum_aux_over(self.mesh.group, f_sum, p_sum, n)


@dataclasses.dataclass(frozen=True)
class LocalExpertDispatch:
    """The DDP engines' policy: whole weights on every rank, each slicing
    its E/S block by fabric index (dcn_index * I + ici_index); the
    slice's backward scatters the block gradient into the full leaf."""

    ici_group: Any
    dcn_group: Optional[Any] = None
    overlap: bool = False
    dcn_compression: str = "none"

    def __post_init__(self):
        require_dcn_axis(self.dcn_compression, self.dcn_group,
                         what="MoE exchange")

    def __call__(self, h, dispatch, combine, w):
        n_i = _size(self.ici_group)
        s = n_i * _size(self.dcn_group)
        el = _check_experts(w["w_in"].shape[0], s)
        idx = _index(self.dcn_group) * n_i + _index(self.ici_group)
        w_loc = {k: v[idx * el:(idx + 1) * el] for k, v in w.items()}
        return _moe_local(h, dispatch, combine, w_loc, ici=self.ici_group,
                          dcn=self.dcn_group, overlap=self.overlap,
                          wire=self.dcn_compression)


__all__ = ["ExpertDispatch", "GlobalAux", "LocalExpertDispatch",
           "a2a_chunks",
           "combine_exchange", "dispatch_exchange", "exchange_permutes",
           "exchanged_expert_ffn", "flat_expert_exchange",
           "flat_expert_return", "overlapped_expert_ffn", "sum_aux_over"]
