"""Sequence/context parallelism: ring, Ulysses and ring-flash attention
over `torch.distributed` (port of `ops/ring_attention.py`).

Each op is an `attention_fn` for the transformer layers, called on this
rank's sequence shard: q, k, v (B, T/N, H, Dh) and an optional (B, T/N)
key-validity mask, with `group` the sequence group of N ranks (the
mesh's `seq_group`, `runtime/mesh.py`; rank i of the group holds global
positions [i T/N, (i+1) T/N)). `group=None` is one shard, where the rings
have no hop and the all-to-alls are the identity. Each returns the local
queries' attention over the GLOBAL keys.

* `ring_attention`: K/V travel the ring in f32 on
  purpose (their cotangents come back the same way and must not pick up
  n-1 bf16 roundings), and each rank runs the reference's online softmax
  over the blocks in f32: its own block first (the causal triangle on
  it), then block r, the one that started r ranks back. Under causal a
  block from a later rank is hidden and skipped; the rotation always
  runs. The hops are one `autograd.Function` (`_RingGather`: the n
  blocks stacked) whose backward sends the blocks' gradients back round
  the ring, accumulating in f32, on every rank: a hidden block's
  gradient is a zero that still travels, so rank 0, which uses no hop
  under causal, issues the same sends as the others (autograd would skip
  a per-hop node whose output never reaches the loss, and its peer would
  wait). The softmax itself is differentiated by autograd, as the
  reference's is by `jax.grad`.
* `ulysses_attention`: one tiled all-to-all of the stacked (q, k, v)
  re-shards (B, T/N, H, Dh) to (B, T, H/N, Dh); `attention_impl` (dense
  by default, the flash kernels for `ulysses_flash`) runs on the whole
  sequence with the all-gathered mask; a second all-to-all shards the
  output back. Each all-to-all is an `autograd.Function` whose backward
  is the inverse all-to-all; stacking q, k and v gives one collective in
  one fixed order forward and backward. Needs H % N == 0.
* `ring_flash_attention`: the ring with the flash kernels
  (`flash_forward_lse` / `flash_backward`: K1, K2, K3) as the per-hop
  core where `kernel_viable` takes the block lengths, and the dense pair
  math otherwise; the hops merge by log-sum-exp (`_merge_hop`), and the
  reference's custom VJP is `_RingFlash`: its backward re-rotates K/V,
  runs each visible pair's backward under the GLOBAL LSE, rotates f32
  dk/dv accumulators with their blocks, and one last hop delivers them
  home. K and V travel stacked as one tensor in the input dtype, and the
  hop that brings block r + 1 is started before block r's kernels run,
  so the transfer overlaps them (on NCCL, whose sends and receives run
  on their own stream); the dk/dv accumulators travel stacked as one f32
  tensor. Rank s of a causal ring runs K1 s + 1 times a call, and K2 and
  K3 s + 1 times each in the backward.

A hop is `ops/wire_codec._ppermute` (batched isend / irecv); on a gloo
group a CUDA tensor is staged through the host, as gloo carries none.
The rings take every block's key mask from one all-gather of the
group's masks instead of sending it round the ring.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.analysis.record import scope
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.ops.flash_attention import (
    flash_backward,
    flash_forward_lse,
    kernel_viable,
)
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    _ppermute_start,
    host_staged,
)

_NEG = torch.finfo(torch.float32).min


def _shards(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _shard_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _hop_start(x: torch.Tensor, group, back: bool = False):
    """Starts sending x one rank along the ring (rank i -> i + 1), or
    back along it; returns the function that waits and gives the block
    received."""
    n = dist.get_world_size(group)
    perm = tuple(((i + 1) % n, i) if back else (i, (i + 1) % n)
                 for i in range(n))
    with scope("kv_ring"):
        return _ppermute_start(x.contiguous(), group, perm)


def _hop(x: torch.Tensor, group, back: bool = False) -> torch.Tensor:
    """x sent one rank along the ring, or back along it."""
    return _hop_start(x, group, back)()


def _all_to_all(x: torch.Tensor, group, split: int,
                concat: int) -> torch.Tensor:
    """The reference's tiled `lax.all_to_all`: `x` cut into N pieces
    along `split`, piece j sent to rank j, and the pieces received from
    ranks 0..N-1 concatenated along `concat`."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    host = host_staged(send, group)
    if host:
        send = send.cpu()
    recv = torch.empty_like(send)
    with scope("ulysses"):
        dist.all_to_all_single(recv, send, group=group)
    if host:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat)


def _all_gather_seq(mask: torch.Tensor, group) -> torch.Tensor:
    """The (B, T/N) masks of the group concatenated along the sequence
    (the reference's tiled `lax.all_gather`)."""
    n = dist.get_world_size(group)
    m = mask.to(torch.uint8).contiguous()
    if host_staged(m, group):
        m = m.cpu()
    out = m.new_empty((n * m.shape[0], m.shape[1]))
    with scope("kv_ring"):
        dist.all_gather_into_tensor(out, m, group=group)
    out = out.view(n, *m.shape)
    return torch.cat(out.unbind(0), dim=1).to(mask.device).bool()


def _mask_blocks(mask: torch.Tensor, group) -> list:
    """The ring's key masks on this rank: entry r is the (B, T/N) mask of
    the block that started r ranks back, cut from one all-gather."""
    n, s_idx, t = _shards(group), _shard_index(group), mask.shape[1]
    full = _all_gather_seq(mask, group)
    return [full[:, src * t:(src + 1) * t].contiguous()
            for src in ((s_idx - r) % n for r in range(n))]


class _RingGather(torch.autograd.Function):
    """The n blocks of the ring on this rank, stacked: block r is the one
    that started r ranks back (r hops). The backward returns each block's
    gradient to its owner by n - 1 hops back round the ring, adding in
    the stacked gradient's dtype (f32 for the K/V wire)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        blocks = [x]
        for _ in range(dist.get_world_size(group) - 1):
            blocks.append(_hop(blocks[-1], group))
        return torch.stack(blocks)

    @staticmethod
    def backward(ctx, g):
        acc = g[-1]
        for r in range(g.shape[0] - 2, -1, -1):
            acc = _hop(acc, ctx.group, back=True) + g[r]
        return acc, None


class _AllToAll(torch.autograd.Function):
    """A differentiable tiled all-to-all; its backward is the inverse
    all-to-all of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, split: int, concat: int):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.concat, ctx.split), None,
                None, None)


def _visible(src: int, s_idx: int, causal: bool) -> bool:
    """Whether block `src` is seen by rank `s_idx`'s queries: under
    causal, only blocks of earlier ranks (the resident one is the
    triangle)."""
    return not causal or src < s_idx


def ring_attention(q, k, v, mask=None, *, group=None,
                   scale: Optional[float] = None, causal: bool = False):
    """Exact attention over the ring of `group`'s sequence shards (module
    docstring): the reference's online softmax in f32, q scaled before
    the dot, the resident block first, then one block a hop."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, tq, h, dh = q.shape
    n, s_idx = _shards(group), _shard_index(group)
    qf = q.float() * scale
    if mask is None:
        m_blocks = [torch.ones(k.shape[:2], dtype=torch.bool,
                               device=k.device)] * n
    else:
        m_blocks = [mask] if n == 1 else _mask_blocks(mask, group)
    if n == 1:
        k_blocks, v_blocks = [k.float()], [v.float()]
    else:
        kv = _RingGather.apply(torch.cat([k.float(), v.float()], -1), group)
        k_blocks, v_blocks = kv.split(dh, dim=-1)

    def logits_of(kb, mb, tri=None):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        logits = logits.masked_fill(~mb[:, None, None, :], _NEG)
        if tri is not None:
            logits = logits.masked_fill(~tri[None, None], _NEG)
        return logits

    tri = None
    if causal:
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(k.shape[1], device=q.device)[None, :])
    # The resident block from the running (finfo.min, 0, 0) state.
    logits = logits_of(k_blocks[0], m_blocks[0], tri)
    m = torch.maximum(torch.full((b, h, tq), _NEG, device=q.device),
                      logits.amax(dim=-1))
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)  # the running l and o start at 0
    o = torch.einsum("bhqk,bkhd->bqhd", p, v_blocks[0])
    for r in range(1, n):
        if not _visible((s_idx - r) % n, s_idx, causal):
            continue  # hidden: its einsums are skipped, its hop is not
        logits = logits_of(k_blocks[r], m_blocks[r])
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v_blocks[r]))
        m = m_new
    denom = torch.where(l > 0, l, torch.ones_like(l))
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, mask=None, *, group=None,
                      scale: Optional[float] = None, causal: bool = False,
                      attention_impl=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): heads
    scattered, the whole sequence attended locally by `attention_impl`
    (dense `dot_product_attention` by default; the flash kernels for the
    `ulysses_flash` entry), and the output sharded back."""
    impl = attention_impl or dot_product_attention
    n = _shards(group)
    if n == 1:
        return impl(q, k, v, mask, scale=scale, causal=causal)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by 'seq' axis size ({n})")
    # (3, B, T/N, H, Dh) -> (3, B, T, H/N, Dh): one collective for all three
    qh, kh, vh = _AllToAll.apply(torch.stack([q, k, v]), group, -2,
                                 -3).unbind(0)
    full_mask = None if mask is None else _all_gather_seq(mask, group)
    out = impl(qh, kh, vh, full_mask, scale=scale, causal=causal)
    return _AllToAll.apply(out, group, -3, -2)


# ------------------------------------------------ ring x flash composition


def _dense_pair_fwd(q, k, v, maskb, scale, causal):
    """One block pair in plain torch: normalized f32 output and the LSE
    (B, H, Tq), -inf for rows the block gives nothing."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if maskb is not None:
        s = s.masked_fill(~maskb[:, None, None, :], _NEG)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~tri[None, None], _NEG)
    m = s.amax(dim=-1)
    p = torch.where(s == _NEG, torch.zeros_like(s), torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = o / safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(safe),
                      torch.full_like(l, -math.inf))
    return o, lse


def _dense_pair_bwd(q, k, v, maskb, out, lse, g, scale, causal):
    """Backward twin of `_dense_pair_fwd` under the given LSE."""
    qf, kf, vf = q.float(), k.float(), v.float()
    gf, of = g.float(), out.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    if maskb is not None:
        s = s.masked_fill(~maskb[:, None, None, :], _NEG)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~tri[None, None], _NEG)
    p = torch.exp(s - lse[..., None])  # +inf lse -> 0
    delta = (gf * of).sum(dim=-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq, dk, dv


def _pair_fwd(q, k, v, maskb, scale, causal):
    """(o f32, lse (B, H, Tq) with -inf for empty rows): the flash
    kernels where the lengths tile, dense math otherwise."""
    if not kernel_viable(q.shape[1], k.shape[1]):
        return _dense_pair_fwd(q, k, v, maskb, scale, causal)
    out, lse = flash_forward_lse(q, k, v, maskb, scale=scale, causal=causal)
    # kernel sentinel: +inf for empty rows; the hop merge wants -inf
    return out.float(), torch.where(torch.isposinf(lse),
                                    torch.full_like(lse, -math.inf), lse)


def _pair_bwd(q, k, v, maskb, out, lse, g, scale, causal):
    """(dq, dk, dv) of one block pair under the external LSE ((B, H, Tq),
    +inf for empty rows)."""
    if not kernel_viable(q.shape[1], k.shape[1]):
        return _dense_pair_bwd(q, k, v, maskb, out, lse, g, scale, causal)
    return flash_backward(q, k, v, maskb, out, lse, g, scale=scale,
                          causal=causal)


def _merge_hop(o_acc, lse_acc, o_b, lse_b):
    """Log-sum-exp merge of two NORMALIZED partial attentions."""
    lse_new = torch.logaddexp(lse_acc, lse_b)
    zero = torch.zeros_like(lse_new)
    # -inf - -inf = nan guard: empty-so-far rows have weight 0
    w_acc = torch.where(torch.isneginf(lse_acc), zero,
                        torch.exp(lse_acc - lse_new))
    w_b = torch.where(torch.isneginf(lse_b), zero, torch.exp(lse_b - lse_new))
    return (o_acc * w_acc.transpose(1, 2)[..., None]
            + o_b * w_b.transpose(1, 2)[..., None]), lse_new


class _RingFlash(torch.autograd.Function):
    """The reference's `_ring_flash` custom VJP (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, scale: float, causal: bool):
        n, s_idx = _shards(group), _shard_index(group)
        masks = ([mask] * n if mask is None or n == 1
                 else _mask_blocks(mask, group))
        # The first hop starts, then the local block runs (triangular
        # under causality); each later hop starts before its
        # predecessor's block runs.
        pending = _hop_start(torch.stack([k, v]), group) if n > 1 else None
        o_acc, lse_acc = _pair_fwd(q, k, v, mask, scale, causal)
        for r in range(1, n):
            kv = pending()
            if r < n - 1:
                pending = _hop_start(kv, group)
            if _visible((s_idx - r) % n, s_idx, causal):
                o_b, lse_b = _pair_fwd(q, kv[0], kv[1], masks[r], scale,
                                       False)
                o_acc, lse_acc = _merge_hop(o_acc, lse_acc, o_b, lse_b)
        out = o_acc.to(q.dtype)
        # backward sentinel: rows nothing contributed to carry +inf
        lse = torch.where(torch.isneginf(lse_acc),
                          torch.full_like(lse_acc, math.inf), lse_acc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks, ctx.group = masks, group
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        masks, group, scale, causal = (ctx.masks, ctx.group, ctx.scale,
                                       ctx.causal)
        n, s_idx = _shards(group), _shard_index(group)
        pending = _hop_start(torch.stack([k, v]), group) if n > 1 else None
        # dq accumulates here; dk / dv accumulate in one stacked f32
        # buffer that rotates with its block and one last hop delivers
        # home.
        dq, dk, dv = (t.float() for t in _pair_bwd(
            q, k, v, masks[0], out, lse, g, scale, causal))
        dkv = torch.stack([dk, dv])
        for r in range(1, n):
            kv = pending()
            if r < n - 1:
                pending = _hop_start(kv, group)
            dkv = _hop(dkv, group)
            if _visible((s_idx - r) % n, s_idx, causal):
                dq_c, dk_b, dv_b = _pair_bwd(q, kv[0], kv[1], masks[r], out,
                                             lse, g, scale, False)
                dq = dq + dq_c.float()
                dkv = dkv + torch.stack([dk_b.float(), dv_b.float()])
        if n > 1:
            dkv = _hop(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_flash_attention(q, k, v, mask=None, *, group=None,
                         scale: Optional[float] = None, causal: bool = False):
    """The ring with the flash kernels as its per-hop core (module
    docstring): per-rank attention memory O(T/N), exact by the LSE
    merge."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingFlash.apply(q, k, v, mask, group, scale, causal)


__all__ = ["ring_attention", "ring_flash_attention", "ulysses_attention"]
