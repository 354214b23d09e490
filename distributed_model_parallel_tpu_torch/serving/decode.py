"""Incremental (KV-cached) decode and prefill through the
`attention_fn(q, k, v, mask)` seam (port of `serving/decode.py`).

The decoder blocks are not rewritten for inference: each step hands the
blocks a fresh recorder as their attention core, and each block's one
call becomes one layer's cache update + attention.

  * decode (`CacheAttention`): the block hands over the NEW token's
    q/k/v (slots, 1, H, Dh); the recorder writes k/v into layer i of the
    cache at each slot's own position (a ragged batch), then attends q
    against the cached prefix with `dot_product_attention` and a
    per-slot key-validity mask — the core the dense model runs, so
    logits match full recompute.
  * sp decode (`SeqShardedCacheAttention`, `PagedSeqShardedCacheAttention`):
    the cache's positions are sharded over the seq group; each rank
    writes the new K/V only where it owns the position, attends q over
    its own positions, and the partial softmaxes merge exactly by the
    online recurrence (`_sp_online_softmax_attend`: an all-reduce MAX of
    the running max, then one SUM of the exp-sums and weighted values).
  * prefill (`PrefillRecorder`): wraps causal attention (dense, or the
    slice-13 ring over the seq group under sp) and captures each layer's
    K/V for the cache write.
  * paged twins (`PagedCacheAttention`, `PagedChunkAttention`,
    `PagedVerifyAttention`): K/V live in a page pool reached through a
    block table; each recorder gathers the slot's pages into the same
    position-ordered view the contiguous cache stores directly, writes
    the new rows into that view and into the pool, and attends over the
    view, so the logits are those of the contiguous path.

Unlike the reference, which rebuilds the cache functionally
(`.at[i].set`, `dynamic_update_slice`, drop-mode scatters), the port
writes the cache tensors IN PLACE: the same values land at the same
positions, without a second copy of a multi-hundred-megabyte cache per
step. A pool write the reference's scatter would drop (an inactive
slot, an unallocated `-1` entry, a row past the block table) goes to
the pool's sink page (`serving/kv_cache.py`), which no gather reads.

Decode-time tp projections can ride the latency-hiding rings
(`DecodeCollectiveMatmul`): at decode the sequence axis is one token,
so `ops/collective_matmul`'s rings run over the SLOT batch instead. The
residual stream between blocks holds this rank's slots, column
projections gather every slot's rows round the model group's ring (S -
1 hops), row projections reduce-scatter the partial sums back to the
slots' owners, and the cache attention between them runs on every slot
and this rank's heads, exactly as without the rings: 4 L (S - 1) hops a
decode step (`decode_ring_permutes`), and as many a verify step, whose
k + 1 tokens a slot ride the same rings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.ops.collective_matmul import (
    ag_matmul,
    ag_matmul_quant,
    matmul_rs,
    matmul_rs_quant,
)
from distributed_model_parallel_tpu_torch.ops.quant_matmul import (
    PreparedWeights,
    quant_dot,
)


def _cast(h, dtype):
    return h if dtype is None else h.to(dtype)


def decode_stem(stem_params, tokens, positions, dtype=None):
    """One-token stem: word embedding of each slot's incoming token plus
    ITS OWN position row (a ragged decode batch), cast to the activation
    `dtype` (None keeps f32). tokens/positions (slots,) -> h (slots, 1,
    dim)."""
    h = stem_params["word"][tokens] + stem_params["position"][positions]
    return _cast(h[:, None, :], dtype)


def prefill_stem(stem_params, ids, dtype=None, offset: int = 0):
    """Prompt stem over (B, T) ids at positions [offset, offset + T) (0
    for the dense layouts; the rank's global offset under the sp
    layout)."""
    pos = stem_params["position"][offset:offset + ids.shape[1]]
    return _cast(stem_params["word"][ids] + pos[None], dtype)


def chunk_stem(stem_params, ids, start: int, dtype=None):
    """Chunked-prefill stem: (1, T) ids embedded at global positions
    start + [0, T) with per-token position gathers, clipped to the table
    (padding rows past the chunk's valid length may index beyond it;
    their outputs are discarded)."""
    table = stem_params["position"]
    pos = (start + torch.arange(ids.shape[1], device=ids.device)).clamp(
        0, table.shape[0] - 1)
    return _cast(stem_params["word"][ids] + table[pos][None], dtype)


def verify_stem(stem_params, tokens, positions, dtype=None):
    """Speculative verify stem: each slot's (T,) token span embedded at
    ITS OWN positions `positions[s] + [0, T)` (clipped per token like
    `chunk_stem`). tokens (slots, T), positions (slots,) -> h (slots, T,
    dim)."""
    table = stem_params["position"]
    t = tokens.shape[1]
    pos = (positions[:, None]
           + torch.arange(t, device=tokens.device)[None, :]).clamp(
        0, table.shape[0] - 1)
    return _cast(stem_params["word"][tokens] + table[pos], dtype)


def write_position(cache_layer, new, positions, active) -> None:
    """Write each ACTIVE slot's (1, H, Dh) update at its own position,
    in place; inactive slots keep their old row (admission gaps must not
    smear garbage into recycled slots). cache_layer (slots, max_len, H,
    Dh), new (slots, 1, H, Dh), positions (slots,), active (slots,).

    Inactive slots rewrite their current row, so the write needs no
    host-side selection of the active slots (no device sync); positions
    clamp to the cache like the reference's dynamic_update_slice."""
    slots = torch.arange(cache_layer.shape[0], device=cache_layer.device)
    pos = positions.clamp(0, cache_layer.shape[1] - 1)
    cache_layer[slots, pos] = torch.where(
        active[:, None, None], new[:, 0].to(cache_layer.dtype),
        cache_layer[slots, pos],
    )


class CacheAttention:
    """attention_fn for one decode step.

    Construct per step over the cache tensors; each block's call
    consumes the next layer index in order (blocks apply sequentially,
    so call order IS layer order) and updates that layer in place."""

    def __init__(self, k, v, positions, active):
        self.k = k  # (layers, slots, max_len, H, Dh)
        self.v = v
        self.positions = positions  # (slots,) write/attend position
        self.active = active  # (slots,) bool
        self.layer = 0
        # Keys at the slot's position or earlier are the live prefix
        # (the new token is written AT the position); later positions
        # are zero padding or a recycled slot's stale tail.
        self.valid = (
            torch.arange(k.shape[2], device=k.device)[None, :]
            <= positions[:, None]
        )

    def __call__(self, q, k_new, v_new, mask):
        i = self.layer
        self.layer += 1
        kc, vc = self.k[i], self.v[i]
        write_position(kc, k_new, self.positions, self.active)
        write_position(vc, v_new, self.positions, self.active)
        return dot_product_attention(q, kc, vc, mask=self.valid)


def _group_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _sp_online_softmax_attend(q, kc, vc, valid, group):
    """The exact cross-rank attention merge both sp decode recorders
    share: each rank scores q against ITS keys under `valid` (slots,
    local keys), then the partial softmaxes combine by the online
    recurrence in f32: an all-reduce MAX of the running max, and one SUM
    of the exp-sums and the weighted values together (the reference's two
    psums, packed in one all-reduce: the same elementwise sums)."""
    dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh)))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kc.float()) * scale.to(q.device)
    neg = torch.finfo(torch.float32).min
    vmask = valid[:, None, None, :]
    logits = torch.where(vmask, logits, neg)
    m = logits.amax(dim=-1).contiguous()  # (slots, H, 1)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.where(vmask, torch.exp(logits - m[..., None]), 0.0)
    denom = p.sum(dim=-1)  # (slots, H, 1)
    num = torch.einsum("bhqk,bkhd->bqhd", p, vc.float())  # (slots,1,H,Dh)
    if group is not None:
        packed = torch.cat([denom.reshape(-1), num.reshape(-1)])
        dist.all_reduce(packed, group=group)
        denom = packed[:denom.numel()].view(denom.shape)
        num = packed[denom.numel():].view(num.shape)
    out = num / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype)


class SeqShardedCacheAttention:
    """attention_fn for one decode step under the sp layout: the cache's
    position axis is sharded over `group`, this rank holding positions
    [i C, (i+1) C) of every slot in its local cache (layers, slots, C, H,
    Dh). The rank writes the new K/V only where it owns the slot's
    position, attends q over its positions, and the partial softmaxes
    merge exactly (`_sp_online_softmax_attend`)."""

    def __init__(self, k, v, positions, active, *, group=None):
        self.k = k
        self.v = v
        self.positions = positions
        self.group = group
        self.layer = 0
        chunk = k.shape[2]
        start = _group_index(group) * chunk
        local = positions - start
        self.local = local.clamp(0, chunk - 1)
        self.owns = (local >= 0) & (local < chunk) & active
        # Every global position <= the slot's lives on exactly one rank,
        # so the union over ranks is the dense prefix mask.
        gpos = start + torch.arange(chunk, device=k.device)
        self.valid = gpos[None, :] <= positions[:, None]  # (slots, C)

    def __call__(self, q, k_new, v_new, mask):
        i = self.layer
        self.layer += 1
        kc, vc = self.k[i], self.v[i]
        write_position(kc, k_new, self.local, self.owns)
        write_position(vc, v_new, self.local, self.owns)
        return _sp_online_softmax_attend(q, kc, vc, self.valid, self.group)


class PrefillRecorder:
    """attention_fn wrapper for the prefill pass: runs `core` unchanged
    and captures each layer's K/V for the cache write."""

    def __init__(self, core):
        self.core = core
        self.ks: List[torch.Tensor] = []
        self.vs: List[torch.Tensor] = []

    def __call__(self, q, k, v, mask):
        self.ks.append(k)
        self.vs.append(v)
        return self.core(q, k, v, mask)


# ------------------------------------------------- paged attention fns


def _gather_pages(pool_layer, block_table):
    """(num_pages + 1, page, H, Dh) x (slots, P) -> position-ordered
    view (slots, P*page, H, Dh), a fresh tensor. Unallocated entries
    (-1) gather page 0, as the reference's clipped gather does; their
    positions lie beyond every slot's live length, so the validity
    masks keep them invisible."""
    pages = pool_layer[block_table.clamp(min=0)]  # (slots, P, page, H, Dh)
    s, p, page, h, dh = pages.shape
    return pages.reshape(s, p * page, h, dh)


def _pool_rows(block_table, positions, ok, page_size: int, sink: int):
    """(page ids, in-page offsets) of global `positions` (slots, n)
    through `block_table` (slots, P): rows that are not `ok`, fall past
    the table or hit an unallocated entry go to the sink page."""
    j = torch.div(positions, page_size, rounding_mode="floor")
    inside = j < block_table.shape[1]
    dst = block_table.gather(1, j.clamp(max=block_table.shape[1] - 1))
    keep = ok & inside & (dst >= 0)
    return torch.where(keep, dst, sink), positions % page_size


def _write_pool(pool_layer, rows, new) -> None:
    """pool_layer[page, offset] = new, in place; new (n, H, Dh)."""
    pages, offsets = rows
    pool_layer[pages.reshape(-1), offsets.reshape(-1)] = new.to(
        pool_layer.dtype)


class PagedCacheAttention:
    """attention_fn for one PAGED decode step: gather the slots' pages
    through the block table, write the new token at each slot's own
    position (the view and the pool), attend over the view with the
    same per-slot validity mask as `CacheAttention`."""

    def __init__(self, k, v, block_table, positions, active,
                 page_size: int):
        self.k = k  # (layers, num_pages + 1, page, H, Dh)
        self.v = v
        self.bt = block_table  # (slots, pages_per_slot) int64
        self.positions = positions  # (slots,) write/attend position
        self.active = active  # (slots,) bool
        self.rows = _pool_rows(block_table, positions[:, None],
                               active[:, None], page_size, k.shape[1] - 1)
        self.valid = (
            torch.arange(block_table.shape[1] * page_size,
                         device=k.device)[None, :]
            <= positions[:, None]
        )
        self.layer = 0

    def __call__(self, q, k_new, v_new, mask):
        i = self.layer
        self.layer += 1
        views = []
        for pool, new in ((self.k[i], k_new), (self.v[i], v_new)):
            view = _gather_pages(pool, self.bt)
            write_position(view, new, self.positions, self.active)
            _write_pool(pool, self.rows, new[:, 0])
            views.append(view)
        return dot_product_attention(q, *views, mask=self.valid)


class PagedSeqShardedCacheAttention:
    """attention_fn for one PAGED decode step under the sp layout: each
    PAGE's positions are sharded over `group`, this rank holding offsets
    [i psub, (i+1) psub) of every page in its local pool (layers,
    num_pages + 1, psub, H, Dh), psub = page / S. The rank writes the new
    K/V only where it owns the slot's within-page offset, and the
    partial softmaxes merge exactly (`_sp_online_softmax_attend`): the
    paged twin of `SeqShardedCacheAttention`."""

    def __init__(self, k, v, block_table, positions, active,
                 page_size: int, *, group=None):
        self.k = k
        self.v = v
        self.bt = block_table
        self.group = group
        self.layer = 0
        psub = k.shape[2]  # page / S offsets a rank
        idx = _group_index(group)
        off = positions % page_size
        self.owns = (torch.div(off, psub, rounding_mode="floor") == idx) \
            & active
        # The local flat index of global position p in the gathered view.
        self.local = (torch.div(positions, page_size, rounding_mode="floor")
                      * psub + off % psub)
        self.rows = _pool_rows(block_table, self.local[:, None],
                               self.owns[:, None], psub, k.shape[1] - 1)
        f = torch.arange(block_table.shape[1] * psub, device=k.device)
        gpos = (torch.div(f, psub, rounding_mode="floor") * page_size
                + idx * psub + f % psub)
        self.valid = gpos[None, :] <= positions[:, None]  # (slots, view)

    def __call__(self, q, k_new, v_new, mask):
        i = self.layer
        self.layer += 1
        views = []
        for pool, new in ((self.k[i], k_new), (self.v[i], v_new)):
            view = _gather_pages(pool, self.bt)
            write_position(view, new, self.local, self.owns)
            _write_pool(pool, self.rows, new[:, 0])
            views.append(view)
        return _sp_online_softmax_attend(q, *views, self.valid, self.group)


class PagedChunkAttention:
    """attention_fn for ONE chunked-prefill step of ONE slot: the
    chunk's queries (positions [start, start + T)) attend causally over
    the slot's cached prefix plus the chunk itself, and the chunk's K/V
    lands in the slot's pages.

    Chunk PADDING beyond the valid length also lands (in the view, and
    in the pool where its page is allocated), as in the reference:
    padding positions are overwritten by the next chunk or the first
    decode write, or sit beyond the slot's length and stay masked.
    Ingestion resumes at or after a prefix-cache match's page boundary,
    on freshly allocated pages, so a chunk never writes a shared
    page."""

    def __init__(self, k, v, bt_row, start: int, page_size: int):
        self.k = k
        self.v = v
        self.bt = bt_row[None]  # (1, pages_per_slot)
        self.start = int(start)
        self.page = page_size
        self.rows = self.valid = None  # the chunk's, at the first call
        self.layer = 0

    def __call__(self, q, k_new, v_new, mask):
        i = self.layer
        self.layer += 1
        chunk = k_new.shape[1]
        view_len = self.bt.shape[1] * self.page
        if self.rows is None:
            pos = self.start + torch.arange(chunk, device=q.device)
            self.rows = _pool_rows(
                self.bt, pos[None], torch.ones_like(pos[None], dtype=bool),
                self.page, self.k.shape[1] - 1)
            # Causal across the prefix boundary: the query at global
            # position start + t sees every cached position <= start + t.
            self.valid = (torch.arange(view_len, device=q.device)[None, :]
                          <= pos[:, None])[None, None]  # (1, 1, T, view)
        hi = min(self.start + chunk, view_len)
        views = []
        for pool, new in ((self.k[i], k_new), (self.v[i], v_new)):
            view = _gather_pages(pool, self.bt)
            view[0, self.start:hi] = new[0, :hi - self.start].to(view.dtype)
            _write_pool(pool, self.rows, new[0])
            views.append(view)
        return dot_product_attention(q, *views, mask=self.valid)


class PagedVerifyAttention:
    """attention_fn for ONE speculative VERIFY step over the whole slot
    batch: every slot's T-token span (its last token plus the k draft
    proposals) attends causally over the slot's cached prefix plus the
    span itself, each slot at its own start position.

    The span lands in the cache BEFORE acceptance is known: rejected
    suffix tokens are rolled back host-side by truncating the block
    table (`PagedCacheHost.truncate`); pages are freed, never copied,
    and stale K/V inside the kept tail stays masked by the slot's
    position like any recycled slot's."""

    def __init__(self, k, v, block_table, positions, active,
                 page_size: int):
        self.k = k  # (layers, num_pages + 1, page, H, Dh)
        self.v = v
        self.bt = block_table  # (slots, pages_per_slot) int64
        self.positions = positions  # (slots,) span START position
        self.active = active  # (slots,) bool
        self.page = page_size
        self.qpos = self.rows = None  # the spans', at the first call
        self.layer = 0

    def _write_span(self, view, new):
        """view (slots, view, H, Dh) <- new (slots, T, H, Dh) at
        [pos_s, pos_s + T) per slot, a select over the whole view (no
        duplicate indices near the end of the view); inactive slots keep
        their view."""
        t = new.shape[1]
        g = torch.arange(view.shape[1], device=view.device)[None, :]
        rel = g - self.positions[:, None]  # (slots, view)
        c = rel.clamp(0, t - 1)
        cand = new.to(view.dtype).gather(
            1, c[:, :, None, None].expand(-1, -1, *view.shape[2:]))
        inside = (rel >= 0) & (rel < t) & self.active[:, None]
        return torch.where(inside[:, :, None, None], cand, view)

    def __call__(self, q, k_new, v_new, mask):
        i = self.layer
        self.layer += 1
        s, t = k_new.shape[:2]
        if self.rows is None:
            self.qpos = self.positions[:, None] + torch.arange(
                t, device=q.device)[None, :]  # (slots, T)
            self.rows = _pool_rows(self.bt, self.qpos,
                                   self.active[:, None].expand(s, t),
                                   self.page, self.k.shape[1] - 1)
        qpos = self.qpos
        views = []
        for pool, new in ((self.k[i], k_new), (self.v[i], v_new)):
            view = self._write_span(_gather_pages(pool, self.bt), new)
            _write_pool(pool, self.rows, new.reshape(s * t, *new.shape[2:]))
            views.append(view)
        # Row j of slot s sits at pos_s + j and sees every cached
        # position <= pos_s + j: accepted rows reproduce plain decode's
        # logits position for position. Each row attends in its own
        # call, with the decode step's shapes: the batched (slots, T)
        # product is another GEMM shape, which the card's libraries sum
        # in another order, and greedy acceptance compares argmaxes that
        # such rounding flips at near-ties.
        g = torch.arange(views[0].shape[1], device=q.device)[None, :]
        return torch.cat([
            dot_product_attention(q[:, j:j + 1], *views,
                                  mask=g <= qpos[:, j:j + 1])
            for j in range(t)], dim=1)


# ---------------------------------------- decode-time collective matmul


@dataclasses.dataclass
class DecodeCollectiveMatmul:
    """Latency-hiding policy for tp DECODE and VERIFY steps
    (`Context.matmul` -> `layers.project`): the projections ride
    `ops/collective_matmul`'s rings over the SLOT batch of the model
    group `group` (module doc). Column projections (qkv, ffn-in) take
    this rank's slots (slots/S, T, D), gather every slot's rows through
    the `ag_matmul` ring and return (slots, T, F/S); row projections
    (attn-out, ffn-out) take (slots, T, F/S) and reduce-scatter the
    partial sums back onto this rank's slots, (slots/S, T, D). The
    flattened slots * T rows ring as one batch: T is 1 for a decode step
    and k + 1 for a verify step, the same hops either way.

    `compute_dtype` ("bf16" | "int8" | None) injects the chunk GEMM
    (`ops/quant_matmul.quant_dot`): under int8 each chunk product is the
    int8 kernel (K4) on the chunk's rows against this rank's weight
    block, quantized once (`prepare`) with the block's OWN scales, as the
    reference's `matmul_rs_quant` does inside its shard_map; the hops
    carry the same activation chunks as the f32 rings. The engine checks
    that the slots, 3 dim, dim and ffn_dim divide by the group's size."""

    group: Any
    compute_dtype: Optional[str] = None
    _weights: PreparedWeights = dataclasses.field(
        default_factory=PreparedWeights, repr=False, compare=False)

    def prepare(self, w: torch.Tensor) -> None:
        """Quantize this rank's weight block `w` once (int8)."""
        if self.compute_dtype == "int8":
            self._weights.put(w)

    def _dot(self, w):
        return quant_dot(self.compute_dtype, self._weights.get(w))

    def column(self, h, w, b):
        """(slots/S, T, D) this rank's slots -> (slots, T, F/S)."""
        t = h.shape[1]
        h2 = h.reshape(-1, h.shape[-1])
        dot = self._dot(w)
        y = (ag_matmul(h2, w, self.group) if dot is None
             else ag_matmul_quant(h2, w, self.group, dot))
        return (y + b.to(y.dtype)).reshape(-1, t, y.shape[-1])

    def row(self, h, w, b):
        """(slots, T, F/S) -> (slots/S, T, D), this rank's slots."""
        t = h.shape[1]
        h2 = h.reshape(-1, h.shape[-1])
        dot = self._dot(w)
        y = (matmul_rs(h2, w, self.group) if dot is None
             else matmul_rs_quant(h2, w, self.group, dot))
        return (y + b.to(y.dtype)).reshape(-1, t, y.shape[-1])


def decode_ring_permutes(num_layers: int, size: int) -> int:
    """The hops of one decode (or verify) step on the rings: 4 projection
    rings a block (qkv, attn-out, ffn-in, ffn-out), S - 1 hops each."""
    return 4 * num_layers * (size - 1)


__all__ = [
    "CacheAttention",
    "DecodeCollectiveMatmul",
    "PagedCacheAttention",
    "PagedChunkAttention",
    "PagedSeqShardedCacheAttention",
    "PagedVerifyAttention",
    "PrefillRecorder",
    "SeqShardedCacheAttention",
    "chunk_stem",
    "decode_ring_permutes",
    "decode_stem",
    "prefill_stem",
    "verify_stem",
    "write_position",
]
