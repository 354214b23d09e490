"""Incremental (KV-cached) decode and prefill through the
`attention_fn(q, k, v, mask)` seam (port of `serving/decode.py`,
replicated layout).

The decoder blocks are not rewritten for inference: each step hands the
blocks a fresh recorder as their attention core, and each block's one
call becomes one layer's cache update + attention.

  * decode (`CacheAttention`): the block hands over the NEW token's
    q/k/v (slots, 1, H, Dh); the recorder writes k/v into layer i of the
    cache at each slot's own position (a ragged batch), then attends q
    against the cached prefix with `dot_product_attention` and a
    per-slot key-validity mask — the core the dense model runs, so
    logits match full recompute.
  * prefill (`PrefillRecorder`): wraps causal dense attention and
    captures each layer's full-prompt K/V for the cache write.
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
The tp/sp recorders (`PagedSeqShardedCacheAttention`,
`DecodeCollectiveMatmul`) belong to the tp/sp serving slice.
"""

from __future__ import annotations

from typing import List

import torch

from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
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


def prefill_stem(stem_params, ids, dtype=None):
    """Prompt stem over (B, T) ids at positions [0, T)."""
    return _cast(stem_params["word"][ids]
                 + stem_params["position"][: ids.shape[1]][None], dtype)


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


__all__ = [
    "CacheAttention",
    "PagedCacheAttention",
    "PagedChunkAttention",
    "PagedVerifyAttention",
    "PrefillRecorder",
    "chunk_stem",
    "decode_stem",
    "prefill_stem",
    "verify_stem",
    "write_position",
]
