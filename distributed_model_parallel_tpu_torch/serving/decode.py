"""Incremental (KV-cached) decode and prefill through the
`attention_fn(q, k, v, mask)` seam (port of the contiguous parts of
`serving/decode.py`).

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

Unlike the reference, which rebuilds the cache functionally
(`.at[i].set`, `dynamic_update_slice`), the port writes the cache
tensors IN PLACE: the same values land at the same positions, without
a second copy of a multi-hundred-megabyte cache per step.
"""

from __future__ import annotations

from typing import List

import torch

from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)


def decode_stem(stem_params, tokens, positions):
    """One-token stem: word embedding of each slot's incoming token plus
    ITS OWN position row (a ragged decode batch). tokens/positions
    (slots,) -> h (slots, 1, dim)."""
    h = stem_params["word"][tokens] + stem_params["position"][positions]
    return h[:, None, :]


def prefill_stem(stem_params, ids):
    """Prompt stem over (B, T) ids at positions [0, T)."""
    return stem_params["word"][ids] \
        + stem_params["position"][: ids.shape[1]][None]


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


__all__ = [
    "CacheAttention",
    "PrefillRecorder",
    "decode_stem",
    "prefill_stem",
    "write_position",
]
