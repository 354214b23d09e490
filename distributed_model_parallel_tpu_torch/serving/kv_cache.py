"""Preallocated contiguous KV cache (port of the contiguous-slot parts of
`serving/kv_cache.py`).

One dense tree `{k, v: (layers, slots, max_len, heads, head_dim),
lengths: (slots,)}`: every admitted sequence owns a `max_len` stripe.
Within a slot, axes follow the (B, T, H, Dh) attention convention, so
the cache feeds `dot_product_attention` without transposes. The block-
paged pool, and the tp/sp layouts, belong to later port slices.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

# The reference's layouts; only "replicated" is ported (the engine
# refuses tp/sp by name).
LAYOUTS = ("replicated", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static shape of the preallocated cache (one per ServingEngine)."""

    num_layers: int
    num_slots: int
    max_len: int
    num_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    def validate(self, layout: str) -> None:
        if layout not in LAYOUTS:
            raise ValueError(
                f"layout must be one of {LAYOUTS}, got {layout!r}"
            )

    @property
    def slot_stripe_bytes(self) -> int:
        """Bytes one live slot pins: K and V over every layer, max_len
        positions."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (
            2 * self.num_layers * self.max_len * self.num_heads
            * self.head_dim * itemsize
        )


def init_cache(spec: KVCacheSpec, device="cpu") -> dict:
    """Zero-filled cache tree on `device`."""
    kv_shape = (
        spec.num_layers, spec.num_slots, spec.max_len,
        spec.num_heads, spec.head_dim,
    )
    return {
        "k": torch.zeros(kv_shape, dtype=spec.dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=spec.dtype, device=device),
        "lengths": torch.zeros(
            (spec.num_slots,), dtype=torch.int64, device=device
        ),
    }


class SlotAllocator:
    """Host-side free-list over the cache's slot axis.

    Admission takes the lowest free slot (deterministic traces),
    eviction returns it; a recycled slot's stale K/V beyond the new
    request's positions stays masked by the per-slot length until
    overwritten. `kv_cache_bytes` charges each live slot a whole
    `max_len` stripe (`bytes_per_slot`)."""

    def __init__(self, num_slots: int, *, bytes_per_slot: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.bytes_per_slot = int(bytes_per_slot)
        self._free: List[int] = list(range(num_slots))
        self._live: set = set()

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_slots(self) -> int:
        return len(self._live)

    @property
    def kv_cache_bytes(self) -> int:
        return len(self._live) * self.bytes_per_slot

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"all {self.num_slots} cache slots are live; evict "
                "(finish) a sequence before admitting another"
            )
        slot = min(self._free)
        self._free.remove(slot)
        self._live.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not live")
        self._live.remove(slot)
        self._free.append(slot)


__all__ = ["KVCacheSpec", "LAYOUTS", "SlotAllocator", "init_cache"]
