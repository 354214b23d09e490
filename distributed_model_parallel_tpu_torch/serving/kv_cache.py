"""Preallocated KV caches (port of `serving/kv_cache.py`).

Two granularities share this module:

* **Contiguous slots** (`KVCacheSpec`): one dense tree `{k, v: (layers,
  slots, max_len, heads, head_dim), lengths: (slots,)}`: every admitted
  sequence owns a `max_len` stripe.
* **Paged pool** (`PagedKVCacheSpec`): one device pool `{k, v: (layers,
  num_pages + 1, page_size, heads, head_dim)}` reached through a
  host-side block table per slot (`PagedCacheHost`). Allocation is
  page-granular (`PagePool`), so the bytes a run pins follow its live
  tokens, and pages are refcounted so the prefix cache (`PrefixCache`)
  can share immutable prompt pages between slots; a write into a shared
  page copies it first (copy-on-write).

The pool's last page (index `num_pages`) is a SINK that no block table
names: the port writes the pool in place, and a write the reference's
drop-mode scatter discards (an inactive slot, an unallocated `-1`
entry, a position past the table) lands there instead, so no masked
write ever needs a device-to-host sync to be filtered out. Gathers
never read it.

Within a slot, axes follow the (B, T, H, Dh) attention convention, so
the cache feeds `dot_product_attention` without transposes.

Layouts (`validate(layout, mesh)`, with the reference's checks and
messages). Each rank allocates its own part (`local`), the shape the
reference's `cache_pspecs` / `paged_pspecs` give each device:

  replicated — the whole cache on every rank;
  tp — heads sharded over the mesh's model axis: (L, slots, max_len,
       H/M, Dh), or (L, pages + 1, page, H/M, Dh);
  sp — positions sharded over the seq axis: a contiguous rank holds
       positions [i max_len/S, (i+1) max_len/S) of every slot, (L,
       slots, max_len/S, H, Dh); a paged rank holds offsets [i page/S,
       (i+1) page/S) of EVERY page, (L, pages + 1, page/S, H, Dh), so
       the block tables stay global and their gathers local.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LAYOUTS = ("replicated", "tp", "sp")


def _check_layout(layout: str, mesh, heads: int, seq_dim: int,
                  seq_label: str, seq_reason: str) -> None:
    """The reference's layout checks shared by both specs: a mesh for tp
    / sp, heads % model for tp, `seq_dim` % seq for sp."""
    if layout not in LAYOUTS:
        raise ValueError(
            f"layout must be one of {LAYOUTS}, got {layout!r}"
        )
    if layout == "replicated":
        return
    if mesh is None:
        raise ValueError(f"layout {layout!r} needs a mesh")
    if layout == "tp" and heads % mesh.model:
        raise ValueError(
            f"tp cache shards heads over 'model': num_heads {heads} not "
            f"divisible by {mesh.model} shards"
        )
    if layout == "sp" and seq_dim % mesh.seq:
        raise ValueError(
            f"{seq_reason}: {seq_label} {seq_dim} not divisible by "
            f"{mesh.seq} shards"
        )


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static shape of the preallocated cache (one per ServingEngine)."""

    num_layers: int
    num_slots: int
    max_len: int
    num_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    def validate(self, layout: str, mesh=None) -> None:
        """Fail at construction when the cache cannot be laid out on the
        mesh (`runtime/mesh.Mesh`)."""
        _check_layout(layout, mesh, self.num_heads, self.max_len,
                      "max_len", "sp cache shards positions over 'seq'")

    def local(self, layout: str, mesh=None) -> "KVCacheSpec":
        """This rank's part of the cache under `layout` (module doc)."""
        if layout == "tp":
            return dataclasses.replace(
                self, num_heads=self.num_heads // mesh.model)
        if layout == "sp":
            return dataclasses.replace(self,
                                       max_len=self.max_len // mesh.seq)
        return self

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


# ----------------------------------------------------------- paged pool


@dataclasses.dataclass(frozen=True)
class PagedKVCacheSpec:
    """Static shape of the page pool (one per paged ServingEngine).
    `num_pages` bounds total live tokens at `num_pages * page_size`
    across ALL slots; the pool may be sized well under `num_slots *
    max_len` because allocation is page-granular."""

    num_layers: int
    num_slots: int
    max_len: int
    page_size: int
    num_pages: int
    num_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    @property
    def pages_per_slot(self) -> int:
        """Block-table width: pages covering one slot's max_len."""
        return -(-self.max_len // self.page_size)

    @property
    def page_bytes(self) -> int:
        """K AND V bytes one pool page pins across all layers."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (
            2 * self.num_layers * self.page_size * self.num_heads
            * self.head_dim * itemsize
        )

    def validate(self, layout: str, mesh=None) -> None:
        if layout not in LAYOUTS:
            raise ValueError(
                f"layout must be one of {LAYOUTS}, got {layout!r}"
            )
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}"
            )
        if self.max_len % self.page_size:
            raise ValueError(
                f"page_size {self.page_size} must divide max_len "
                f"{self.max_len} (the block table covers whole pages)"
            )
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold even one "
                f"full-length sequence ({self.pages_per_slot} pages "
                f"of {self.page_size})"
            )
        _check_layout(layout, mesh, self.num_heads, self.page_size,
                      "page_size", "sp shards each page's positions over "
                      "'seq'")

    def local(self, layout: str, mesh=None) -> "PagedKVCacheSpec":
        """This rank's part of the pool under `layout`: its heads (tp) or
        its offsets of every page (sp, `page_size` / S)."""
        if layout == "tp":
            return dataclasses.replace(
                self, num_heads=self.num_heads // mesh.model)
        if layout == "sp":
            return dataclasses.replace(
                self, page_size=self.page_size // mesh.seq)
        return self


def init_paged_cache(spec: PagedKVCacheSpec, device="cpu") -> dict:
    """Zero-filled page pool on `device`, plus the sink page (module
    docstring). Unlike the contiguous cache, `lengths` is not device
    state: the host loop owns every slot's position along with the
    block table, so positions ride in as a step argument."""
    kv_shape = (
        spec.num_layers, spec.num_pages + 1, spec.page_size,
        spec.num_heads, spec.head_dim,
    )
    return {
        "k": torch.zeros(kv_shape, dtype=spec.dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=spec.dtype, device=device),
    }


class PagePool:
    """Host-side page allocator with refcounts.

    Allocation takes the lowest free page (deterministic traces);
    `incref`/`decref` support prefix sharing: a page frees only when
    its LAST reference drops. `pages_in_use`/`kv_cache_bytes` are the
    accounting seam: paged allocation scales with live tokens, never
    with `slots * max_len`."""

    def __init__(self, num_pages: int, page_bytes: int = 0):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self.page_bytes = int(page_bytes)
        self._free: List[int] = list(range(num_pages))
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def kv_cache_bytes(self) -> int:
        return self.pages_in_use * self.page_bytes

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted: all {self.num_pages} KV pages "
                "are live — size the pool larger (--kv-pages) or admit "
                "fewer concurrent sequences"
            )
        page = min(self._free)
        self._free.remove(page)
        self._refs[page] = 1
        return page

    def incref(self, page: int) -> None:
        if page not in self._refs:
            raise ValueError(f"page {page} is not live")
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; True when the page was freed."""
        n = self._refs.get(page)
        if n is None:
            raise ValueError(f"page {page} is not live")
        if n > 1:
            self._refs[page] = n - 1
            return False
        del self._refs[page]
        self._free.append(page)
        return True


class PrefixCache:
    """Host-side map from token prefixes to immutable shared pool pages.

    Keys are CHAINED digests over the full token prefix (page j's key =
    blake2b(key_{j-1} || page j's int32 bytes)), so reuse requires an
    exact whole-prefix match and a lookup costs O(n). A prompt whose
    length is not page-aligned also registers a whole-prompt entry for
    its last PARTIAL page; a borrower of that page copies it before
    writing (copy-on-write, in `PagedCacheHost.ensure_writable`).

    Every cached entry holds one pool reference of its own, so pages
    outlive the slot that produced them; `release_unused` drops
    cache-only entries (refcount 1) in LRU order when the pool runs
    dry, each with the entries chained off it (unmatchable once their
    parent is gone)."""

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        # key -> page id, in LRU order (move_to_end on every match).
        self._map: "OrderedDict[bytes, int]" = OrderedDict()
        # key -> the keys chained directly off it.
        self._children: Dict[bytes, set] = {}
        self.hits = 0       # requests that reused >= 1 cached page
        self.misses = 0     # requests that matched nothing
        self.tokens_reused = 0

    def __len__(self) -> int:
        return len(self._map)

    @staticmethod
    def _chain(prev: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def _keys(self, prompt: np.ndarray) -> List[Tuple[bytes, int]]:
        """(key, tokens covered) per cacheable span of `prompt`, in
        prefix order: one per full page, then the whole-prompt partial
        entry when the length is not page-aligned."""
        ps = self.page_size
        key = b""
        out: List[Tuple[bytes, int]] = []
        for j in range(len(prompt) // ps):
            key = self._chain(key, prompt[j * ps:(j + 1) * ps])
            out.append((key, (j + 1) * ps))
        if len(prompt) % ps:
            out.append((
                self._chain(key, prompt[len(prompt) // ps * ps:]),
                len(prompt),
            ))
        return out

    def match(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached prefix of `prompt`: ([page ids], tokens
        covered). Matched pages are incref'd for the caller (the slot
        now shares them)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pages: List[int] = []
        covered = 0
        for key, n_tokens in self._keys(prompt):
            pid = self._map.get(key)
            if pid is None:
                break
            self._map.move_to_end(key)
            pages.append(pid)
            covered = n_tokens
        for pid in pages:
            self.pool.incref(pid)
        if pages:
            self.hits += 1
            self.tokens_reused += covered
        else:
            self.misses += 1
        return pages, covered

    def register(self, prompt: np.ndarray, page_ids: List[int]) -> None:
        """Publish a freshly ingested prompt's pages. Existing entries
        win (the first writer keeps ownership); each NEW entry takes its
        own pool reference."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        parent = b""
        for page_idx, (key, _n) in enumerate(self._keys(prompt)):
            if page_idx >= len(page_ids):
                break
            if key not in self._map:
                pid = page_ids[page_idx]
                self.pool.incref(pid)
                self._map[key] = pid
                self._map.move_to_end(key)
                self._children.setdefault(parent, set()).add(key)
            parent = key

    def _evict(self, key: bytes) -> int:
        """Drop one entry and its extension subtree; returns the pages
        actually freed (a page a live slot still borrows loses only the
        cache's reference)."""
        pid = self._map.pop(key, None)
        if pid is None:
            return 0
        freed = 1 if self.pool.decref(pid) else 0
        for child in self._children.pop(key, ()):
            freed += self._evict(child)
        return freed

    def release_unused(self, want: int) -> int:
        """Free up to `want` pages by dropping entries no slot
        references (pool refcount 1), in LRU order; returns the pages
        freed."""
        freed = 0
        for key in list(self._map):
            if freed >= want:
                break
            if key not in self._map:
                continue  # already gone with an evicted ancestor
            if self.pool.refcount(self._map[key]) == 1:
                freed += self._evict(key)
        return freed

    @property
    def evictable(self) -> int:
        """Pages only the cache still references (admission headroom)."""
        return sum(
            1 for pid in self._map.values()
            if self.pool.refcount(pid) == 1
        )


@torch.no_grad()
def copy_page(cache: dict, src: int, dst: int) -> dict:
    """Duplicate pool page `src` into `dst` across every layer of both
    K and V, in place (the copy-on-write copy)."""
    for buf in cache.values():
        buf[:, dst] = buf[:, src]
    return cache


class PagedCacheHost:
    """Host half of the paged cache: the block tables, page-granular
    alloc/free, prefix sharing and copy-on-write. Owns every invariant
    the engine's paged steps assume:

    * a slot's write position is always backed by an allocated page
      (`ensure_writable` before each decode/verify write);
    * a write page is always PRIVATE: a shared page (prefix cache, or a
      borrowed partial page) is copied first, so distinct live slots
      never write the same pool page, and the slot that still reads a
      shared page sees its bytes unchanged;
    * a freed slot returns pages, not a max_len stripe (`release`), and
      shared pages survive through their remaining references.
    """

    def __init__(self, spec: PagedKVCacheSpec, *,
                 prefix_cache: bool = False, copy_fn=None,
                 device="cpu"):
        self.spec = spec
        self.device = torch.device(device)
        self.pool = PagePool(spec.num_pages, spec.page_bytes)
        self.block_tables = np.full(
            (spec.num_slots, spec.pages_per_slot), -1, np.int32
        )
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.pool, spec.page_size)
            if prefix_cache else None
        )
        self._copy = copy_fn
        self.cow_copies = 0
        self.pages_in_use_peak = 0
        # Worst-case page commitment per admitted slot (`reserve`):
        # admission headroom is judged against every admitted but not
        # yet allocated page, so a sequence, once admitted, always
        # completes.
        self._commit: Dict[int, int] = {}
        # Device copy of block_tables, rebuilt when a write below
        # invalidates it (admission, page boundaries, COW).
        self._dev_table: Optional[torch.Tensor] = None

    # ------------------------------------------------------ bookkeeping

    def device_table(self) -> torch.Tensor:
        """The block tables (slots, pages_per_slot) int64 on the
        engine's device."""
        if self._dev_table is None:
            self._dev_table = torch.from_numpy(
                self.block_tables.astype(np.int64)).to(self.device)
        return self._dev_table

    def device_row(self, slot: int) -> torch.Tensor:
        """One slot's block-table row (the per-slot prefill steps)."""
        return self.device_table()[slot]

    def _note_peak(self) -> None:
        self.pages_in_use_peak = max(
            self.pages_in_use_peak, self.pool.pages_in_use
        )

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.spec.page_size)

    def _outstanding(self) -> int:
        """Pages promised to admitted slots but not yet allocated: each
        slot's commitment minus the PRIVATE pages it holds (a shared
        entry still counts as owed: a write into it copies)."""
        total = 0
        for slot, commit in self._commit.items():
            private = sum(
                1 for pid in self.block_tables[slot]
                if pid >= 0 and self.pool.refcount(int(pid)) == 1
            )
            total += max(0, commit - private)
        return total

    def can_hold(self, n_tokens: int) -> bool:
        """Admission headroom: enough free (or cache-evictable) pages
        for a whole `n_tokens` sequence after honoring every admitted
        slot's outstanding commitment."""
        headroom = self.pool.free_pages + (
            self.prefix.evictable if self.prefix else 0
        ) - self._outstanding()
        return headroom >= self._pages_for(n_tokens)

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Commit the slot's worst-case page need (at admission, with
        the token count `can_hold` approved)."""
        self._commit[slot] = self._pages_for(n_tokens)

    def _alloc_page(self) -> int:
        try:
            page = self.pool.alloc()
        except RuntimeError:
            if self.prefix is None or not self.prefix.release_unused(1):
                raise
            page = self.pool.alloc()
        self._note_peak()
        return page

    # ------------------------------------------------------- lifecycle

    def ensure_pages(self, slot: int, n_tokens: int) -> None:
        """Allocate so the slot's pages cover positions [0, n_tokens)
        (prefix-matched entries are already in place and kept)."""
        for j in range(self._pages_for(n_tokens)):
            if self.block_tables[slot, j] < 0:
                self.block_tables[slot, j] = self._alloc_page()
                self._dev_table = None

    def ensure_writable(self, cache: dict, slot: int,
                        position: int) -> dict:
        """Back `position` with a PRIVATE page before a device write:
        allocate if unmapped, copy-on-write if shared. Returns the
        cache (written in place)."""
        j = position // self.spec.page_size
        pid = int(self.block_tables[slot, j])
        if pid < 0:
            self.block_tables[slot, j] = self._alloc_page()
            self._dev_table = None
            return cache
        if self.pool.refcount(pid) > 1:
            fresh = self._alloc_page()
            cache = self._copy(cache, pid, fresh)
            self.pool.decref(pid)
            self.block_tables[slot, j] = fresh
            self._dev_table = None
            self.cow_copies += 1
        return cache

    def attach_prefix(self, slot: int, prompt) -> int:
        """Install the longest cached prefix into the slot's block
        table; returns tokens covered (0 when the cache is off or
        missed)."""
        if self.prefix is None:
            return 0
        pages, covered = self.prefix.match(prompt)
        for j, pid in enumerate(pages):
            self.block_tables[slot, j] = pid
        if pages:
            self._dev_table = None
        self._note_peak()
        return covered

    def register_prefix(self, slot: int, prompt) -> None:
        if self.prefix is None:
            return
        n = self._pages_for(len(np.asarray(prompt).reshape(-1)))
        ids = [int(p) for p in self.block_tables[slot, :n]]
        if all(p >= 0 for p in ids):
            self.prefix.register(prompt, ids)

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Roll a slot back to its first `n_tokens` positions: pages
        wholly beyond the kept span return to the pool (shared pages
        just drop this slot's reference). The speculative rollback: a
        rejected draft suffix is a block-table edit, never a KV copy;
        stale K/V inside the kept final page stays masked by the slot's
        position until overwritten."""
        keep = self._pages_for(n_tokens)
        for j in range(keep, self.spec.pages_per_slot):
            pid = int(self.block_tables[slot, j])
            if pid >= 0:
                self.pool.decref(pid)
                self.block_tables[slot, j] = -1
                self._dev_table = None

    def release(self, slot: int) -> None:
        """Recycle a slot: its pages return to the pool (minus surviving
        shared references) and its commitment clears."""
        for pid in self.block_tables[slot]:
            if pid >= 0:
                self.pool.decref(int(pid))
        self.block_tables[slot] = -1
        self._dev_table = None
        self._commit.pop(slot, None)


__all__ = [
    "KVCacheSpec",
    "LAYOUTS",
    "PagePool",
    "PagedCacheHost",
    "PagedKVCacheSpec",
    "PrefixCache",
    "SlotAllocator",
    "copy_page",
    "init_cache",
    "init_paged_cache",
]
