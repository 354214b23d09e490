"""ServingEngine: prefill/decode split with continuous batching over the
contiguous or the block-paged KV cache (port of `serving/engine.py`).

One decode step advances EVERY cache slot one token, whatever position
each slot sits at (the mixed-position batch of continuous batching).
The host loop (`run`) admits waiting requests into free slots
(prefill), runs one decode step for the active set, and evicts finished
sequences.

Two cache layouts, logit-identical:

  contiguous (page_size None) — every slot owns a `max_len` stripe;
      `prefill` / `decode_step`.
  paged (page_size set) — K/V in a page pool reached through host block
      tables (`serving/kv_cache.PagedCacheHost`); `paged_prefill_step`,
      `chunk_prefill_step` (prefill_chunk: prompts ingested a chunk per
      iteration beside the decode step), `paged_decode_step`,
      `paged_verify_step` (speculative_k: the target scores k+1
      positions per slot in one step, `serving/speculative.py`), and
      the prefix cache (prefix_cache: shared prompt pages with
      copy-on-write).

Parameters are the dense `models/gpt.py` tree, the reference's `gpt_lm`
tree carried over by `models/convert.py`. `compute_dtype`:

  f32  — everything f32.
  bf16 — activations and cache in bf16, every block projection a
         `torch.matmul` of bf16 operands (the reference's bf16 path is a
         plain XLA dot); LayerNorm and attention compute in f32 and
         round back, the vocabulary head is f32.
  int8 — the decode and verify steps thread the `QuantMatmul` policy
         into the blocks, so each decoder block's four projections run
         the int8 GEMM kernel (`csrc/int8_matmul.cu` on the GPU);
         prefill (monolithic and chunked) and the head stay f32, and
         activations and cache stay f32, exactly as in the reference.

Each weight is quantized (int8) or cast (bf16) once, in `place_params`.

Layouts, each logit-identical to the replicated one at the reference's
bars; under tp and sp every rank of the mesh (`runtime/mesh.Mesh`, one
process a card) runs the same host loop (`run`) on the same next-token
logits, so admission, sampling and eviction stay in lockstep, and the
caller reports from rank 0:

  replicated — parameters and cache whole on every rank.
  tp — the parameters' Megatron shards over the mesh's model group
       (`parallel/tensor_parallel.MEGATRON_RULES`, split by
       `place_params` from the dense tree), the cache's heads sharded
       (`serving/kv_cache.py`). Without rings the blocks run Megatron's
       f / g (`layers.project` over `Context.model_group`), and int8 is
       `QuantMatmul` over the group (whole-row scales, as the
       reference's partitioner computes them); with `collective_matmul`
       the decode and verify steps' projections ride the rings over the
       slot batch (`serving/decode.DecodeCollectiveMatmul`), the
       residual stream holding this rank's slots and the logits
       all-gathered at the end. Prefill runs f / g in both.
  sp — parameters whole, the cache's positions sharded over the seq
       group: prefill splits the prompt over the group and runs the
       slice-13 ring (`ops/ring_attention.ring_attention`, causal), the
       next-token logits are the owning rank's row (an all-reduce of it
       and zeros), and each rank keeps its positions of the all-gathered
       prompt K/V; decode merges the ranks' partial attention exactly
       (`SeqShardedCacheAttention`, `PagedSeqShardedCacheAttention`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.gpt import (
    GPTConfig,
    decoder_blocks,
    head_apply,
    init_params,
)
from distributed_model_parallel_tpu_torch.observability.metrics import (
    get_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (
    get_tracer,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.ops.quant_matmul import (
    QuantMatmul,
    normalize_compute_dtype,
    prepare_weight,
)
from distributed_model_parallel_tpu_torch.ops.ring_attention import (
    ring_attention,
)
from distributed_model_parallel_tpu_torch.ops.wire_codec import host_staged
from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
    MEGATRON_RULES,
    Split,
    check_divisibility,
    shard_leaf,
    shard_specs,
    shard_tree,
)
from distributed_model_parallel_tpu_torch.serving.decode import (
    CacheAttention,
    DecodeCollectiveMatmul,
    PagedCacheAttention,
    PagedChunkAttention,
    PagedSeqShardedCacheAttention,
    PagedVerifyAttention,
    PrefillRecorder,
    SeqShardedCacheAttention,
    chunk_stem,
    decode_stem,
    prefill_stem,
    verify_stem,
)
from distributed_model_parallel_tpu_torch.serving.kv_cache import (
    KVCacheSpec,
    PagedCacheHost,
    PagedKVCacheSpec,
    copy_page,
    init_cache,
    init_paged_cache,
)
from distributed_model_parallel_tpu_torch.serving.sampling import (
    SamplingConfig,
    SlotSampler,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import (
    Request,
    Scheduler,
)

# The row-parallel (Split(0)) projections: their int8 weight codes and
# scales under tp without rings are the whole weight's, sliced.
_ROW_PROJECTIONS = (("attn", "out"), ("ffn", "out"))


def _to_device(array: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(array).astype(dtype)).to(device)


def _all_gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """The group's x concatenated along dim 0, in rank order (on a gloo
    group a CUDA tensor crosses through the host)."""
    n = dist.get_world_size(group)
    src = x.cpu() if host_staged(x, group) else x.contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device)


@dataclasses.dataclass
class ServingEngine:
    """Autoregressive serving over `models/gpt` configs (module doc)."""

    cfg: GPTConfig
    mesh: Any = None
    layout: str = "replicated"
    num_slots: int = 4
    max_len: Optional[int] = None  # cache positions; <= cfg.max_position
    prefill_len: Optional[int] = None  # padded prompt length; <= max_len
    collective_matmul: bool = False
    # "f32" (default), "bf16" or "int8", or a dtype object (module doc).
    compute_dtype: Any = None
    # Paged pool: positions per page (None = contiguous slots), pool
    # size in pages (None = num_slots * ceil(max_len / page_size)).
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    # Chunked prefill: tokens ingested per engine iteration (None =
    # monolithic prefill). Requires page_size.
    prefill_chunk: Optional[int] = None
    # Prefix caching of prompt pages. Requires page_size and
    # prefill_chunk.
    prefix_cache: bool = False
    # Draft tokens per speculative round (0 = off); requires page_size,
    # and `run` takes the draft engine and its params.
    speculative_k: int = 0
    # Where parameters, cache and compute live: the GPU unless the
    # caller asks for the CPU (the tests do).
    device: Any = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine(device='cuda'): no CUDA device is "
                "available; pass device='cpu' to serve on the CPU"
            )
        self.max_len = self.max_len or cfg.max_position
        self.prefill_len = self.prefill_len or self.max_len
        if self.max_len > cfg.max_position:
            raise ValueError(
                f"max_len {self.max_len} exceeds the position table "
                f"(cfg.max_position={cfg.max_position})"
            )
        if not 1 <= self.prefill_len <= self.max_len:
            raise ValueError(
                f"prefill_len {self.prefill_len} must be in "
                f"[1, max_len={self.max_len}]"
            )
        if cfg.dim % cfg.num_heads:
            raise ValueError(
                f"dim {cfg.dim} not divisible by heads {cfg.num_heads}"
            )
        self.compute_mode = normalize_compute_dtype(self.compute_dtype)
        # Activation and cache dtype. int8 keeps both f32: quantization
        # lives inside the projection GEMMs, never at rest.
        self._act_dtype = (
            torch.bfloat16 if self.compute_mode == "bf16" else None
        )
        if self.compute_mode == "int8" and self.layout == "sp":
            raise ValueError(
                "compute_dtype='int8' quantizes the decode projections "
                "(replicated/tp layouts); the sp layout's shard_map "
                "decode has no quantized policy path"
            )
        cache_dtype = self._act_dtype or torch.float32
        head_dim = cfg.dim // cfg.num_heads
        self.spec = KVCacheSpec(
            num_layers=cfg.num_layers, num_slots=self.num_slots,
            max_len=self.max_len, num_heads=cfg.num_heads,
            head_dim=head_dim, dtype=cache_dtype,
        )
        self.spec.validate(self.layout, self.mesh)
        self.paged_spec = None
        if self.page_size is None:
            for flag, name in ((self.prefill_chunk, "prefill_chunk"),
                               (self.num_pages, "num_pages")):
                if flag is not None:
                    raise ValueError(
                        f"{name} configures the paged KV layout; set "
                        "page_size as well (None = contiguous slots)"
                    )
            if self.prefix_cache:
                raise ValueError(
                    "prefix_cache shares POOL PAGES between slots; it "
                    "requires page_size (the contiguous layout has no "
                    "sharable unit)"
                )
        else:
            pages_per_slot = -(-self.max_len // self.page_size)
            self.paged_spec = PagedKVCacheSpec(
                num_layers=cfg.num_layers, num_slots=self.num_slots,
                max_len=self.max_len, page_size=self.page_size,
                num_pages=(
                    self.num_pages if self.num_pages is not None
                    else self.num_slots * pages_per_slot
                ),
                num_heads=cfg.num_heads, head_dim=head_dim,
                dtype=cache_dtype,
            )
            self.paged_spec.validate(self.layout, self.mesh)
            if self.prefill_chunk is not None:
                if self.prefill_chunk < 1:
                    raise ValueError(
                        f"prefill_chunk must be >= 1, got "
                        f"{self.prefill_chunk}"
                    )
                if self.layout == "sp":
                    raise ValueError(
                        "prefill_chunk is not supported under the sp "
                        "layout: sp prefill rides the training ring over "
                        "'seq' in one pass (use monolithic prefill, or "
                        "the replicated/tp layouts)"
                    )
            if self.prefix_cache:
                if self.layout == "sp":
                    raise ValueError(
                        "prefix_cache is not supported under the sp "
                        "layout (shared pages would need coherent "
                        "copy-on-write across 'seq' shards)"
                    )
                if self.prefill_chunk is None:
                    raise ValueError(
                        "prefix_cache needs chunked prefill "
                        "(prefill_chunk): a partial prefix hit resumes "
                        "ingestion mid-prompt, which only the chunked "
                        "path can do"
                    )
        if self.speculative_k:
            if not 1 <= self.speculative_k <= 8:
                raise ValueError(
                    f"speculative_k must be in [1, 8], got "
                    f"{self.speculative_k} (the verify step scores k+1 "
                    "positions; past ~8 the acceptance tail pays for "
                    "nothing)"
                )
            if self.layout == "sp":
                raise ValueError(
                    "speculative_k is not supported under the sp layout: "
                    "the verify step is a chunk-shaped batched write the "
                    "'seq'-sharded shard_map decode has no path for (same "
                    "refusal shape as sp+int8) — use the replicated/tp "
                    "layouts"
                )
            if self.page_size is None:
                raise ValueError(
                    "speculative_k rolls rejected draft tokens back by "
                    "TRUNCATING THE BLOCK TABLE (freeing pages, never "
                    "copying KV); it requires the paged layout — set "
                    "page_size"
                )
            if self.speculative_k + 1 >= self.max_len:
                raise ValueError(
                    f"speculative_k {self.speculative_k} leaves no room: "
                    f"a verify round writes k+1 positions into a "
                    f"max_len={self.max_len} cache"
                )
        if self.collective_matmul and self.layout != "tp":
            raise ValueError(
                "collective_matmul=True rings decode projections over the "
                "'model' axis; it requires layout='tp' "
                f"(got {self.layout!r})"
            )
        # This rank's axis of the layout: the model group under tp, the
        # seq group under sp (None: one rank, every collective skipped).
        self._group, self._shards, self._index = None, 1, 0
        self._mm = None
        if self.layout == "tp":
            s = self.mesh.model
            self._group, self._shards = self.mesh.model_group, s
            self._index = self.mesh.model_index
            if self.num_slots % s:
                raise ValueError(
                    f"tp layout shards the slot batch over 'model': "
                    f"num_slots {self.num_slots} not divisible by {s} "
                    "shards"
                )
            # The port's Megatron shards hold whole heads and FFN columns
            # (ROADMAP §C: heads % M).
            check_divisibility(cfg.num_heads, cfg.ffn_dim, s)
            if self.collective_matmul:
                if s < 2:
                    raise ValueError(
                        "collective_matmul=True needs a 'model' axis >= 2 "
                        "to ring over (a 1-shard ring is a plain dot)"
                    )
                for n, label in (
                    (self.num_slots, "num_slots"),
                    (3 * cfg.dim, "qkv width (3*dim)"),
                    (cfg.dim, "dim"),
                    (cfg.ffn_dim, "ffn_dim"),
                ):
                    if n % s:
                        raise ValueError(
                            f"decode collective_matmul: {label} ({n}) must "
                            f"be divisible by the {s}-way 'model' axis"
                        )
                self._mm = DecodeCollectiveMatmul(
                    group=self._group,
                    compute_dtype=(
                        "int8" if self.compute_mode == "int8" else None
                    ),
                )
        if self.layout == "sp":
            s = self.mesh.seq
            self._group, self._shards = self.mesh.seq_group, s
            self._index = self.mesh.seq_index
            if self.prefill_len % s:
                raise ValueError(
                    f"sp prefill shards the prompt over 'seq': "
                    f"prefill_len {self.prefill_len} not divisible by "
                    f"{s} shards"
                )
        # The decode/verify projection policy: the rings when built above;
        # otherwise, under int8, the non-ring quantized policy (over the
        # model group under tp). Prefill stays f32 (the decode hot floor
        # is the target).
        self._decode_mm = self._mm
        if self.compute_mode == "int8" and self._mm is None:
            self._decode_mm = QuantMatmul(
                group=self._group if self.layout == "tp" else None)
        model_group = self._group if self.layout == "tp" else None
        self._ctx = L.Context(train=False, dtype=self._act_dtype,
                              model_group=model_group)
        self._decode_ctx = dataclasses.replace(self._ctx,
                                               matmul=self._decode_mm)
        # The verify step's rows reduce as decode rows do (LayerNorm per
        # position here, attention and head per position in
        # `paged_verify_step`), so accepted rows are the decode steps'
        # logits bit for bit wherever the projections are row-exact
        # (int8; f32 and bf16 GEMMs round by shape on the card). Under
        # the rings a verify step's slots * (k + 1) rows ride the decode
        # step's rings: 4 L (S - 1) hops.
        self._verify_ctx = dataclasses.replace(self._decode_ctx,
                                               norm_per_position=True)

    # ------------------------------------------------------------ state

    def init_params(self, seed: int = 0) -> dict:
        """Fresh parameters from `seed` (`models/gpt.init_params`, the
        dense tree), placed into this engine's layout."""
        return self.place_params(
            init_params(self.cfg, seed, device=self.device)
        )

    def place_params(self, params) -> dict:
        """Place a dense `gpt_lm` parameter tree (a checkpoint, a
        training engine's canonical params) into this engine's layout on
        its device (f32): under tp, this rank's Megatron shards
        (`MEGATRON_RULES`, as `TensorParallelEngine` splits them), so a
        tree placed into tp equals one placed replicated and then split;
        replicated and sp keep it whole. Under int8, quantize every
        decode projection weight once (the weight scales are static: a
        whole column's for the column shards, the whole weight's, sliced,
        for the row shards without rings, the block's own under the
        rings); under bf16, cast every block projection's weight and bias
        to bf16 once (the cast the reference makes at each projection),
        leaving the embeddings, LayerNorms and head f32."""
        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            return tree.to(self.device, torch.float32)

        full = place(params)
        params = full
        if self.layout == "tp":
            params = shard_tree(full, shard_specs(full, MEGATRON_RULES),
                                self._index, self._shards)
        for key, block in params["blocks"].items():
            for group, names in (("attn", ("qkv", "out")),
                                 ("ffn", ("in", "out"))):
                for name in names:
                    lin = block[group][name]
                    if self._decode_mm is not None:
                        self._decode_mm.prepare(
                            lin["w"], *self._whole_weight_operands(
                                full["blocks"][key][group][name]["w"],
                                (group, name)))
                    if self._act_dtype is not None:
                        for k in ("w", "b"):
                            lin[k] = lin[k].to(self._act_dtype)
        return params

    def _whole_weight_operands(self, w_full, projection) -> tuple:
        """() for a weight quantized on its own; under tp without rings,
        a row projection's int8 operands are the WHOLE weight's codes and
        per-column scales, this rank's rows of them (the reference's
        partitioned quantization)."""
        if (self.layout != "tp" or self._mm is not None
                or projection not in _ROW_PROJECTIONS
                or self.compute_mode != "int8"):
            return ()
        wq_t, wscale = prepare_weight(w_full)  # (N, K): rows of w are K
        return ((shard_leaf(wq_t, Split(1), self._index,
                            self._shards).contiguous(), wscale),)

    def init_cache(self) -> dict:
        """This rank's part of the cache (`serving/kv_cache.py`)."""
        if self.paged_spec is not None:
            return init_paged_cache(
                self.paged_spec.local(self.layout, self.mesh), self.device)
        return init_cache(self.spec.local(self.layout, self.mesh),
                          self.device)

    def new_host(self) -> PagedCacheHost:
        """Fresh host half of the paged cache (block tables, page pool,
        prefix map); one per `run` or test harness."""
        if self.paged_spec is None:
            raise ValueError(
                "new_host() is the paged layout's bookkeeping; set "
                "page_size"
            )
        return PagedCacheHost(
            self.paged_spec, prefix_cache=self.prefix_cache,
            copy_fn=copy_page, device=self.device,
        )

    @property
    def _slot_stripe_bytes(self) -> int:
        """Contiguous-equivalent bytes one live slot would pin (the
        scheduler's SlotAllocator accounting seam)."""
        return self.spec.slot_stripe_bytes

    # ------------------------------------------------------------ steps

    def _prefill_pass(self, params, ids, length: int):
        """The padded prompt (1, prefill_len) through the blocks: (next
        logits (vocab,) f32, per-layer K and V stacks (L, prefill_len,
        H, Dh) of this rank's heads)."""
        if self.layout == "sp":
            return self._sp_prefill_pass(params, ids, length)
        mask = torch.arange(self.prefill_len,
                            device=self.device)[None, :] < length
        h = prefill_stem(params["stem"], ids, self._act_dtype)
        rec = PrefillRecorder(partial(dot_product_attention, causal=True))
        h, _ = decoder_blocks(params["blocks"], (h, mask), self.cfg,
                              self._ctx, rec)
        # Only the last real position's logits are read, so only that
        # row goes through the vocabulary head.
        next_logits = head_apply(params["head"], h[:, length - 1])[0]
        return (next_logits, torch.stack([k[0] for k in rec.ks]),
                torch.stack([v[0] for v in rec.vs]))

    def _sp_prefill_pass(self, params, ids, length: int):
        """`_prefill_pass` under sp: this rank runs its prefill_len / S
        prompt positions through the blocks over the causal ring; the
        next logits are the row of the rank that owns position length -
        1 (summed with the others' zeros over the group, so every rank
        holds them); the K/V stacks are all-gathered over the group."""
        tl = self.prefill_len // self._shards
        offset = self._index * tl
        gmask = (offset + torch.arange(tl, device=self.device))[None, :] \
            < length
        h = prefill_stem(params["stem"], ids[:, offset:offset + tl],
                         self._act_dtype, offset=offset)
        rec = PrefillRecorder(partial(ring_attention, group=self._group,
                                      causal=True))
        h, _ = decoder_blocks(params["blocks"], (h, gmask), self.cfg,
                              self._ctx, rec)
        if (length - 1) // tl == self._index:
            row = head_apply(params["head"], h[:, length - 1 - offset])[0]
        else:
            row = torch.zeros(self.cfg.vocab_size, device=self.device)
        row = row.contiguous()
        dist.all_reduce(row, group=self._group)
        return row, *(
            _all_gather_dim0(torch.stack([x[0] for x in xs]).transpose(
                0, 1), self._group).transpose(0, 1)
            for xs in (rec.ks, rec.vs))

    def _positions_held(self) -> slice:
        """The cache positions this rank holds of each slot."""
        if self.layout != "sp":
            return slice(0, self.max_len)
        chunk = self.max_len // self._shards
        return slice(self._index * chunk, (self._index + 1) * chunk)

    @torch.no_grad()
    def prefill(self, params, cache, ids, length: int, slot: int):
        """One padded prompt (1, prefill_len) of `length` real tokens
        into `slot` of the contiguous cache: writes the slot's stripe (its
        positions this rank holds) in place and returns (cache,
        next-token logits (vocab,) f32)."""
        next_logits, ks, vs = self._prefill_pass(params, ids, length)
        held = self._positions_held()
        for name, stack in (("k", ks), ("v", vs)):
            padded = stack.new_zeros((stack.shape[0], self.max_len,
                                      *stack.shape[2:]))
            padded[:, : stack.shape[1]] = stack
            cache[name][:, slot] = padded[:, held].to(cache[name].dtype)
        cache["lengths"][slot] = length
        return cache, next_logits

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, active):
        """One token for every slot of the contiguous cache, each at its
        own position: tokens (slots,) int64, active (slots,) bool on the
        device. Updates the cache in place and returns (cache, logits
        (slots, vocab) f32)."""
        positions = cache["lengths"]
        if self.layout == "sp":
            rec = SeqShardedCacheAttention(cache["k"], cache["v"],
                                           positions, active,
                                           group=self._group)
        else:
            rec = CacheAttention(cache["k"], cache["v"], positions, active)
        logits = self._decode_pass(params, rec, tokens, positions)
        cache["lengths"] = torch.where(active, positions + 1, positions)
        return cache, logits

    def _own_slots(self, h: torch.Tensor) -> torch.Tensor:
        """Under the rings, this rank's slots of h (slots, ...): the
        residual stream the ring projections take; else h."""
        if self._mm is None:
            return h
        n = h.shape[0] // self._shards
        return h[self._index * n:(self._index + 1) * n]

    def _every_slot(self, logits: torch.Tensor) -> torch.Tensor:
        """Under the rings, every rank's slots of logits gathered in slot
        order (each rank then holds the whole batch's); else logits."""
        if self._mm is None:
            return logits
        return _all_gather_dim0(logits, self._group)

    def _decode_pass(self, params, rec, tokens, positions):
        cfg = self.cfg
        h = self._own_slots(decode_stem(
            params["stem"], tokens, positions.clamp(0, cfg.max_position - 1),
            self._act_dtype))
        mask = torch.ones((self.num_slots, 1), dtype=torch.bool,
                          device=self.device)
        h, _ = decoder_blocks(params["blocks"], (h, mask), cfg,
                              self._decode_ctx, rec)
        return self._every_slot(head_apply(params["head"], h)[:, 0, :])

    @torch.no_grad()
    def paged_prefill_step(self, params, cache, bt_row, ids, length: int):
        """Monolithic prefill of one padded prompt into the pages of one
        slot's block-table row `bt_row` (pages_per_slot,): the padded
        K/V lands page by page (under sp, this rank's offsets of each
        page), unallocated entries write nothing. Returns (cache,
        next-token logits (vocab,) f32)."""
        next_logits, ks, vs = self._prefill_pass(params, ids, length)
        self._scatter_slot_pages(cache, ks, vs, bt_row)
        return cache, next_logits

    def _scatter_slot_pages(self, cache, ks, vs, bt_row) -> None:
        """(L, prefill_len, H, Dh) prompt K and V -> the slot's pool
        pages, in place; `-1` entries go to the sink page."""
        spec = self.paged_spec
        n_pages, page = spec.pages_per_slot, spec.page_size
        psub = cache["k"].shape[2]  # offsets of a page this rank holds
        start = self._index * psub if self.layout == "sp" else 0
        mine = slice(start, start + psub)
        dst = torch.where(bt_row >= 0, bt_row, spec.num_pages)
        for name, stack in (("k", ks), ("v", vs)):
            buf = cache[name]
            padded = stack.new_zeros(
                (stack.shape[0], n_pages * page, *stack.shape[2:]))
            padded[:, : stack.shape[1]] = stack
            buf[:, dst] = padded.reshape(
                stack.shape[0], n_pages, page, *stack.shape[2:]
            )[:, :, mine].to(buf.dtype)

    @torch.no_grad()
    def chunk_prefill_step(self, params, cache, bt_row, ids, start: int,
                           n_valid: int):
        """Ingest one chunk (1, prefill_chunk) of a prompt, `n_valid`
        real tokens at global positions [start, start + n_valid), into
        the slot's pages: the chunk attends over the cached prefix plus
        itself. Returns (cache, logits (vocab,) f32 of the chunk's last
        real token)."""
        rec = PagedChunkAttention(cache["k"], cache["v"], bt_row, start,
                                  self.paged_spec.page_size)
        h = chunk_stem(params["stem"], ids, start, self._act_dtype)
        mask = torch.arange(ids.shape[1],
                            device=self.device)[None, :] < n_valid
        h, _ = decoder_blocks(params["blocks"], (h, mask), self.cfg,
                              self._ctx, rec)
        return cache, head_apply(params["head"], h[:, n_valid - 1])[0]

    @torch.no_grad()
    def paged_decode_step(self, params, cache, bt, positions, tokens,
                          active):
        """One token for every slot of the paged cache: bt (slots,
        pages_per_slot), positions and tokens (slots,) int64, active
        (slots,) bool, all on the device. Writes the pool in place and
        returns (cache, logits (slots, vocab) f32)."""
        page = self.paged_spec.page_size
        if self.layout == "sp":
            rec = PagedSeqShardedCacheAttention(
                cache["k"], cache["v"], bt, positions, active, page,
                group=self._group)
        else:
            rec = PagedCacheAttention(cache["k"], cache["v"], bt, positions,
                                      active, page)
        return cache, self._decode_pass(params, rec, tokens, positions)

    @torch.no_grad()
    def paged_verify_step(self, params, cache, bt, positions,
                          tokens_chunk, active):
        """Speculative verify: every slot's (k+1)-token span
        `tokens_chunk` (slots, k+1) scored at positions pos..pos+k in one
        step, under the decode projection policy (one int8 GEMM launch a
        projection, M = slots * (k+1); under the rings, the decode step's
        rings with slots * (k+1) rows). Writes the spans into the pool
        and returns (cache, logits (slots, k+1, vocab) f32)."""
        rec = PagedVerifyAttention(cache["k"], cache["v"], bt, positions,
                                   active, self.paged_spec.page_size)
        h = self._own_slots(verify_stem(params["stem"], tokens_chunk,
                                        positions, self._act_dtype))
        mask = torch.ones(tokens_chunk.shape, dtype=torch.bool,
                          device=self.device)
        h, _ = decoder_blocks(params["blocks"], (h, mask), self.cfg,
                              self._verify_ctx, rec)
        # The head per position, at the decode step's (slots, 1, dim)
        # shape: rows equal to a decode step's (`PagedVerifyAttention`).
        return cache, self._every_slot(torch.cat([
            head_apply(params["head"], h[:, j:j + 1].contiguous())
            for j in range(h.shape[1])], dim=1))

    # ---------------------------------------------------------- serving

    def pad_prompt(self, prompt: np.ndarray):
        """(ids (1, prefill_len) int64 on the device, length) for one
        prompt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.size <= self.prefill_len:
            raise ValueError(
                f"prompt length {prompt.size} must be in "
                f"[1, prefill_len={self.prefill_len}]"
            )
        ids = np.zeros((1, self.prefill_len), np.int64)
        ids[0, : prompt.size] = prompt
        return torch.from_numpy(ids).to(self.device), int(prompt.size)

    def chunk_ids(self, prompt: np.ndarray, start: int):
        """(ids (1, prefill_chunk) int64 on the device, n_valid) of the
        chunk of `prompt` that starts at `start`."""
        n = min(self.prefill_chunk, int(prompt.size) - start)
        ids = np.zeros((1, self.prefill_chunk), np.int64)
        ids[0, :n] = prompt[start:start + n]
        return torch.from_numpy(ids).to(self.device), n

    def _pick(self, sampler: Optional[SlotSampler], logits_row,
              slot: int) -> int:
        """Next token id: greedy argmax or the per-slot sampling lane."""
        row = np.asarray(logits_row)
        if sampler is None:
            return int(row.argmax())
        return sampler.pick(row, slot)

    def _check_prompts(self, requests: Sequence[Request],
                       chunked: bool) -> None:
        # Chunked ingestion walks the prompt in place, so only the cache
        # (room for >= 1 generated token) caps prompt length.
        cap = (self.max_len - 1) if chunked else self.prefill_len
        for r in requests:
            if r.prompt.size > cap:
                raise ValueError(
                    f"request {r.rid!r}: prompt length {r.prompt.size} "
                    f"exceeds "
                    + (f"max_len - 1 = {cap}" if chunked
                       else f"prefill_len {cap}")
                )

    def run(self, params, requests: Sequence[Request],
            sampling: Optional[SamplingConfig] = None, *,
            draft: Optional["ServingEngine"] = None,
            draft_params=None) -> Scheduler:
        """Offline continuous batching: drive the request set to
        completion (greedy by default; a SamplingConfig samples with
        per-slot PRNG lanes) and return the Scheduler with its
        `finished` records and `latency_report()`. With `speculative_k`
        set, pass the draft engine and its params: the loop moves to
        `serving/speculative.run_speculative`."""
        sampler = (
            SlotSampler(sampling, self.num_slots)
            if sampling is not None and not sampling.greedy else None
        )
        if self.speculative_k:
            if draft is None or draft_params is None:
                raise ValueError(
                    "speculative_k > 0 needs a proposer: pass "
                    "run(..., draft=<draft ServingEngine>, "
                    "draft_params=<its params>)"
                )
            from distributed_model_parallel_tpu_torch.serving.speculative \
                import run_speculative

            return run_speculative(
                self, params, requests, sampler, draft, draft_params
            )
        if draft is not None or draft_params is not None:
            raise ValueError(
                "draft/draft_params drive speculative decoding; set "
                "speculative_k > 0 on the target engine as well"
            )
        if self.paged_spec is not None:
            return self._run_paged(params, requests, sampler)
        return self._run_contiguous(params, requests, sampler)

    def _run_contiguous(self, params, requests: Sequence[Request],
                        sampler: Optional[SlotSampler]) -> Scheduler:
        tracer = get_tracer()
        mx = get_metrics()
        sched = Scheduler(
            self.num_slots, self.max_len,
            bytes_per_slot=self._slot_stripe_bytes,
        )
        self._check_prompts(requests, chunked=False)
        for r in requests:
            sched.submit(r)
        cache = self.init_cache()
        tokens = np.zeros((self.num_slots,), np.int64)
        active = np.zeros((self.num_slots,), bool)
        while sched.has_work():
            # Admission: prefill waiting requests into free slots.
            while sched.can_admit():
                seq = sched.admit()
                ids, length = self.pad_prompt(seq.request.prompt)
                t0 = tracer.now()
                with tracer.span("prefill", rid=repr(seq.request.rid),
                                 slot=seq.slot):
                    cache, next_logits = self.prefill(
                        params, cache, ids, length, seq.slot
                    )
                    tok = self._pick(sampler, next_logits.cpu().numpy(),
                                     seq.slot)
                seq.t_first_token = tracer.now()
                # A monolithic prefill is one engine iteration in which
                # exactly ONE slot did useful work.
                sched.record_iteration(1)
                if mx.enabled:
                    mx.observe("serve_prefill_s", seq.t_first_token - t0)
                    mx.inc("serve_tokens_total", 1)
                seq.generated.append(tok)
                tokens[seq.slot] = tok
                active[seq.slot] = True
                if seq.done(self.max_len):
                    sched.finish(seq.slot)
                    active[seq.slot] = False
            if not active.any():
                continue
            # One decode step for the whole mixed-position batch; the
            # logits read is where the host waits for the device.
            n_active = int(active.sum())
            t0 = tracer.now()
            with tracer.span("decode_step", active=n_active):
                cache, logits = self.decode_step(
                    params, cache, torch.from_numpy(tokens).to(self.device),
                    torch.from_numpy(active).to(self.device),
                )
                logits_np = logits.cpu().numpy()
            dt = tracer.now() - t0
            sched.record_decode_step(n_active)
            sched.record_iteration(n_active)
            tracer.counter("batch_occupancy", n_active)
            if mx.enabled:
                mx.observe("serve_decode_step_s", dt)
            for slot, seq in list(sched.active.items()):
                tok = self._pick(sampler, logits_np[slot], slot)
                seq.generated.append(tok)
                seq.token_times.append(dt)
                tokens[slot] = tok
                if seq.done(self.max_len):
                    sched.finish(slot)
                    active[slot] = False
        return sched

    # ----------------------------------------------------- paged loop

    def step_inputs(self, positions, tokens, active):
        """Host (slots,) arrays -> the paged steps' device tensors."""
        return (_to_device(positions, np.int64, self.device),
                _to_device(tokens, np.int64, self.device),
                _to_device(active, bool, self.device))

    def paged_stats(self, host: PagedCacheHost) -> dict:
        return {
            "page_size": self.paged_spec.page_size,
            "num_pages": self.paged_spec.num_pages,
            "pages_in_use_peak": host.pages_in_use_peak,
            "kv_cache_bytes_peak": (
                host.pages_in_use_peak * self.paged_spec.page_bytes
            ),
            "contiguous_bytes": self.num_slots * self._slot_stripe_bytes,
            "cow_copies": host.cow_copies,
        }

    @staticmethod
    def prefix_stats(host: PagedCacheHost, requests) -> Optional[dict]:
        if host.prefix is None:
            return None
        total_prompt = sum(int(r.prompt.size) for r in requests)
        return {
            "hits": host.prefix.hits,
            "misses": host.prefix.misses,
            "tokens_reused": host.prefix.tokens_reused,
            "prefix_hit_pct": round(
                100.0 * host.prefix.tokens_reused / max(total_prompt, 1), 2
            ),
        }

    def _run_paged(self, params, requests: Sequence[Request],
                   sampler: Optional[SlotSampler]) -> Scheduler:
        """Continuous batching over the PAGE POOL: page-budgeted
        admission, optional chunked prefill (one `prefill_chunk`-token
        ingest per ingesting slot per engine iteration, sharing the
        iteration with the decode step, so a long prompt never stalls
        the batch), optional prefix caching (a cached prompt skips its
        prefill; its last partial page copies on the first divergent
        write)."""
        tracer = get_tracer()
        mx = get_metrics()
        host = self.new_host()
        sched = Scheduler(
            self.num_slots, self.max_len,
            bytes_per_slot=self._slot_stripe_bytes,
        )
        chunked = bool(self.prefill_chunk)
        self._check_prompts(requests, chunked)
        for r in requests:
            sched.submit(r)
        cache = self.init_cache()
        positions = np.zeros((self.num_slots,), np.int64)
        tokens = np.zeros((self.num_slots,), np.int64)
        active = np.zeros((self.num_slots,), bool)
        # slot -> [prompt, next ingest position, accumulated seconds]
        ingest: dict = {}

        def evict(slot):
            sched.finish(slot)
            active[slot] = False
            host.release(slot)

        while sched.has_work() or ingest:
            useful = 0
            # ---- admission: free slots AND page headroom -----------
            # The headroom check budgets the WHOLE sequence (prompt +
            # max_new_tokens, capped by the cache) against the pool
            # minus every admitted slot's outstanding commitment, so an
            # admitted request always allocates to completion; one the
            # pool cannot hold yet waits.
            while sched.can_admit():
                nxt = sched.waiting[0][1]
                budget = min(
                    int(nxt.prompt.size) + int(nxt.max_new_tokens),
                    self.max_len,
                )
                if not host.can_hold(budget):
                    break
                seq = sched.admit()
                host.reserve(seq.slot, budget)
                prompt = seq.request.prompt
                covered = host.attach_prefix(seq.slot, prompt)
                if mx.enabled and host.prefix is not None:
                    mx.inc("serve_prefix_hits_total", 1 if covered else 0)
                if not chunked:
                    host.ensure_pages(seq.slot, int(prompt.size))
                    ids, length = self.pad_prompt(prompt)
                    t0 = tracer.now()
                    with tracer.span("prefill", rid=repr(seq.request.rid),
                                     slot=seq.slot):
                        cache, nl = self.paged_prefill_step(
                            params, cache, host.device_row(seq.slot), ids,
                            length,
                        )
                        tok = self._pick(sampler, nl.cpu().numpy(),
                                         seq.slot)
                    seq.t_first_token = tracer.now()
                    sched.record_iteration(1)
                    if mx.enabled:
                        mx.observe("serve_prefill_s",
                                   seq.t_first_token - t0)
                        mx.inc("serve_tokens_total", 1)
                    seq.generated.append(tok)
                    tokens[seq.slot] = tok
                    positions[seq.slot] = prompt.size
                    active[seq.slot] = True
                    if seq.done(self.max_len):
                        evict(seq.slot)
                elif covered >= prompt.size - 1:
                    # Full prefix hit: every needed position is cached,
                    # so prefill is skipped and the last prompt token is
                    # decoded at its own position; its write page copies
                    # first if shared, in the ensure_writable pass below.
                    positions[seq.slot] = prompt.size - 1
                    tokens[seq.slot] = int(prompt[-1])
                    active[seq.slot] = True
                else:
                    ingest[seq.slot] = [prompt, covered, 0.0]
            # ---- ingestion: one chunk per ingesting slot -----------
            for slot in sorted(ingest):
                prompt, start, acc = ingest[slot]
                seq = sched.active[slot]
                ids, n = self.chunk_ids(prompt, start)
                host.ensure_pages(slot, start + n)
                t0 = tracer.now()
                with tracer.span("prefill_chunk", rid=repr(seq.request.rid),
                                 slot=slot, start=start):
                    cache, nl = self.chunk_prefill_step(
                        params, cache, host.device_row(slot), ids, start, n
                    )
                    done_ingest = start + n >= prompt.size
                    if done_ingest:
                        tok = self._pick(sampler, nl.cpu().numpy(), slot)
                dt = tracer.now() - t0
                useful += 1
                if done_ingest:
                    seq.t_first_token = tracer.now()
                    if mx.enabled:
                        mx.observe("serve_prefill_s", acc + dt)
                        mx.inc("serve_tokens_total", 1)
                    seq.generated.append(tok)
                    tokens[slot] = tok
                    positions[slot] = prompt.size
                    active[slot] = True
                    host.register_prefix(slot, prompt)
                    del ingest[slot]
                    if seq.done(self.max_len):
                        evict(slot)
                else:
                    ingest[slot][1] = start + n
                    ingest[slot][2] = acc + dt
            # ---- one decode step for the active set ----------------
            n_active = int(active.sum())
            if n_active:
                for slot in np.nonzero(active)[0]:
                    cache = host.ensure_writable(
                        cache, int(slot), int(positions[slot])
                    )
                t0 = tracer.now()
                with tracer.span("decode_step", active=n_active):
                    cache, logits = self.paged_decode_step(
                        params, cache, host.device_table(),
                        *self.step_inputs(positions, tokens, active),
                    )
                    logits_np = logits.cpu().numpy()
                dt = tracer.now() - t0
                sched.record_decode_step(n_active)
                tracer.counter("batch_occupancy", n_active)
                if mx.enabled:
                    mx.observe("serve_decode_step_s", dt)
                useful += n_active
                for slot, seq in list(sched.active.items()):
                    if slot in ingest or not active[slot]:
                        continue
                    tok = self._pick(sampler, logits_np[slot], slot)
                    if not seq.generated:
                        # A full prefix hit's first token comes from
                        # this decode step: its whole prefill was the
                        # cache lookup.
                        seq.t_first_token = tracer.now()
                    else:
                        seq.token_times.append(dt)
                    seq.generated.append(tok)
                    tokens[slot] = tok
                    positions[slot] += 1
                    if seq.done(self.max_len):
                        evict(slot)
            if mx.enabled:
                mx.gauge("serve_kv_pages_in_use", host.pool.pages_in_use)
            if useful:
                sched.record_iteration(useful)
            elif not ingest and not sched.active and sched.waiting:
                raise RuntimeError(
                    "page pool cannot hold the next waiting prompt "
                    f"({int(sched.waiting[0][1].prompt.size)} tokens, "
                    f"{host.pool.free_pages} free pages of "
                    f"{self.paged_spec.page_size}) — size the pool "
                    "larger (num_pages / --kv-pages)"
                )
        sched.paged_stats = self.paged_stats(host)
        sched.prefix_stats = self.prefix_stats(host, requests)
        return sched


__all__ = ["ServingEngine"]
