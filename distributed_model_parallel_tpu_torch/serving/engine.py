"""ServingEngine: prefill/decode split with continuous batching over the
contiguous KV cache (port of `serving/engine.py`, replicated layout).

One decode step advances EVERY cache slot one token, whatever position
each slot sits at (the mixed-position batch of continuous batching).
The host loop (`run`) admits waiting requests into free slots
(prefill), runs one decode step for the active set, and evicts finished
sequences.

Parameters are the dense `models/gpt.py` tree, the reference's `gpt_lm`
tree carried over by `models/convert.py`. Under `compute_dtype="int8"`
the decode steps thread the `QuantMatmul` policy into the blocks, so
each decoder block's four projections run the int8 GEMM kernel
(`csrc/int8_matmul.cu` on the GPU); prefill and the vocabulary head
stay f32, and activations and cache stay f32, exactly as in the
reference. Each weight is quantized once, in `place_params`.

Knobs the reference has that belong to later port slices are accepted
as fields and refused with a ValueError naming the slice.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Sequence

import numpy as np
import torch

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
)
from distributed_model_parallel_tpu_torch.serving.decode import (
    CacheAttention,
    PrefillRecorder,
    decode_stem,
    prefill_stem,
)
from distributed_model_parallel_tpu_torch.serving.kv_cache import (
    KVCacheSpec,
    init_cache,
)
from distributed_model_parallel_tpu_torch.serving.sampling import (
    SamplingConfig,
    SlotSampler,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import (
    Request,
    Scheduler,
)

# Later port slices (ROADMAP.md), named by the refusals below.
TP_SP_SLICE = "the tp/sp serving-layout slice"
PAGED_SLICE = "the paged-cache serving slice (paging, chunked prefill, " \
    "prefix cache)"
SPECULATIVE_SLICE = "the speculative-decoding slice"
BF16_SLICE = "the bf16 serving slice"


def _not_ported(knob: str, later: str) -> ValueError:
    return ValueError(
        f"{knob} is not ported to the PyTorch package yet: it belongs to "
        f"{later} (ROADMAP.md). This slice serves the replicated layout "
        "with a contiguous cache, monolithic prefill and f32/int8 decode."
    )


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
    # "f32" (default) or "int8" (decode projections through the int8
    # GEMM; activations, cache, prefill and head stay f32).
    compute_dtype: Any = None
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    prefill_chunk: Optional[int] = None
    prefix_cache: bool = False
    speculative_k: int = 0
    # Where parameters, cache and compute live: the GPU unless the
    # caller asks for the CPU (the tests do).
    device: Any = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        if self.mesh is not None:
            raise _not_ported("a device mesh", TP_SP_SLICE)
        if self.layout in ("tp", "sp"):
            raise _not_ported(f"layout={self.layout!r}", TP_SP_SLICE)
        if self.collective_matmul:
            raise _not_ported("collective_matmul", TP_SP_SLICE)
        for value, knob in ((self.page_size, "page_size"),
                            (self.num_pages, "num_pages"),
                            (self.prefill_chunk, "prefill_chunk"),
                            (self.prefix_cache or None, "prefix_cache")):
            if value is not None:
                raise _not_ported(knob, PAGED_SLICE)
        if self.speculative_k:
            raise _not_ported("speculative_k", SPECULATIVE_SLICE)
        if self.compute_dtype in ("bf16", torch.bfloat16):
            raise _not_ported(f"compute_dtype={self.compute_dtype!r}",
                              BF16_SLICE)
        self.compute_mode = normalize_compute_dtype(self.compute_dtype)
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
        self.spec = KVCacheSpec(
            num_layers=cfg.num_layers, num_slots=self.num_slots,
            max_len=self.max_len, num_heads=cfg.num_heads,
            head_dim=cfg.dim // cfg.num_heads,
        )
        self.spec.validate(self.layout)
        # The decode-step projection policy; threaded ONLY into decode
        # (prefill stays f32 — the decode hot floor is the target).
        self._decode_mm = (
            QuantMatmul() if self.compute_mode == "int8" else None
        )
        self._ctx = L.Context(train=False)
        self._decode_ctx = L.Context(train=False, matmul=self._decode_mm)

    # ------------------------------------------------------------ state

    def init_params(self, seed: int = 0) -> dict:
        """Fresh parameters from `seed` (`models/gpt.init_params`),
        placed on this engine's device."""
        return self.place_params(
            init_params(self.cfg, seed, device=self.device)
        )

    def place_params(self, params) -> dict:
        """Move a `gpt_lm` parameter tree to this engine's device (f32)
        and, under int8, quantize every decode projection weight once
        (the weight scales are static per weight)."""
        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            return tree.to(self.device, torch.float32)

        params = place(params)
        if self._decode_mm is not None:
            for block in params["blocks"].values():
                for group, names in (("attn", ("qkv", "out")),
                                     ("ffn", ("in", "out"))):
                    for name in names:
                        self._decode_mm.prepare(block[group][name]["w"])
        return params

    def init_cache(self) -> dict:
        return init_cache(self.spec, self.device)

    # ------------------------------------------------------------ steps

    @torch.no_grad()
    def prefill(self, params, cache, ids, length: int, slot: int):
        """One padded prompt (1, prefill_len) of `length` real tokens
        into `slot`: writes the slot's cache stripe in place and returns
        (cache, next-token logits (vocab,) f32)."""
        cfg = self.cfg
        p_len = self.prefill_len
        mask = torch.arange(p_len, device=self.device)[None, :] < length
        h = prefill_stem(params["stem"], ids)
        rec = PrefillRecorder(partial(dot_product_attention, causal=True))
        h, _ = decoder_blocks(params["blocks"], (h, mask), cfg, self._ctx,
                              rec)
        # Only the last real position's logits are read, so only that
        # row goes through the vocabulary head.
        next_logits = head_apply(params["head"], h[:, length - 1])[0]
        cache["k"][:, slot, :p_len] = torch.stack([k[0] for k in rec.ks])
        cache["v"][:, slot, :p_len] = torch.stack([v[0] for v in rec.vs])
        cache["k"][:, slot, p_len:] = 0
        cache["v"][:, slot, p_len:] = 0
        cache["lengths"][slot] = length
        return cache, next_logits

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, active):
        """One token for every slot, each at its own position: tokens
        (slots,) int64, active (slots,) bool on the device. Updates the
        cache in place and returns (cache, logits (slots, vocab) f32)."""
        cfg = self.cfg
        positions = cache["lengths"]
        rec = CacheAttention(cache["k"], cache["v"], positions, active)
        h = decode_stem(
            params["stem"], tokens, positions.clamp(0, cfg.max_position - 1)
        )
        mask = torch.ones((self.num_slots, 1), dtype=torch.bool,
                          device=self.device)
        h, _ = decoder_blocks(params["blocks"], (h, mask), cfg,
                              self._decode_ctx, rec)
        logits = head_apply(params["head"], h)[:, 0, :]
        cache["lengths"] = torch.where(active, positions + 1, positions)
        return cache, logits

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

    def _pick(self, sampler: Optional[SlotSampler], logits_row,
              slot: int) -> int:
        """Next token id: greedy argmax or the per-slot sampling lane."""
        row = np.asarray(logits_row)
        if sampler is None:
            return int(row.argmax())
        return sampler.pick(row, slot)

    def run(self, params, requests: Sequence[Request],
            sampling: Optional[SamplingConfig] = None, *,
            draft=None, draft_params=None) -> Scheduler:
        """Offline continuous batching: drive the request set to
        completion (greedy by default; a SamplingConfig samples with
        per-slot PRNG lanes) and return the Scheduler with its
        `finished` records and `latency_report()`."""
        if draft is not None or draft_params is not None:
            raise _not_ported("draft/draft_params", SPECULATIVE_SLICE)
        sampler = (
            SlotSampler(sampling, self.num_slots)
            if sampling is not None and not sampling.greedy else None
        )
        return self._run_contiguous(params, requests, sampler)

    def _run_contiguous(self, params, requests: Sequence[Request],
                        sampler: Optional[SlotSampler]) -> Scheduler:
        tracer = get_tracer()
        mx = get_metrics()
        sched = Scheduler(
            self.num_slots, self.max_len,
            bytes_per_slot=self.spec.slot_stripe_bytes,
        )
        for r in requests:
            if r.prompt.size > self.prefill_len:
                raise ValueError(
                    f"request {r.rid!r}: prompt length {r.prompt.size} "
                    f"exceeds prefill_len {self.prefill_len}"
                )
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


__all__ = ["ServingEngine"]
