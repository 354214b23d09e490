"""Continuous-batching request scheduler (port of `serving/scheduler.py`).

Iteration-level scheduling: each engine iteration admits waiting
requests into free cache slots (prefill), runs ONE decode step for the
whole mixed-position batch, and evicts finished sequences, whose slots
recycle at once. Host-side and framework-free, like the reference; the
speculative-decoding and paged-pool statistics belong to later slices.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from distributed_model_parallel_tpu_torch.observability.metrics import (
    exact_quantile,
    get_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (
    get_tracer,
)
from distributed_model_parallel_tpu_torch.serving.kv_cache import (
    SlotAllocator,
)


@dataclasses.dataclass
class Request:
    """One generation request. `prompt` is a 1-D int32 token vector;
    generation stops after `max_new_tokens` or at `eos_id`."""

    rid: Any
    prompt: np.ndarray
    max_new_tokens: int = 16
    eos_id: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid!r}: max_new_tokens must be >= 1"
            )


@dataclasses.dataclass
class Sequence:
    """A live (admitted) request: its slot, generated tokens, and the
    timing legs the latency report is built from."""

    request: Request
    slot: int
    t_submit: float
    t_admit: float = 0.0
    t_first_token: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def position(self) -> int:
        """Next write position: prompt + tokens generated so far."""
        return int(self.request.prompt.size) + len(self.generated)

    def done(self, max_len: int) -> bool:
        r = self.request
        if len(self.generated) >= r.max_new_tokens:
            return True
        if r.eos_id is not None and self.generated \
                and self.generated[-1] == r.eos_id:
            return True
        return self.position >= max_len  # out of cache positions


@dataclasses.dataclass
class FinishedSequence:
    rid: Any
    prompt_len: int
    tokens: List[int]
    prefill_s: float  # submit -> first token (queueing + prefill)
    decode_s: List[float]  # per-token decode latencies
    total_s: float


class Scheduler:
    """FIFO continuous batching over `num_slots` cache slots."""

    def __init__(self, num_slots: int, max_len: int, *,
                 bytes_per_slot: int = 0):
        self.slots = SlotAllocator(num_slots, bytes_per_slot=bytes_per_slot)
        self.max_len = max_len
        # (t_submit, request) pairs: rids need not be unique.
        self.waiting: Deque[tuple] = deque()
        self.active: Dict[int, Sequence] = {}
        self.finished: List[FinishedSequence] = []
        # Active-slot count of every decode step (the goodput
        # denominator) and useful slots per engine iteration (a
        # monolithic prefill is an iteration in which ONE slot worked).
        self.step_occupancy: List[int] = []
        self.iter_occupancy: List[int] = []

    def submit(self, request: Request) -> None:
        if request.prompt.size >= self.max_len:
            raise ValueError(
                f"request {request.rid!r}: prompt length "
                f"{request.prompt.size} leaves no room to generate "
                f"(cache max_len {self.max_len})"
            )
        self.waiting.append((get_tracer().now(), request))

    def can_admit(self) -> bool:
        return bool(self.waiting) and self.slots.free_slots > 0

    def admit(self) -> Sequence:
        """Pop the next waiting request into the lowest free slot."""
        t_submit, request = self.waiting.popleft()
        slot = self.slots.alloc()
        seq = Sequence(
            request=request, slot=slot, t_submit=t_submit,
            t_admit=get_tracer().now(),
        )
        self.active[slot] = seq
        return seq

    def finish(self, slot: int) -> FinishedSequence:
        """Evict a finished sequence and recycle its slot."""
        seq = self.active.pop(slot)
        self.slots.free(slot)
        now = get_tracer().now()
        fin = FinishedSequence(
            rid=seq.request.rid,
            prompt_len=int(seq.request.prompt.size),
            tokens=list(seq.generated),
            prefill_s=seq.t_first_token - seq.t_submit,
            decode_s=list(seq.token_times),
            total_s=now - seq.t_submit,
        )
        self.finished.append(fin)
        tracer = get_tracer()
        if tracer.enabled:
            tid = tracer.track_id(f"request {seq.request.rid!r}")
            tracer.complete("queued", seq.t_submit, seq.t_admit, tid=tid)
            tracer.complete(
                "prefill", seq.t_admit, seq.t_first_token, tid=tid,
                prompt_len=fin.prompt_len,
            )
            tracer.complete(
                "decode", seq.t_first_token, now, tid=tid,
                tokens=len(fin.tokens), slot=slot,
            )
        mx = get_metrics()
        if mx.enabled:
            mx.observe("serve_queued_s", seq.t_admit - seq.t_submit)
            mx.observe("serve_ttft_s", fin.prefill_s)
            for t in fin.decode_s:
                mx.observe("serve_token_s", t)
        return fin

    def record_decode_step(self, n_active: int) -> None:
        """One decode step's occupancy sample."""
        self.step_occupancy.append(int(n_active))
        mx = get_metrics()
        if mx.enabled:
            mx.gauge("serve_batch_occupancy", int(n_active))
            mx.inc("serve_tokens_total", int(n_active))

    def record_iteration(self, n_useful: int) -> None:
        """One engine iteration's useful-slot count."""
        self.iter_occupancy.append(int(n_useful))

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active)

    def latency_report(self) -> dict:
        """Aggregate tokens/sec and per-leg p50/p99 over the finished
        set (prefill = submit -> first token, i.e. TTFT; decode =
        per-token step latency), plus batch occupancy and goodput (the
        useful fraction of slot-steps)."""
        fins = self.finished
        decode = [t for f in fins for t in f.decode_s]
        prefill = [f.prefill_s for f in fins]
        n_tokens = int(sum(len(f.tokens) for f in fins))
        total = max((f.total_s for f in fins), default=0.0)
        occ = np.asarray(self.step_occupancy, np.float64)
        goodput = (
            round(float(occ.sum()) / (occ.size * self.slots.num_slots), 4)
            if occ.size else None
        )
        mx = get_metrics()
        if mx.enabled and goodput is not None:
            mx.gauge("serve_goodput", goodput)
        iters = np.asarray(self.iter_occupancy, np.float64)
        return {
            "requests": len(fins),
            "generated_tokens": n_tokens,
            "tokens_per_s": (
                round(n_tokens / total, 2) if total > 0 else 0.0
            ),
            "prefill_p50_ms": _pct(prefill, 50),
            "prefill_p99_ms": _pct(prefill, 99),
            "ttft_p99_ms": _pct(prefill, 99),
            "decode_p50_ms": _pct(decode, 50),
            "decode_p99_ms": _pct(decode, 99),
            "decode_steps": int(occ.size),
            "mean_batch_occupancy": (
                round(float(occ.mean()), 3) if occ.size else None
            ),
            "engine_iterations": int(iters.size),
            "mean_iter_occupancy": (
                round(float(iters.mean()), 3) if iters.size else None
            ),
            "goodput": goodput,
        }


def _pct(xs, q: float):
    """Milliseconds quantile of a seconds sample list; None when empty."""
    v = exact_quantile(xs, q)
    return None if v is None else round(v * 1e3, 3)


__all__ = ["FinishedSequence", "Request", "Scheduler", "Sequence"]
