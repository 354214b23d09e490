"""Token selection for the serving engine (port of `serving/sampling.py`):
greedy (the bit-stable default) or temperature / top-k / top-p sampling
with a per-slot PRNG lane.

Sampling runs on the HOST over the logits row the decode step already
fetched, in numpy, so the port draws exactly what the reference draws:

* **Greedy is bit-stable.** `temperature == 0` never touches an RNG.
* **Per-slot PRNG lane.** Each cache slot owns one counter-based numpy
  Philox stream keyed `(seed, slot)` — the reference's lanes verbatim —
  so the same logits rows give the same tokens in both packages.

Filter order: logits / T, keep the top-k, then the top-p nucleus (the
most probable token always survives), renormalize, draw. The
speculative-decoding surface (`dist`, `uniform`, `sample_dist`) belongs
to a later port slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Decode-time sampling surface (`cli/serve.py`
    --temperature/--top-k/--top-p). temperature 0 = greedy."""

    temperature: float = 0.0
    top_k: int = 0  # 0 = no top-k cut
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}"
            )
        if self.temperature == 0 and (
            self.top_k > 0 or self.top_p < 1
        ):
            raise ValueError(
                "top_k/top_p filter a SAMPLING distribution; with "
                "temperature 0 (greedy) they would silently do "
                "nothing — set temperature > 0"
            )

    @property
    def greedy(self) -> bool:
        return self.temperature == 0


class SlotSampler:
    """One Philox lane per cache slot (module docstring)."""

    def __init__(self, cfg: Optional[SamplingConfig], num_slots: int):
        self.cfg = cfg or SamplingConfig()
        self._lanes: List[np.random.Generator] = [
            np.random.Generator(
                np.random.Philox(key=[self.cfg.seed, slot])
            )
            for slot in range(num_slots)
        ]

    def pick(self, logits: np.ndarray, slot: int) -> int:
        """Next token id for `slot` from its logits row."""
        cfg = self.cfg
        if cfg.greedy:
            return int(np.argmax(logits))
        z = np.asarray(logits, np.float64) / cfg.temperature
        order = np.argsort(z)[::-1]  # descending
        if cfg.top_k:
            order = order[: cfg.top_k]
        z = z[order]
        probs = np.exp(z - z.max())
        probs /= probs.sum()
        if cfg.top_p < 1:
            keep = int(np.searchsorted(
                np.cumsum(probs), cfg.top_p, side="left"
            )) + 1  # the argmax always survives
            order = order[:keep]
            probs = probs[:keep] / probs[:keep].sum()
        draw = self._lanes[slot].random()
        idx = int(np.searchsorted(np.cumsum(probs), draw, side="right"))
        return int(order[min(idx, len(order) - 1)])


__all__ = ["SamplingConfig", "SlotSampler"]
