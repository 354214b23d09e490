"""Metrics registry, the part the serving path calls (port of
`observability/metrics.py`): counters, gauges and histograms behind one
`enabled` flag, the process-wide `get_metrics()`, JSON export, and the
repo's one percentile rule `exact_quantile`.

Disabled by default; a disabled call site pays one attribute load + one
branch. Histograms here keep every sample (exact quantiles): the
reference's streaming buckets and Prometheus exposition are not ported.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Dict, List, Optional


def exact_quantile(samples, q: float) -> Optional[float]:
    """Linear interpolation between closest ranks, equal to
    ``numpy.percentile(xs, q)`` (default method). `q` in [0, 100]; None
    when empty."""
    xs = sorted(samples)
    n = len(xs)
    if n == 0:
        return None
    if n == 1:
        return float(xs[0])
    h = (n - 1) * (q / 100.0)
    lo = int(math.floor(h))
    if lo >= n - 1:
        return float(xs[-1])
    frac = h - lo
    return float(xs[lo]) + frac * (float(xs[lo + 1]) - float(xs[lo]))


class MetricsRegistry:
    """Counters, gauges, histograms (module docstring); thread-safe."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    def to_json(self) -> dict:
        with self._lock:
            hists = {k: list(v) for k, v in sorted(self._hists.items())}
            out = {
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
            }
        out["histograms"] = {
            k: {
                "count": len(xs),
                "sum": sum(xs),
                "min": min(xs),
                "max": max(xs),
                "quantiles": {
                    f"p{q}": exact_quantile(xs, q) for q in (50, 90, 99)
                },
            }
            for k, xs in hists.items()
        }
        return out

    def export(self, path: str) -> str:
        """Write the JSON export to `path`; returns the path."""
        with open(path, "w") as f:
            f.write(json.dumps(self.to_json(), indent=1) + "\n")
        return path


_ENV_FLAG = "DMP_METRICS"
_global_metrics: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def _env_enabled() -> bool:
    v = os.environ.get(_ENV_FLAG, "").strip().lower()
    return v not in ("", "0", "false", "off")


def get_metrics() -> MetricsRegistry:
    """The process-wide registry; created on first use, enabled iff
    DMP_METRICS is set."""
    global _global_metrics
    m = _global_metrics
    if m is None:
        with _global_lock:
            m = _global_metrics
            if m is None:
                m = MetricsRegistry(enabled=_env_enabled())
                _global_metrics = m
    return m


def set_metrics(registry: Optional[MetricsRegistry]) -> None:
    global _global_metrics
    with _global_lock:
        _global_metrics = registry


def enable() -> MetricsRegistry:
    m = get_metrics()
    m.enabled = True
    return m


__all__ = [
    "MetricsRegistry",
    "enable",
    "exact_quantile",
    "get_metrics",
    "set_metrics",
]
