"""Metrics registry: counters, gauges and histograms with streaming
quantiles; Prometheus text exposition and JSON export (a copy of the
reference's `observability/metrics.py`; the port imports nothing of the
JAX package, so it keeps its own).

`trace.py` answers what the host loops spent their time on (a
timeline); this module records the distribution of what they did: the
Trainer's `train_step_s` / `train_fetch_s` / `train_checkpoint_blocked_s`
histograms and the serving path's latency histograms, goodput and
occupancy. It is also the one home of the percentile rule
(`exact_quantile`, equal to `numpy.percentile`'s default).

* Off by default: a disabled call site pays one attribute load and one
  branch and allocates nothing (`len(registry) == 0` stays true).
* Thread-safe: one lock around instrument creation and every mutation.
* Deterministic: instruments record caller-supplied values (timestamps
  come from `trace.get_tracer().now()`, an injectable clock), and the
  exports sort by name, so canned values give byte-stable output.

Histogram quantiles are exact up to `exact_cap` samples (numpy's linear
interpolation); past the cap the samples fold into log-spaced buckets
(ratio ``GROWTH``) and a quantile answers with its bucket's geometric
midpoint, within ``sqrt(GROWTH) - 1`` (~4.4%) relative error.

`METRIC_NAMES` and `TRACE_EVENT_NAMES` document every series the
package emits; `scan_emitted_names` finds emission sites whose literal
name is missing from them (tests/test_torch_port_metrics.py requires
none).

`export(path)` writes Prometheus text when the path ends in `.prom` and
JSON otherwise (`--metrics-out` on every CLI).
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Dict, List, Optional, Tuple

# ------------------------------------------------- documented registry
#
# The catalog of every series the port emits. A new call site adds its
# name here (with a one-line meaning), or tests/test_torch_port_metrics.py
# fails naming the stray (`scan_emitted_names`).

#: Metric names (this registry's counters/gauges/histograms).
METRIC_NAMES: Dict[str, str] = {
    # Trainer epoch loop (training/trainer.py) — seconds histograms.
    "train_fetch_s": (
        "host input fetch per batch (group host-load time / batches "
        "in the group) — the data-stall distribution"
    ),
    "train_step_s": (
        "host loop time per batch at dispatch granularity (boundary "
        "to boundary, data fetch included; the progress print reads "
        "the PREVIOUS group's metrics so its readback fence never "
        "lands in these samples)"
    ),
    "train_checkpoint_blocked_s": (
        "how long one checkpoint save held the epoch loop (whole "
        "write for sync formats; device->host snapshot under "
        "async_save)"
    ),
    "train_batches_total": "batches dispatched (counter)",
    # Serving (serving/scheduler.py + engine.py).
    "serve_queued_s": "per request: submit -> admission",
    "serve_ttft_s": "per request: submit -> first token (TTFT)",
    "serve_token_s": "per generated token: decode-step latency",
    "serve_prefill_s": "per prefill call: host time incl. logit fetch",
    "serve_decode_step_s": "per engine decode step: host time",
    "serve_batch_occupancy": "active slots in the last decode step",
    "serve_goodput": (
        "occupied / total slot-steps over the finished set (set at "
        "report time)"
    ),
    "serve_tokens_total": "generated tokens (counter)",
    "serve_kv_pages_in_use": (
        "live KV pages in the paged pool after the last engine "
        "iteration (page-granular allocation scales with live tokens, "
        "not slots*max_len — serving/kv_cache.py)"
    ),
    "serve_prefix_hits_total": (
        "requests whose prompt reused >= 1 cached prefix page "
        "(prompt caching; counter)"
    ),
    # Speculative decoding (serving/speculative.py).
    "serve_spec_accept_len": (
        "per verify round per slot: tokens emitted (accepted draft "
        "prefix + the correction/bonus token, so 1..k+1) — the "
        "realized-speedup distribution"
    ),
    "serve_spec_tokens_total": (
        "tokens emitted by speculative verify rounds (counter; subset "
        "of serve_tokens_total)"
    ),
    # Checkpointing (checkpointing/save.py + writer.py).
    "ckpt_snapshot_s": "device->host snapshot half of a sharded save",
    "ckpt_background_write_s": "file-I/O half, on the writer thread",
}

#: Trace event names (trace.py span/counter/complete/instant sites).
TRACE_EVENT_NAMES: Dict[str, str] = {
    "fetch": "Trainer: host load + device placement of one group",
    "step": "Trainer: the dispatch call (enqueue under async dispatch)",
    "sync": "Trainer: value-fetch fences where device time surfaces",
    "checkpoint_blocked": "Trainer: a save holding the epoch loop",
    "ckpt_snapshot": "checkpointing: device->host snapshot (step path)",
    "ckpt_background_write": "checkpointing: writer-thread file I/O",
    "prefill": (
        "serving: one prompt ingest (engine span) / the admit->first-"
        "token request leg (scheduler track)"
    ),
    "decode_step": "serving: one mixed-position batch decode step",
    "prefill_chunk": (
        "serving: one chunked-prefill ingest (prefill_chunk tokens of "
        "one slot's prompt, sharing the iteration with decode)"
    ),
    "queued": "serving request leg: submit -> admission",
    "decode": "serving request leg: first token -> eviction",
    "batch_occupancy": "serving counter: active slots per decode step",
    "draft_round": (
        "serving: one speculative proposal round (k draft decode "
        "steps over the active set, serving/speculative.py)"
    ),
    "verify_step": (
        "serving: one speculative verify step (target scores k+1 "
        "positions per slot in one chunk-shaped iteration)"
    ),
}


# ----------------------------------------------------- quantile (ONE)


def exact_quantile(samples, q: float) -> Optional[float]:
    """The repo's one percentile rule: linear interpolation between
    closest ranks, bit-equal to ``numpy.percentile(xs, q)`` (default
    method) on the same samples. `q` in [0, 100]; None when empty."""
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


# --------------------------------------------------------- instruments


class Counter:
    """Monotonic total (float). Mutated only through the registry."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


#: Streaming-bucket growth ratio: quantile answers are the bucket's
#: geometric midpoint, so the relative error is <= sqrt(GROWTH) - 1.
GROWTH = 2.0 ** 0.125  # ~9.05% bucket width -> ~4.4% quantile bound
_LOG_GROWTH = math.log(GROWTH)
_BUCKET_BASE = 1e-9  # smallest resolvable positive value (seconds-ish)


class Histogram:
    """Hybrid exact/streaming histogram (module docstring). Values are
    unit-agnostic floats; negative values clamp into the zero bucket.
    Not thread-safe on its own — the registry serializes access."""

    __slots__ = ("count", "total", "vmin", "vmax", "exact_cap",
                 "_samples", "_buckets", "_zero")

    def __init__(self, exact_cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.exact_cap = exact_cap
        self._samples: Optional[List[float]] = []
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # values <= _BUCKET_BASE (incl. exact zeros)

    @property
    def streaming(self) -> bool:
        return self._samples is None

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if self._samples is not None:
            self._samples.append(v)
            if len(self._samples) > self.exact_cap:
                for s in self._samples:
                    self._bucket(s)
                self._samples = None  # streaming from here on
            return
        self._bucket(v)

    def _bucket(self, v: float) -> None:
        if v <= _BUCKET_BASE:
            self._zero += 1
            return
        idx = int(math.floor(math.log(v / _BUCKET_BASE) / _LOG_GROWTH))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> Optional[float]:
        """Exact (numpy-equal) below the cap; bucket geometric midpoint
        beyond it (relative error <= sqrt(GROWTH) - 1)."""
        if self.count == 0:
            return None
        if self._samples is not None:
            return exact_quantile(self._samples, q)
        # Nearest-rank walk over the sorted sparse buckets.
        rank = max(0, min(self.count - 1, math.ceil(q / 100.0 * self.count) - 1))
        seen = self._zero
        if rank < seen:
            return 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank < seen:
                lo = _BUCKET_BASE * GROWTH ** idx
                return lo * math.sqrt(GROWTH)
        return self.vmax  # numerical belt-and-braces

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum": round(self.total, 9),
            "min": round(self.vmin, 9) if self.count else None,
            "max": round(self.vmax, 9) if self.count else None,
            "mode": "streaming" if self.streaming else "exact",
        }
        out["quantiles"] = {
            f"p{q:g}": (
                round(self.quantile(q), 9)
                if self.count else None
            )
            for q in (50, 90, 99)
        }
        return out


# ------------------------------------------------------------ registry


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without a trailing .0,
    floats via repr (deterministic shortest round-trip)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Counters, gauges, histograms behind ONE enabled flag (module
    docstring). All mutators are thread-safe and early-return on the
    disabled path without allocating anything."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------- mutators

    def inc(self, name: str, value: float = 1.0) -> None:
        """Add to a monotonic counter (one branch when disabled)."""
        if not self.enabled:
            return
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            c.value += float(value)

    def gauge(self, name: str, value: float) -> None:
        """Set a gauge to its latest value."""
        if not self.enabled:
            return
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            g.value = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record one histogram sample."""
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    # -------------------------------------------------------- readers

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def __len__(self) -> int:
        with self._lock:
            return (
                len(self._counters) + len(self._gauges)
                + len(self._hists)
            )

    # -------------------------------------------------------- exports

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): counters and gauges as
        single samples, histograms as summaries (p50/p90/p99 quantile
        samples + _sum/_count). Sorted by name; byte-stable for canned
        values."""
        lines: List[str] = []
        # The WHOLE render happens under the lock: quantile() walks
        # histogram internals that a concurrent observe() (e.g. the
        # checkpoint writer thread) may be re-bucketing mid-call —
        # same discipline as to_json's locked snapshot().
        with self._lock:
            for name, c in sorted(self._counters.items()):
                lines.append(
                    f"# HELP {name} {METRIC_NAMES.get(name, '')}"
                )
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(c.value)}")
            for name, g in sorted(self._gauges.items()):
                lines.append(
                    f"# HELP {name} {METRIC_NAMES.get(name, '')}"
                )
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(g.value)}")
            for name, h in sorted(self._hists.items()):
                lines.append(
                    f"# HELP {name} {METRIC_NAMES.get(name, '')}"
                )
                lines.append(f"# TYPE {name} summary")
                for q in (50, 90, 99):
                    v = h.quantile(q)
                    lines.append(
                        f'{name}{{quantile="{q / 100}"}} '
                        f"{_fmt(round(v, 9)) if v is not None else 'NaN'}"
                    )
                lines.append(f"{name}_sum {_fmt(round(h.total, 9))}")
                lines.append(f"{name}_count {h.count}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """The machine twin of the exposition — what `--metrics-out`
        writes for a path that does not end in `.prom`."""
        with self._lock:
            return {
                "counters": {
                    k: round(v.value, 9)
                    for k, v in sorted(self._counters.items())
                },
                "gauges": {
                    k: round(v.value, 9)
                    for k, v in sorted(self._gauges.items())
                },
                "histograms": {
                    k: h.snapshot()
                    for k, h in sorted(self._hists.items())
                },
            }

    def export(self, path: str) -> str:
        """Write the export to `path`: Prometheus text when it ends in
        `.prom`, JSON otherwise. Returns the path."""
        if path.endswith(".prom"):
            payload = self.to_prometheus()
        else:
            payload = json.dumps(self.to_json(), indent=1) + "\n"
        with open(path, "w") as f:
            f.write(payload)
        return path

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# ---------------------------------------------------- global registry

_ENV_FLAG = "DMP_METRICS"
_global_metrics: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def _env_enabled() -> bool:
    v = os.environ.get(_ENV_FLAG, "").strip().lower()
    return v not in ("", "0", "false", "off")


def get_metrics() -> MetricsRegistry:
    """The process-wide registry every wired layer records to. Created
    on first use; starts enabled iff DMP_METRICS is set."""
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
    """Swap the process-wide registry (tests inject a fresh instance;
    None resets to the lazy default)."""
    global _global_metrics
    with _global_lock:
        _global_metrics = registry


def enable() -> MetricsRegistry:
    m = get_metrics()
    m.enabled = True
    return m


def disable() -> None:
    get_metrics().enabled = False


# ----------------------------------------------- emitted-name scanner

import re  # noqa: E402  (kept with its sole consumer)

#: call-site patterns -> which documented registry the name must be in.
_EMIT_PATTERNS: Tuple[Tuple[str, str], ...] = (
    (r"\.span\(\s*[\"']([A-Za-z0-9_]+)[\"']", "trace"),
    (r"\.counter\(\s*[\"']([A-Za-z0-9_]+)[\"']", "trace"),
    (r"\.instant\(\s*[\"']([A-Za-z0-9_]+)[\"']", "trace"),
    (r"\.complete\(\s*[\"']([A-Za-z0-9_]+)[\"']", "trace"),
    (r"\.observe\(\s*[\"']([A-Za-z0-9_]+)[\"']", "metric"),
    (r"\.inc\(\s*[\"']([A-Za-z0-9_]+)[\"']", "metric"),
    (r"\.gauge\(\s*[\"']([A-Za-z0-9_]+)[\"']", "metric"),
)


def scan_emitted_names(root: Optional[str] = None) -> Dict[str, List[str]]:
    """Walk the package source for span/counter/metric emission sites
    with a literal name and return {undocumented name: [file:line,
    ...]} — empty when every emitted name is in METRIC_NAMES /
    TRACE_EVENT_NAMES."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    patterns = [(re.compile(p), kind) for p, kind in _EMIT_PATTERNS]
    strays: Dict[str, List[str]] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path) as f:
                    src = f.read()
            except OSError:
                continue
            for pat, kind in patterns:
                for m in pat.finditer(src):
                    name = m.group(1)
                    documented = (
                        TRACE_EVENT_NAMES if kind == "trace"
                        else METRIC_NAMES
                    )
                    if name in documented:
                        continue
                    line = src.count("\n", 0, m.start()) + 1
                    strays.setdefault(name, []).append(
                        f"{os.path.relpath(path, root)}:{line}"
                    )
    return strays


__all__ = [
    "Counter",
    "Gauge",
    "GROWTH",
    "Histogram",
    "METRIC_NAMES",
    "MetricsRegistry",
    "TRACE_EVENT_NAMES",
    "disable",
    "enable",
    "exact_quantile",
    "get_metrics",
    "scan_emitted_names",
    "set_metrics",
]
