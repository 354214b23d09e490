"""Host-side span tracer — nested spans + counters, Chrome trace export
(a copy of the reference's `observability/trace.py`; the port imports
nothing of the JAX package, so it keeps its own).

* **Zero-cost off-path.** Tracing is DISABLED by default; a disabled
  call site pays one attribute load + one branch and allocates nothing.
* **Thread-safe.** One lock around the event list.
* **Deterministic under test.** The clock is injected
  (`Tracer(clock=...)`); thread ids map to small first-seen ordinals,
  and insertion order is preserved.

Spans time the HOST. CUDA work is asynchronous, so device time shows up
in the span that ends with a device-to-host read (the serving engine's
logits fetch); `torch.profiler` is the device-side tool.

Export is the Chrome `trace_event` JSON format (`chrome://tracing`,
Perfetto). The module-global tracer (`get_tracer()`) starts enabled
when the environment carries ``DMP_TRACE=1``; programs opt in with
`enable()` (e.g. `cli/serve.py --trace-out`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager — the disabled path's entire cost
    is returning this singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records its start on __enter__ and appends the
    complete event on __exit__."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._now()
        self._tracer._append_complete(
            self.name, self._t0, t1 - self._t0, None, self.args
        )
        return False


class Tracer:
    """Nested spans + counters with Chrome `trace_event` export
    (module docstring). All public mutators are thread-safe."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 enabled: bool = False):
        self._clock = clock if clock is not None else time.perf_counter
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[Any, int] = {}  # thread ident -> ordinal
        self._tracks: Dict[str, int] = {}  # named track -> ordinal
        self._origin = self._clock()

    def _now(self) -> float:
        return self._clock() - self._origin

    def now(self) -> float:
        """An absolute timestamp in THIS tracer's clock domain — the
        domain `complete()` expects; also the serving report's clock.
        Works with tracing disabled."""
        return self._clock()

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = len(self._tids)
                    self._tids[ident] = tid
        return tid

    def track_id(self, name: str) -> int:
        """Stable integer track (Chrome `tid`) for a NAMED timeline,
        disjoint from thread tracks (offset by 1000)."""
        with self._lock:
            tid = self._tracks.get(name)
            if tid is None:
                tid = 1000 + len(self._tracks)
                self._tracks[name] = tid
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": 0,
                    "tid": tid, "args": {"name": name},
                })
            return tid

    def _append_complete(self, name: str, t0: float, dur: float,
                         tid: Optional[int], args: dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(t0 * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "pid": 0,
            "tid": self._tid() if tid is None else tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **args) -> Any:
        """Context manager timing one nested host-side phase."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def complete(self, name: str, start: float, end: float,
                 tid: Optional[int] = None, **args) -> None:
        """Record a complete event from timestamps already taken with
        `now()`."""
        if not self.enabled:
            return
        self._append_complete(
            name, start - self._origin, end - start, tid, args
        )

    def counter(self, name: str, value) -> None:
        """One sample of a named counter series (Chrome `"ph": "C"`)."""
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "C", "ts": round(self._now() * 1e6, 3),
            "pid": 0, "args": {name: value},
        }
        with self._lock:
            self._events.append(ev)

    def to_chrome(self) -> dict:
        """The Chrome `trace_event` object."""
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path


_ENV_FLAG = "DMP_TRACE"
_global_tracer: Optional[Tracer] = None
_global_lock = threading.Lock()


def _env_enabled() -> bool:
    v = os.environ.get(_ENV_FLAG, "").strip().lower()
    return v not in ("", "0", "false", "off")


def get_tracer() -> Tracer:
    """The process-wide tracer; created on first use, enabled iff
    DMP_TRACE is set."""
    global _global_tracer
    t = _global_tracer
    if t is None:
        with _global_lock:
            t = _global_tracer
            if t is None:
                t = Tracer(enabled=_env_enabled())
                _global_tracer = t
    return t


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Swap the process-wide tracer (None resets to the lazy default)."""
    global _global_tracer
    with _global_lock:
        _global_tracer = tracer


def enable() -> Tracer:
    t = get_tracer()
    t.enabled = True
    return t


def disable() -> None:
    get_tracer().enabled = False


__all__ = ["Tracer", "disable", "enable", "get_tracer", "set_tracer"]
