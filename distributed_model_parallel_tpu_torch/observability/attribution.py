"""Trace attribution: a recorded timeline walked into a measured cost
table keyed the way `cost.py` keys its predictions (port of
`observability/attribution.py`).

It reads a Chrome `trace_event` JSON and reduces it to

  * a per-phase table (count / total / mean / share of wall), one row a
    complete-event name,
  * the **unattributed residual**: main-track wall time covered by NO
    span, called out explicitly (a number you cannot attribute is a
    number you cannot trust), and
  * a measured-vs-predicted row per requested combo: the ledger's
    predicted per-step comm time against the measured per-step `sync`
    time (the value-fetch fences are where device and collective time
    surface on the host timeline, `trace.py`'s contract), with the delta
    stated.

Two sources write such a JSON in the port, and both are read:

  * the span tracer (`trace.Tracer.export`, `cli.serve --trace-out`):
    integer `tid`s, thread tracks at small first-seen ordinals, named
    tracks (one a request) at 1000 and above. Read as it is, so the
    results are the reference's on the same events.
  * torch.profiler (`--profile-dir`, `trace_epoch{N}.json`). Its
    complete events carry a `cat`, which the tracer never writes, and
    `profiler_tracks` maps them onto the tracer's tracks before
    anything is measured:
      - the one whole-window event of category `Trace` is dropped: it is
        no span of the run, and it would cover the wall and zero the
        residual;
      - device work (`kernel`, `gpu_memcpy`, `gpu_memset`,
        `gpu_user_annotation`: pid the device, tid the stream) goes on
        named tracks, 1000 + a first-seen ordinal, one a (pid, stream);
      - every other event is host work (pid and tid the OS's) and goes
        on a thread track, a first-seen ordinal a (pid, tid), as
        `Tracer._tid` numbers threads.
    The main track is then the busiest host thread (the trainer's), and
    the streams are the concurrent tracks `attribute` allows for. A
    kernel's row is its name's: its launches and their summed device
    time.

Everything here is pure arithmetic over the JSON (no torch, no numpy),
so the report runs anywhere, the pre-gate included.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

#: torch.profiler's categories of work that runs on the device
DEVICE_CATEGORIES = frozenset(
    {"kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation"}
)


def load_trace(path: str) -> dict:
    """Read a Chrome trace_event JSON, plain or gzipped. Accepts both
    container shapes: an object with `traceEvents` or a bare event
    list."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    if isinstance(data, list):
        data = {"traceEvents": data}
    if "traceEvents" not in data:
        raise ValueError(f"{path}: no traceEvents — not a Chrome trace")
    return data


def profile_dir_traces(profile_dir: str) -> List[str]:
    """The traces a `--profile-dir` capture left behind, newest first:
    the port's `trace_epoch{N}.json` and any `*trace.json(.gz)`; []
    when none exist (the caller treats the source as optional)."""
    hits: List[str] = []
    for pat in ("**/trace_epoch*.json", "**/*trace.json.gz",
                "**/*trace.json"):
        hits += glob.glob(
            os.path.join(profile_dir, pat), recursive=True
        )
    return sorted(set(hits), key=lambda p: (-os.path.getmtime(p), p))


def profiler_tracks(chrome: dict) -> dict:
    """`chrome` with torch.profiler's complete events on the tracer's
    tracks (module docstring); unchanged when no complete event carries
    a `cat` (the tracer's own export)."""
    events = chrome.get("traceEvents", [])
    if not any(e.get("ph") == "X" and "cat" in e for e in events):
        return chrome
    threads: Dict[tuple, int] = {}
    streams: Dict[tuple, int] = {}
    out = []
    for e in events:
        if e.get("ph") != "X":
            out.append(e)
            continue
        cat = e.get("cat")
        if cat == "Trace":
            continue
        key = (e.get("pid"), e.get("tid"))
        if cat in DEVICE_CATEGORIES:
            tid = 1000 + streams.setdefault(key, len(streams))
        else:
            tid = threads.setdefault(key, len(threads))
        out.append({**e, "tid": tid})
    return {**chrome, "traceEvents": out}


@dataclasses.dataclass
class PhaseRow:
    """One attributed phase: every complete event sharing a name."""

    name: str
    count: int
    total_ms: float
    mean_ms: float
    share: float  # of the main track's wall extent


@dataclasses.dataclass
class Attribution:
    """The measured table plus the explicit residual."""

    phases: List[PhaseRow]
    wall_ms: float          # main-track extent (first ts -> last end)
    covered_ms: float       # union of main-track span intervals
    residual_ms: float      # wall - covered: time NO span explains
    residual_share: float
    main_tid: int
    n_events: int

    def phase(self, name: str) -> Optional[PhaseRow]:
        for p in self.phases:
            if p.name == name:
                return p
        return None

    def as_dict(self) -> dict:
        return {
            "phases": [dataclasses.asdict(p) for p in self.phases],
            "wall_ms": self.wall_ms,
            "covered_ms": self.covered_ms,
            "residual_ms": self.residual_ms,
            "residual_share": self.residual_share,
            "main_tid": self.main_tid,
            "n_events": self.n_events,
        }


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the interval union (microsecond inputs, ms
    out). Nested spans (ckpt_snapshot inside checkpoint_blocked) must
    not double-count."""
    total = 0.0
    end = -1.0
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def attribute(chrome: dict) -> Attribution:
    """Reduce a Chrome trace to the per-phase measured table (module
    docstring). The MAIN track is the `tid` with the largest covered
    span time among thread tracks (named tracks sit at tid >= 1000:
    `trace.Tracer.track_id`, and the device streams of a torch.profiler
    trace); the residual is measured against that track only, since
    concurrent tracks legitimately overlap it."""
    events = profiler_tracks(chrome).get("traceEvents", [])
    spans = [
        e for e in events
        if e.get("ph") == "X" and "ts" in e and "dur" in e
    ]
    by_name: Dict[str, List[float]] = {}
    by_tid: Dict[int, List[Tuple[float, float]]] = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(float(e["dur"]))
        tid = int(e.get("tid", 0))
        t0 = float(e["ts"])
        by_tid.setdefault(tid, []).append((t0, t0 + float(e["dur"])))
    thread_tids = {t: iv for t, iv in by_tid.items() if t < 1000}
    pool = thread_tids or by_tid
    main_tid = 0
    wall_ms = covered_ms = 0.0
    if pool:
        main_tid = max(
            pool, key=lambda t: (_union_ms(pool[t]), -t)
        )
        iv = pool[main_tid]
        wall_ms = (max(b for _, b in iv) - min(a for a, _ in iv)) / 1e3
        covered_ms = _union_ms(iv)
    residual_ms = max(0.0, wall_ms - covered_ms)
    phases = []
    for name in sorted(by_name):
        durs = by_name[name]
        total = sum(durs) / 1e3
        phases.append(PhaseRow(
            name=name,
            count=len(durs),
            total_ms=round(total, 6),
            mean_ms=round(total / len(durs), 6),
            share=round(total / wall_ms, 6) if wall_ms else 0.0,
        ))
    phases.sort(key=lambda p: (-p.total_ms, p.name))
    return Attribution(
        phases=phases,
        wall_ms=round(wall_ms, 6),
        covered_ms=round(covered_ms, 6),
        residual_ms=round(residual_ms, 6),
        residual_share=(
            round(residual_ms / wall_ms, 6) if wall_ms else 0.0
        ),
        main_tid=main_tid,
        n_events=len(spans),
    )


def reconcile(
    attr: Attribution,
    ledger: dict,
    combos: Sequence[str],
) -> List[dict]:
    """Measured-vs-predicted rows, keyed the way `cost.py` keys its
    predictions (the ledger's combo names). Measured per-step comm is
    the mean `sync` span per `step` span (the fences are where the host
    timeline pays for device and collective time); a combo absent from
    the ledger reports predicted None rather than failing (the gate for
    that is `costgate`)."""
    step = attr.phase("step")
    sync = attr.phase("sync")
    n_steps = step.count if step else 0
    measured_ms = (
        round(sync.total_ms / n_steps, 6)
        if (sync and n_steps) else None
    )
    rows = []
    for name in combos:
        row = ledger.get("combos", {}).get(name)
        predicted_ms = (
            round(float(row["predicted_step_s"]) * 1e3, 6)
            if row and "predicted_step_s" in row else None
        )
        delta = None
        if predicted_ms and measured_ms is not None:
            delta = round(
                (measured_ms - predicted_ms) / predicted_ms * 100.0, 1
            )
        rows.append({
            "combo": name,
            "predicted_ms": predicted_ms,
            "measured_sync_ms_per_step": measured_ms,
            "steps": n_steps,
            "delta_pct": delta,
        })
    return rows


__all__ = [
    "Attribution",
    "PhaseRow",
    "attribute",
    "load_trace",
    "profile_dir_traces",
    "profiler_tracks",
    "reconcile",
]
