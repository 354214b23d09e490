"""obsreport: one unified run report from trace + metrics + ledger (port
of `observability/report.py`; the reference's CLI is `tools/obsreport`).

It reads up to four artifacts of one run and renders a single
deterministic text report (plus a JSON twin):

  * a Chrome trace (`trace.Tracer`'s export, e.g. `cli.serve
    --trace-out`, or the torch.profiler `trace_epoch{N}.json` a
    `--profile-dir` run writes) -> the per-phase attribution table with
    the unattributed residual called out (`attribution.py`),
  * a metrics JSON (`--metrics-out`) -> the SLO histogram section
    (per-request / per-token quantiles, goodput, counters),
  * the cost ledger (`cost_ledger.json` beside `costgate.py`) ->
    measured-vs-predicted rows per requested combo,
  * a calibration file (`calibrate.py`) -> fitted-vs-committed drift.

Rendering is pure formatting over the ingested JSON (no torch, no
numpy, no wall clock), so the same inputs yield the same bytes forever;
the report does no tensor work and takes no `--device`. That property
is the pre-gate: `--pregate` renders the canned golden inputs
(`obsreport_golden/obsreport_*.json` beside this module) and
byte-compares against the committed golden report there, exit 5 naming
the first diverging line.

    python -m distributed_model_parallel_tpu_torch.observability.report \\
        --trace t.json --metrics m.json --ledger \\
        distributed_model_parallel_tpu_torch/observability/cost_ledger.json \\
        --combo serve/S2
    python -m distributed_model_parallel_tpu_torch.observability.report \\
        --profile-dir prof --json
    python -m distributed_model_parallel_tpu_torch.observability.report \\
        --pregate
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from distributed_model_parallel_tpu_torch.observability.attribution import (
    Attribution,
    attribute,
    load_trace,
    profile_dir_traces,
    reconcile,
)

EXIT_GOLDEN_MISMATCH = 5

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "obsreport_golden")
PREGATE_INPUTS = {
    "trace": os.path.join(GOLDEN_DIR, "obsreport_trace.json"),
    "metrics": os.path.join(GOLDEN_DIR, "obsreport_metrics.json"),
    "ledger": os.path.join(GOLDEN_DIR, "obsreport_ledger.json"),
    "calibration": os.path.join(
        GOLDEN_DIR, "obsreport_calibration.json"
    ),
    "golden": os.path.join(GOLDEN_DIR, "obsreport_report.txt"),
}
PREGATE_COMBOS = ["golden/S2"]


def _f(v: Optional[float], nd: int = 3) -> str:
    return "-" if v is None else f"{v:.{nd}f}"


def render_report(
    chrome: dict,
    metrics: Optional[dict] = None,
    ledger: Optional[dict] = None,
    combos: Optional[List[str]] = None,
    calibration: Optional[dict] = None,
) -> str:
    """The unified text report (module docstring). Deterministic: no
    paths, no timestamps, sorted sections."""
    attr = attribute(chrome)
    lines: List[str] = ["== obsreport =="]
    lines.append(
        f"trace: {attr.n_events} spans, main track {attr.main_tid}, "
        f"wall {_f(attr.wall_ms)} ms"
    )
    lines.append("")
    lines.append("-- attribution (per phase) --")
    lines.append(
        f"{'phase':<24}{'count':>7}{'total_ms':>12}{'mean_ms':>12}"
        f"{'share%':>9}"
    )
    for p in attr.phases:
        lines.append(
            f"{p.name:<24}{p.count:>7}{p.total_ms:>12.3f}"
            f"{p.mean_ms:>12.3f}{p.share * 100:>9.2f}"
        )
    lines.append(
        f"unattributed residual: {_f(attr.residual_ms)} ms "
        f"({attr.residual_share * 100:.2f}% of wall)"
    )
    if ledger is not None and combos:
        lines.append("")
        lines.append("-- measured vs predicted (per combo) --")
        lines.append(
            f"{'combo':<36}{'predicted_ms':>14}"
            f"{'sync_ms/step':>14}{'delta%':>9}"
        )
        for row in reconcile(attr, ledger, combos):
            delta = row["delta_pct"]
            lines.append(
                f"{row['combo']:<36}{_f(row['predicted_ms']):>14}"
                f"{_f(row['measured_sync_ms_per_step']):>14}"
                f"{('%+.1f' % delta) if delta is not None else '-':>9}"
            )
    if metrics:
        hists: Dict[str, dict] = metrics.get("histograms", {})
        if hists:
            lines.append("")
            lines.append("-- SLO histograms --")
            for name in sorted(hists):
                h = hists[name]
                q = h.get("quantiles", {})
                lines.append(
                    f"{name:<28}n={h.get('count', 0):<7}"
                    f"p50 {_f(q.get('p50'), 6)}  "
                    f"p90 {_f(q.get('p90'), 6)}  "
                    f"p99 {_f(q.get('p99'), 6)}  "
                    f"[{h.get('mode', '?')}]"
                )
        scalars = []
        for kind in ("counters", "gauges"):
            for name, v in sorted(metrics.get(kind, {}).items()):
                scalars.append(f"{name:<28}{v:g}  [{kind[:-1]}]")
        if scalars:
            lines.append("")
            lines.append("-- counters / gauges --")
            lines += scalars
    if calibration:
        lines.append("")
        lines.append("-- calibration drift (reported, not gated) --")
        committed = calibration.get("committed_constants", {})
        fitted = calibration.get("constants", {})
        drift = calibration.get("drift_pct", {})
        for key in sorted(fitted):
            lines.append(
                f"{key:<34}committed {committed.get(key, 0):g}  "
                f"fitted {fitted[key]:g}  "
                f"({drift.get(key, 0):+.2f}%)"
            )
        rms = calibration.get("residual_rms_s")
        if rms is not None:
            lines.append(
                f"fit residual rms: {rms:.9f} s over "
                f"{calibration.get('n_rows', 0)} rows"
            )
    return "\n".join(lines) + "\n"


def report_json(
    chrome: dict,
    metrics: Optional[dict] = None,
    ledger: Optional[dict] = None,
    combos: Optional[List[str]] = None,
    calibration: Optional[dict] = None,
) -> dict:
    """The machine twin of `render_report`."""
    attr: Attribution = attribute(chrome)
    out = {"attribution": attr.as_dict()}
    if ledger is not None and combos:
        out["measured_vs_predicted"] = reconcile(attr, ledger, combos)
    if metrics:
        out["metrics"] = metrics
    if calibration:
        out["calibration_drift"] = calibration.get("drift_pct", {})
    return out


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="obsreport",
        description=(
            "Unified run report: trace attribution + SLO histograms "
            "+ measured-vs-predicted + calibration drift."
        ),
    )
    parser.add_argument("--trace", default=None,
                        help="Chrome trace JSON (.json or .json.gz)")
    parser.add_argument(
        "--profile-dir", default=None,
        help="scan a --profile-dir capture directory for its newest "
             "trace_epoch*.json (or trace.json(.gz)) instead of --trace",
    )
    parser.add_argument("--metrics", default=None,
                        help="metrics JSON (--metrics-out output)")
    parser.add_argument("--ledger", default=None,
                        help="cost ledger (observability/cost_ledger"
                             ".json) for measured-vs-predicted rows")
    parser.add_argument(
        "--combo", action="append", default=[],
        help="ledger combo name to reconcile against; repeatable",
    )
    parser.add_argument("--calibration", default=None,
                        help="calibration.json for the drift section")
    parser.add_argument("--json", action="store_true",
                        help="emit the JSON twin instead of text")
    parser.add_argument("--out", default=None,
                        help="also write the report to this path")
    parser.add_argument(
        "--pregate", action="store_true",
        help="render the canned golden inputs and byte-compare "
             "against the committed golden report (exit 5 on "
             "mismatch)",
    )
    parser.add_argument(
        "--update-golden", action="store_true",
        help="with --pregate: rewrite the committed golden report "
             "from the canned inputs (commit the diff deliberately)",
    )
    args = parser.parse_args(argv)

    if args.pregate:
        chrome = load_trace(PREGATE_INPUTS["trace"])
        got = render_report(
            chrome,
            metrics=_load_json(PREGATE_INPUTS["metrics"]),
            ledger=_load_json(PREGATE_INPUTS["ledger"]),
            combos=PREGATE_COMBOS,
            calibration=_load_json(PREGATE_INPUTS["calibration"]),
        )
        if args.update_golden:
            with open(PREGATE_INPUTS["golden"], "w") as f:
                f.write(got)
            print(f"[obsreport] wrote {PREGATE_INPUTS['golden']}")
            return 0
        try:
            with open(PREGATE_INPUTS["golden"]) as f:
                want = f.read()
        except OSError as e:
            print(f"[obsreport] cannot read golden: {e}",
                  file=sys.stderr)
            return EXIT_GOLDEN_MISMATCH
        if got != want:
            got_l, want_l = got.splitlines(), want.splitlines()
            for i in range(max(len(got_l), len(want_l))):
                g = got_l[i] if i < len(got_l) else "<missing>"
                w = want_l[i] if i < len(want_l) else "<missing>"
                if g != w:
                    print(
                        f"[obsreport] FAIL golden mismatch at line "
                        f"{i + 1}:\n  want: {w}\n  got:  {g}"
                    )
                    break
            print(json.dumps({"obsreport": {
                "pregate": "fail",
                "golden": PREGATE_INPUTS["golden"],
            }}))
            return EXIT_GOLDEN_MISMATCH
        print(json.dumps({"obsreport": {
            "pregate": "ok", "bytes": len(got),
            "combos": PREGATE_COMBOS,
        }}))
        return 0

    trace_path = args.trace
    if trace_path is None and args.profile_dir:
        hits = profile_dir_traces(args.profile_dir)
        if not hits:
            print(
                f"[obsreport] no trace_epoch*.json or trace.json(.gz) "
                f"under {args.profile_dir}", file=sys.stderr,
            )
            return 2
        trace_path = hits[0]
    if trace_path is None:
        print("[obsreport] --trace or --profile-dir required "
              "(or --pregate)", file=sys.stderr)
        return 2
    try:
        chrome = load_trace(trace_path)
    except (OSError, ValueError) as e:
        print(f"[obsreport] cannot read trace: {e}", file=sys.stderr)
        return 2
    metrics = _load_json(args.metrics) if args.metrics else None
    ledger = _load_json(args.ledger) if args.ledger else None
    calibration = (
        _load_json(args.calibration) if args.calibration else None
    )
    if args.json:
        rendered = json.dumps(report_json(
            chrome, metrics, ledger, args.combo or None, calibration,
        ), indent=1) + "\n"
    else:
        rendered = render_report(
            chrome, metrics, ledger, args.combo or None, calibration,
        )
    sys.stdout.write(rendered)
    if args.out:
        with open(args.out, "w") as f:
            f.write(rendered)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())


__all__ = [
    "EXIT_GOLDEN_MISMATCH",
    "PREGATE_COMBOS",
    "PREGATE_INPUTS",
    "main",
    "render_report",
    "report_json",
]
