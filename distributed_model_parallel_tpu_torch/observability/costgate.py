"""costgate: the perf-regression gate over the lint matrix (port of
`observability/costgate.py`; the reference's CLI is `tools/costgate`).

For each engine x mode combo of the linter's matrix (`analysis/lint.
full_matrix`), the cost engine prices the collectives that one rank of
the combo really issues in one step (`observability/cost.combo_cost`);
this module compares those predictions with the committed ledger
(`cost_ledger.json` beside this module) and fails, naming the combo,
when:

  * a combo's predicted step time worsens beyond tolerance against its
    ledger row (a regression in what the program asks the network for),
  * a combo of the matrix has NO ledger row (a new combo shipped without
    its cost baseline),
  * the ledger was priced under other constants (regenerate).

Exit codes, the reference's: 0 clean; 4 gate failure; 2 usage errors.

Modes:
  --pregate   record only the pre-gate cut (`pregate_matrix`, seconds)
              and name-check EVERY full-matrix combo against the ledger
  --update    regenerate rows and (re)write the ledger: the full matrix
              by default, or a merge of the --filter / --pregate subset
              into the existing file

One partial-JSON line streams out a finished combo, then a summary
object. `gate_check` is a pure function over (ledger, predictions).

The engines compute on the card (`--device cuda`, the default); without
one the CLI refuses to start unless `--device cpu` is given. A combo's
records depend on its shapes and mesh alone, so both devices write the
same rows, and `--update` run twice writes the same bytes.

    python -m distributed_model_parallel_tpu_torch.observability.costgate \\
        --pregate --device cpu
    python -m distributed_model_parallel_tpu_torch.observability.costgate \\
        --update --device cpu
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from distributed_model_parallel_tpu_torch.observability.cost import (
    COMPUTE_CONSTANTS,
    CONSTANTS,
)

# Every ledger-recorded constant the drift guard compares: the fabric
# set and the compute roofline set.
_ALL_CONSTANTS = {**CONSTANTS, **COMPUTE_CONSTANTS}

DEFAULT_LEDGER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "cost_ledger.json")
DEFAULT_TOLERANCE = 0.05  # 5% predicted-step-time headroom

EXIT_GATE_FAILED = 4


def load_ledger(path: str) -> dict:
    with open(path) as f:
        ledger = json.load(f)
    if "combos" not in ledger:
        raise ValueError(
            f"{path}: not a cost ledger (no 'combos' key)"
        )
    return ledger


def make_ledger(rows: Dict[str, dict],
                tolerance: float = DEFAULT_TOLERANCE) -> dict:
    return {
        "constants": dict(_ALL_CONSTANTS),
        "tolerance": tolerance,
        "combos": {k: rows[k] for k in sorted(rows)},
    }


def gate_check(
    ledger: dict,
    predictions: Dict[str, dict],
    tolerance: Optional[float] = None,
    require_rows_for: Optional[Sequence[str]] = None,
) -> List[str]:
    """Pure comparison: one failure string per violated contract.

    `predictions` maps combo name -> row (at least `predicted_step_s`);
    `require_rows_for` additionally name-checks combos that were NOT
    recorded this run (the pre-gate's full-matrix coverage check)."""
    failures: List[str] = []
    tol = tolerance if tolerance is not None \
        else float(ledger.get("tolerance", DEFAULT_TOLERANCE))
    recorded = ledger.get("constants", {})
    for key, want in _ALL_CONSTANTS.items():
        got = recorded.get(key)
        if got != want:
            failures.append(
                f"constants drift: ledger has {key}={got!r}, the cost "
                f"engine uses {want!r} — regenerate the ledger "
                "(costgate --update)"
            )
    combos = ledger["combos"]
    for name in sorted(predictions):
        row = combos.get(name)
        pred = float(predictions[name]["predicted_step_s"])
        if row is None:
            failures.append(
                f"{name}: no ledger row — a new engine x mode combo "
                "must commit its cost baseline "
                "(costgate --update)"
            )
            continue
        base = float(row["predicted_step_s"])
        if pred > base * (1.0 + tol):
            failures.append(
                f"{name}: predicted step time regressed "
                f"{base * 1e3:.4f} -> {pred * 1e3:.4f} ms "
                f"(+{(pred / base - 1.0) * 100:.1f}%, tolerance "
                f"{tol * 100:.0f}%)"
            )
    if require_rows_for:
        for name in sorted(set(require_rows_for) - set(predictions)):
            if name not in combos:
                failures.append(
                    f"{name}: no ledger row — a new engine x mode "
                    "combo must commit its cost baseline "
                    "(costgate --update)"
                )
    return failures


def _predict(combos, emit, device: str) -> Dict[str, dict]:
    """Record + price each combo, streaming one partial line per combo.
    A combo that fails to run is itself a gate failure (recorded as a
    row with an 'error' key; the caller fails on it)."""
    from distributed_model_parallel_tpu_torch.observability.cost import (
        combo_cost,
    )

    rows: Dict[str, dict] = {}
    for combo in combos:
        try:
            row = combo_cost(combo, device)
        except Exception as e:  # noqa: BLE001 — a failure IS a finding
            emit(f"[costgate] {combo.name}: RUN FAILED: {e!r}")
            rows[combo.name] = {"error": repr(e)}
            emit(json.dumps({
                "leg": {"name": combo.name, "error": repr(e)},
                "partial": True,
            }))
            continue
        rows[combo.name] = row
        emit(f"[costgate] {combo.name}: predicted "
             f"{row['predicted_step_s'] * 1e3:.4f} ms/step "
             f"({row['n_collectives']} collectives)")
        emit(json.dumps({
            "leg": {
                "name": combo.name,
                "predicted_step_s": row["predicted_step_s"],
                "n_collectives": row["n_collectives"],
            },
            "partial": True,
        }))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m distributed_model_parallel_tpu_torch.observability."
             "costgate",
        description=(
            "Perf-regression gate: predict each combo's comm time a step "
            "over the linter's matrix (alpha-beta cost engine over the "
            "recorded collectives) and compare against the committed "
            "ledger."
        ),
    )
    parser.add_argument(
        "--pregate", action="store_true",
        help="record only the pre-gate combos (seconds) and "
             "name-check every full-matrix combo against the ledger",
    )
    parser.add_argument(
        "--filter", default=None,
        help="regex over combo names (e.g. 'ddp.*dcn')",
    )
    parser.add_argument(
        "--update", action="store_true",
        help="regenerate rows and write the ledger instead of gating "
             "(full rewrite; merges into the existing file under "
             "--filter/--pregate)",
    )
    parser.add_argument("--ledger", default=DEFAULT_LEDGER)
    parser.add_argument(
        "--tolerance", type=float, default=None,
        help=f"override the ledger's tolerance (default "
             f"{DEFAULT_TOLERANCE})",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the engines compute")
    parser.add_argument(
        "--calibration", default=None, metavar="JSON",
        help="report the drift between the fitted constants in this "
             "calibration.json (observability/calibrate.py) and the "
             "committed constants (reported, not gated: the gate stays "
             "a structural check on the recorded program)",
    )
    args = parser.parse_args(argv)

    calibration_drift = None
    if args.calibration:
        from distributed_model_parallel_tpu_torch.observability.calibrate import (  # noqa: E501
            drift_report,
        )
        from distributed_model_parallel_tpu_torch.observability.cost import (
            load_calibration,
        )

        try:
            fitted = load_calibration(args.calibration)
        except (OSError, ValueError) as e:
            print(f"[costgate] cannot read calibration: {e}",
                  file=sys.stderr)
            return 2
        calibration_drift = drift_report(fitted)
        for key, pct in calibration_drift.items():
            print(f"[costgate] calibration drift (reported, not gated): "
                  f"{key} committed {CONSTANTS[key]:g} -> "
                  f"fitted {fitted[key]:g} ({pct:+.1f}%)")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to price on the CPU")

    from distributed_model_parallel_tpu_torch.analysis.lint import (
        full_matrix,
        pregate_matrix,
    )

    matrix = full_matrix()
    combos = pregate_matrix() if args.pregate else matrix
    if args.filter:
        import re

        combos = [c for c in combos if re.search(args.filter, c.name)]
    if not combos:
        print("[costgate] no combos match", file=sys.stderr)
        return 2
    # full_matrix may repeat a name (the pre-gate twins); dedupe.
    seen = set()
    combos = [
        c for c in combos
        if not (c.name in seen or seen.add(c.name))
    ]

    subset_update = args.update and (args.pregate or args.filter) \
        and os.path.exists(args.ledger)
    old = load_ledger(args.ledger) if subset_update else None
    if old is not None:
        drifted = sorted(
            k for k, v in _ALL_CONSTANTS.items()
            if old.get("constants", {}).get(k) != v
        )
        if drifted:
            # Merging would keep the unrecorded rows at the OLD
            # constants while stamping the ledger with the current
            # ones, defeating the drift guard: a constants change
            # reprices every row. Checked before any recording.
            print(
                "[costgate] refusing subset --update: the existing "
                f"ledger was priced under different constants "
                f"({', '.join(drifted)}); run a FULL "
                "`costgate --update` to reprice every combo",
                file=sys.stderr,
            )
            return 2

    rows = _predict(combos, print, args.device)
    errored = sorted(n for n, r in rows.items() if "error" in r)
    rows = {n: r for n, r in rows.items() if "error" not in r}

    if args.update:
        # Tolerance precedence: explicit flag > the merged-into
        # ledger's committed value > the default — a subset merge must
        # not silently reset a deliberately committed tolerance.
        tol = args.tolerance
        if tol is None and old is not None:
            tol = float(old.get("tolerance", DEFAULT_TOLERANCE))
        if tol is None:
            tol = DEFAULT_TOLERANCE
        if old is not None:
            merged = old["combos"]
            merged.update(rows)
            rows = merged
        ledger = make_ledger(rows, tol)
        with open(args.ledger, "w") as f:
            json.dump(ledger, f, indent=1)
            f.write("\n")
        print(json.dumps({
            "costgate": {
                "updated": args.ledger,
                "combos": len(ledger["combos"]),
                "errors": len(errored),
                "failed_targets": errored,
            }
        }))
        return EXIT_GATE_FAILED if errored else 0

    try:
        ledger = load_ledger(args.ledger)
    except (OSError, ValueError) as e:
        print(f"[costgate] cannot read ledger: {e}", file=sys.stderr)
        return EXIT_GATE_FAILED
    failures = gate_check(
        ledger, rows, args.tolerance,
        require_rows_for=[c.name for c in matrix] if args.pregate
        else None,
    )
    failures += [
        f"{name}: RUN FAILED (see log above)" for name in errored
    ]
    for f in failures:
        print(f"[costgate] FAIL {f}")
    summary = {
        "ledger": args.ledger,
        "gated": len(rows),
        "name_checked": len(matrix) if args.pregate else len(rows),
        "failures": len(failures),
        "failed_targets": sorted(
            {f.split(":", 1)[0] for f in failures}
        ),
    }
    if calibration_drift is not None:
        summary["calibration_drift_pct"] = calibration_drift
    print(json.dumps({"costgate": summary}))
    return EXIT_GATE_FAILED if failures else 0


if __name__ == "__main__":
    sys.exit(main())
