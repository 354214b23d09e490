"""plangate: the tuner's regression gate, in costgate's mold (port of
`tuning/plangate.py`; the reference's CLI is `tools/plangate`).

For a pinned grid of mesh x model cells (`grid()`, the reference's 12:
every family the tuner searches, on plain and hybrid fabrics), this
module re-runs the deterministic search and compares the result with
the committed `tuned_plans.json` beside this module, failing, with the
cell named, when:

  * the re-searched argmin picked DIFFERENT knobs than the committed
    plan (the cost landscape under this tree moved: an engine change
    altered what a configuration asks the network for, or a deliberate
    change needs `--update` to re-commit),
  * the argmin's predicted step time drifted past tolerance in EITHER
    direction,
  * a grid cell has no committed plan, or a committed plan's cell left
    the grid,
  * the artifact was searched under other constants.

Exit codes, the reference's: 0 clean; 6 gate failure; 2 usage errors.

Modes mirror costgate's: `--pregate` re-searches only the pre-gate cut
(the tinycnn DDP cell and a hierarchical-MoE cell, seconds) and
name-checks EVERY grid cell against the artifact; `--update`
regenerates (the full grid by default, a subset merge under `--filter`
/ `--pregate`). `gate_check` is a pure function over (artifact,
results). The finalists' steps run on the card (`--device cuda`, the
default); without one the CLI refuses to start unless `--device cpu` is
given.

    python -m distributed_model_parallel_tpu_torch.tuning.plangate \\
        --pregate --device cpu
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from distributed_model_parallel_tpu_torch.tuning.plan import Cell

DEFAULT_PLANS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tuned_plans.json")
PLANS_SCHEMA = "dmpt.tuned_plans.v1"
DEFAULT_TOLERANCE = 0.05

EXIT_GATE_FAILED = 6


def grid() -> List[Cell]:
    """The pinned mesh x model grid (the reference's): both image reducer
    families on hybrid fabrics at two scales and both proxy models, the
    CausalLM-SP reducer plain and hybrid, the hierarchical-MoE fabric at
    two scales, the tp ring cell, the paged-serving cell, the composed-
    plan factorization cell over 8 devices (the argmin is a whole
    ParallelPlan spec), and the scheduled plan cell (model tag "sched":
    the pp2 gpipe / 1f1b / int2 twins at M just above pp)."""
    return [
        Cell("ddp", 4, 2, "mlp"),
        Cell("ddp", 8, 2, "tinycnn"),
        Cell("fsdp", 4, 2, "mlp"),
        Cell("fsdp", 8, 2, "tinycnn"),
        Cell("sp_lm", 2, 1),
        Cell("sp_lm", 4, 2),
        Cell("ep", 4, 2),
        Cell("ep", 8, 2),
        Cell("tp", 4),
        Cell("serve", 2),
        Cell("plan", 8),
        Cell("plan", 8, model="sched"),
    ]


def pregate_cells() -> List[Cell]:
    """The pre-gate cut: the tinycnn DDP cell (the deepest reducer knob
    stack, buckets, overlap segments and wire, on the BN model) and one
    hierarchical-MoE cell, so a drifted argmin fails in seconds with the
    cell named, as the linter's and costgate's pre-gates do."""
    return [
        Cell("ddp", 8, 2, "tinycnn"),
        Cell("ep", 4, 2),
    ]


def load_plans(path: str) -> dict:
    with open(path) as f:
        artifact = json.load(f)
    if artifact.get("schema") != PLANS_SCHEMA or "cells" not in artifact:
        raise ValueError(
            f"{path}: not a tuned-plans artifact (schema "
            f"{PLANS_SCHEMA!r} with a 'cells' object)"
        )
    return artifact


def make_artifact(rows: Dict[str, dict],
                  tolerance: float = DEFAULT_TOLERANCE) -> dict:
    from distributed_model_parallel_tpu_torch.observability.cost import (
        CONSTANTS,
    )

    return {
        "schema": PLANS_SCHEMA,
        "constants": dict(CONSTANTS),
        "tolerance": tolerance,
        "cells": {k: rows[k] for k in sorted(rows)},
    }


def plan_row(plan: dict) -> dict:
    """The per-cell record the artifact commits (the plan minus its
    per-run search diagnostics)."""
    return {
        "knobs": plan["knobs"],
        "combo": plan["combo"],
        "predicted_step_s": plan["predicted"]["predicted_step_s"],
    }


def gate_check(
    artifact: dict,
    results: Dict[str, dict],
    tolerance: Optional[float] = None,
    require_rows_for: Optional[Sequence[str]] = None,
    known_cells: Optional[Sequence[str]] = None,
) -> List[str]:
    """Pure comparison: one failure string per violated contract.
    `results` maps cell name -> plan_row-shaped dict for the cells
    re-searched this run; `require_rows_for` name-checks the rest;
    `known_cells` (the current grid) additionally flags ORPHANED
    artifact rows — a committed baseline for a cell the tree no
    longer searches is as misleading as a missing one."""
    from distributed_model_parallel_tpu_torch.observability.cost import (
        CONSTANTS,
    )

    failures: List[str] = []
    tol = tolerance if tolerance is not None \
        else float(artifact.get("tolerance", DEFAULT_TOLERANCE))
    recorded = artifact.get("constants", {})
    for key, want in CONSTANTS.items():
        got = recorded.get(key)
        if got != want:
            failures.append(
                f"constants drift: artifact has {key}={got!r}, the "
                f"cost engine uses {want!r} — regenerate "
                "(plangate --update)"
            )
    cells = artifact["cells"]
    for name in sorted(results):
        row = cells.get(name)
        got = results[name]
        if row is None:
            failures.append(
                f"{name}: no committed plan — a new grid cell must "
                "commit its tuned baseline (plangate --update)"
            )
            continue
        if got["knobs"] != row["knobs"]:
            drifted = sorted(
                k for k in set(got["knobs"]) | set(row["knobs"])
                if got["knobs"].get(k) != row["knobs"].get(k)
            )
            failures.append(
                f"{name}: re-searched argmin drifted — "
                + ", ".join(
                    f"{k} {row['knobs'].get(k)!r} -> "
                    f"{got['knobs'].get(k)!r}" for k in drifted
                )
                + " (an engine change moved the cost landscape; "
                "re-commit with plangate --update if intended)"
            )
            continue
        base = float(row["predicted_step_s"])
        pred = float(got["predicted_step_s"])
        if base and abs(pred - base) > base * tol:
            failures.append(
                f"{name}: argmin predicted step time drifted "
                f"{base * 1e3:.4f} -> {pred * 1e3:.4f} ms "
                f"({(pred / base - 1.0) * 100:+.1f}%, tolerance "
                f"{tol * 100:.0f}%) — regenerate or investigate"
            )
    if require_rows_for:
        for name in sorted(set(require_rows_for) - set(results)):
            if name not in cells:
                failures.append(
                    f"{name}: no committed plan — a new grid cell "
                    "must commit its tuned baseline "
                    "(plangate --update)"
                )
    if known_cells is not None:
        for name in sorted(set(cells) - set(known_cells)):
            failures.append(
                f"{name}: committed plan for a cell no longer in the "
                "grid — a stale baseline gates nothing; regenerate "
                "the artifact (full plangate --update)"
            )
    return failures


def _search(cells: Sequence[Cell], emit, device: str) -> Dict[str, dict]:
    """Re-search each cell, streaming one partial-JSON line per
    finished cell. A cell whose search fails (a step that does not run,
    or a lint-dirty argmin) records an 'error' row the caller gates
    on."""
    from distributed_model_parallel_tpu_torch.tuning.search import (
        search_cell,
    )

    rows: Dict[str, dict] = {}
    for cell in cells:
        try:
            plan = search_cell(cell, device=device, emit=emit)
        except Exception as e:  # noqa: BLE001 — a failure IS a finding
            emit(f"[plangate] {cell.name}: SEARCH FAILED: {e!r}")
            rows[cell.name] = {"error": repr(e)}
            emit(json.dumps({
                "leg": {"name": cell.name, "error": repr(e)},
                "partial": True,
            }))
            continue
        row = plan_row(plan)
        rows[cell.name] = row
        emit(f"[plangate] {cell.name}: argmin {row['combo']} "
             f"({row['predicted_step_s'] * 1e3:.4f} ms/step)")
        emit(json.dumps({
            "leg": {
                "name": cell.name,
                "combo": row["combo"],
                "predicted_step_s": row["predicted_step_s"],
            },
            "partial": True,
        }))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m distributed_model_parallel_tpu_torch.tuning.plangate",
        description=(
            "Auto-tuner regression gate: re-run the deterministic "
            "knob search for a pinned mesh x model grid and compare "
            "argmin + predicted time against the committed "
            "tuned_plans.json."
        ),
    )
    parser.add_argument(
        "--pregate", action="store_true",
        help="re-search only the pre-gate cells (seconds) and "
             "name-check every grid cell against the artifact",
    )
    parser.add_argument(
        "--filter", default=None,
        help="regex over cell names (e.g. 'ddp.*dcn2')",
    )
    parser.add_argument(
        "--update", action="store_true",
        help="regenerate rows and write the artifact instead of "
             "gating (full rewrite; merges into the existing file "
             "under --filter/--pregate)",
    )
    parser.add_argument("--plans", default=DEFAULT_PLANS)
    parser.add_argument(
        "--tolerance", type=float, default=None,
        help=f"override the artifact's tolerance (default "
             f"{DEFAULT_TOLERANCE})",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the finalists' steps run")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to search on the CPU")

    from distributed_model_parallel_tpu_torch.observability.cost import (
        CONSTANTS,
    )

    full = grid()
    cells = pregate_cells() if args.pregate else full
    if args.filter:
        import re

        cells = [c for c in cells if re.search(args.filter, c.name)]
    if not cells:
        print("[plangate] no cells match", file=sys.stderr)
        return 2

    subset_update = args.update and (args.pregate or args.filter) \
        and os.path.exists(args.plans)
    old = load_plans(args.plans) if subset_update else None
    if old is not None:
        drifted = sorted(
            k for k, v in CONSTANTS.items()
            if old.get("constants", {}).get(k) != v
        )
        if drifted:
            # Same refusal as costgate's: merging would keep the
            # un-searched rows under the OLD physics while stamping
            # the artifact with the current constants.
            print(
                "[plangate] refusing subset --update: the existing "
                f"artifact was searched under different constants "
                f"({', '.join(drifted)}); run a FULL "
                "`plangate --update`",
                file=sys.stderr,
            )
            return 2

    rows = _search(cells, print, args.device)
    errored = sorted(n for n, r in rows.items() if "error" in r)
    rows = {n: r for n, r in rows.items() if "error" not in r}

    if args.update:
        tol = args.tolerance
        if tol is None and old is not None:
            tol = float(old.get("tolerance", DEFAULT_TOLERANCE))
        if tol is None:
            tol = DEFAULT_TOLERANCE
        if old is not None:
            merged = old["cells"]
            merged.update(rows)
            rows = merged
        artifact = make_artifact(rows, tol)
        with open(args.plans, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True)
            f.write("\n")
        print(json.dumps({
            "plangate": {
                "updated": args.plans,
                "cells": len(artifact["cells"]),
                "errors": len(errored),
                "failed_targets": errored,
            }
        }))
        return EXIT_GATE_FAILED if errored else 0

    try:
        artifact = load_plans(args.plans)
    except (OSError, ValueError) as e:
        print(f"[plangate] cannot read plans: {e}", file=sys.stderr)
        return EXIT_GATE_FAILED
    failures = gate_check(
        artifact, rows, args.tolerance,
        require_rows_for=[c.name for c in full] if args.pregate
        else None,
        known_cells=[c.name for c in full],
    )
    failures += [
        f"{name}: SEARCH FAILED (see log above)" for name in errored
    ]
    for f in failures:
        print(f"[plangate] FAIL {f}")
    print(json.dumps({
        "plangate": {
            "plans": args.plans,
            "gated": len(rows),
            "name_checked": len(full) if args.pregate else len(rows),
            "failures": len(failures),
            "failed_targets": sorted(
                {f.split(":", 1)[0] for f in failures}
            ),
        }
    }))
    return EXIT_GATE_FAILED if failures else 0


if __name__ == "__main__":
    sys.exit(main())
