"""Fit the alpha-beta fabric constants from measured rows (port of
`observability/calibrate.py`).

`cost.py`'s fabric constants are datasheet bandwidths and latency
priors; every prediction in the ledger inherits them. This module closes
the loop: given measured rows (a benchmark's reducer / MoE / collective-
matmul legs, or any caller-built rows), it solves the linear system

    t_row = sum_f  alpha_f * hops_f(row)  +  wire_bytes_f(row) / bw_f

for (alpha_ici, bw_ici, alpha_dcn, bw_dcn) by least squares, writes a
versioned calibration file (`dmpt.calibration.v1`, the reference's
schema) that `cost.load_calibration` hands back in place of the
committed constants, and reports the drift against them (costgate's
`--calibration` prints it).

The per-leg FEATURES (hop counts and wire bytes a fabric) are the exact
linear decompositions of `cost.py`'s closed forms: `features_to_seconds`
under a constants set equals the closed form under it. Each table also
gets a per-source intercept column (the constant compute share of its
timed leg), so the fit does not take FFN time for alpha.

`rows_from_bench` reads the reference's table layout
(`reducer_microbench`, `moe_microbench`, `collective_matmul_microbench`,
`grad_mb`, `n_buckets`, `dispatch_payload_mb`, `shapes`) from a JSON the
caller passes. numpy only.

    python -m distributed_model_parallel_tpu_torch.observability.calibrate \\
        --bench legs.json [--bench more.json] [--out calibration.json]
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

from distributed_model_parallel_tpu_torch.observability.cost import (
    CONSTANTS,
    WIRE_ITEMSIZE,
)

CALIBRATION_VERSION = "dmpt.calibration.v1"
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "calibration.json")

#: Fit-constant order: (fabric, kind) -> CONSTANTS key.
_PARAM_KEYS = (
    ("ici", "alpha", "alpha_hop_s"),
    ("ici", "bw", "bw_ici_effective_bytes_per_s"),
    ("dcn", "alpha", "alpha_dcn_hop_s"),
    ("dcn", "bw", "bw_dcn_effective_bytes_per_s"),
)


@dataclasses.dataclass
class CalibrationRow:
    """One measured leg: per-fabric hop counts + wire bytes and the
    measured seconds. `source` groups rows that share an additive
    compute intercept (one per bench table)."""

    name: str
    measured_s: float
    hops: Dict[str, float]        # fabric -> latency hops
    wire_bytes: Dict[str, float]  # fabric -> bytes traversing the wire
    source: str = "rows"


# ---------------------------------------------- closed-form features
#
# Linear decompositions of cost.py's composition helpers: seconds ==
# hops_f * alpha_f + wire_bytes_f / bw_f summed over fabrics (pinned
# against the closed forms in tests/test_torch_port_cost.py).


def ring_all_reduce_features(nbytes: float, size: int,
                             n_ops: int = 1) -> CalibrationRow:
    """§3a flat ring all-reduce (cost.ring_all_reduce_s)."""
    if size <= 1:
        return CalibrationRow("ring", 0.0, {}, {})
    return CalibrationRow(
        name=f"ring/S{size}",
        measured_s=0.0,
        hops={"ici": n_ops * 2 * (size - 1)},
        wire_bytes={"ici": 2 * (size - 1) / size * nbytes},
    )


def two_level_features(nbytes: float, ici: int, dcn: int,
                       n_buckets: int = 1,
                       wire: str = "none") -> CalibrationRow:
    """§3b hierarchical bucketed reduction
    (cost.two_level_all_reduce_s)."""
    wb = WIRE_ITEMSIZE[wire]
    sidecar = 1 if wire == "int8" else 0
    hops = {"ici": n_buckets * 2 * (ici - 1),
            "dcn": n_buckets * (1 + sidecar) * 2 * (dcn - 1)}
    wire_bytes = {"ici": 2 * (ici - 1) / ici * nbytes}
    if dcn > 1:
        wire_bytes["dcn"] = (
            2 * (dcn - 1) / dcn * (nbytes / ici) * (wb / 4)
        )
    return CalibrationRow(
        name=f"two_level/{dcn}x{ici}/wire-{wire}",
        measured_s=0.0, hops=hops, wire_bytes=wire_bytes,
    )


def flat_all_to_all_features(elems: float, itemsize: int, ici: int,
                             dcn: int) -> CalibrationRow:
    """§3c flat token exchange (cost.flat_all_to_all_s)."""
    x = elems * itemsize
    n = ici * dcn
    return CalibrationRow(
        name=f"flat_a2a/{dcn}x{ici}",
        measured_s=0.0,
        hops={"ici": ici - 1, "dcn": (dcn - 1) * ici},
        wire_bytes={"ici": (ici - 1) / n * x,
                    "dcn": (dcn - 1) / dcn * x},
    )


def hierarchical_all_to_all_features(
    elems: float, itemsize: int, ici: int, dcn: int,
    wire: Optional[str] = None,
) -> CalibrationRow:
    """§3c' two-level token exchange
    (cost.hierarchical_all_to_all_s)."""
    x = elems * itemsize
    dcn_itemsize = itemsize if wire in (None, "none") \
        else WIRE_ITEMSIZE[wire]
    return CalibrationRow(
        name=f"hier_a2a/{dcn}x{ici}/wire-{wire or 'none'}",
        measured_s=0.0,
        hops={"ici": ici - 1, "dcn": dcn - 1},
        wire_bytes={"ici": (ici - 1) / ici * x,
                    "dcn": (dcn - 1) / dcn * elems * dcn_itemsize},
    )


def features_to_seconds(row: CalibrationRow,
                        constants: Dict[str, float]) -> float:
    """Evaluate a feature row under explicit constants — the quantity
    the tests pin equal to cost.py's closed forms."""
    alpha = {"ici": constants["alpha_hop_s"],
             "dcn": constants["alpha_dcn_hop_s"]}
    bw = {"ici": constants["bw_ici_effective_bytes_per_s"],
          "dcn": constants["bw_dcn_effective_bytes_per_s"]}
    t = 0.0
    for f, h in row.hops.items():
        t += h * alpha[f]
    for f, b in row.wire_bytes.items():
        t += b / bw[f]
    return t


# ------------------------------------------------- bench row builders


def rows_from_bench(bench: dict) -> List[CalibrationRow]:
    """Measured rows out of a benchmark's JSON (the reducer / moe / cm
    tables, whichever are present, also found nested under a 'parsed'
    key). Each table's rows share shapes
    recorded beside it, so the features are fully determined."""
    if "parsed" in bench and isinstance(bench["parsed"], dict):
        bench = bench["parsed"]
    rows: List[CalibrationRow] = []
    grad_mb = float(bench.get("grad_mb", 0.0))
    n_buckets = int(bench.get("n_buckets", 1))
    for leg in bench.get("reducer_microbench", []):
        if "hierarchical_ms" not in leg:
            continue
        size = int(leg["axis_size"])
        if size < 2:
            continue
        r = two_level_features(
            grad_mb * 1e6, ici=size // 2, dcn=2,
            n_buckets=n_buckets,
            wire=leg.get("wire", "f32"),  # "f32" == "none" on the wire
        )
        r.name = f"reducer/S{size}/wire-{leg.get('wire', 'f32')}"
        r.measured_s = float(leg["hierarchical_ms"]) / 1e3
        r.source = "reducer"
        rows.append(r)
    payload_mb = float(bench.get("dispatch_payload_mb", 0.0))
    for leg in bench.get("moe_microbench", []):
        if "hierarchical_ms" not in leg:
            continue
        size = int(leg["axis_size"])
        if size < 2:
            continue
        wire = leg.get("wire", "f32")
        one_way = hierarchical_all_to_all_features(
            payload_mb * 1e6 / 4, 4, ici=size // 2, dcn=2,
            wire=None if wire == "f32" else wire,
        )
        # The timed leg is exchange + FFN + return: double the one-way
        # features; the FFN share lands in the per-source intercept.
        r = CalibrationRow(
            name=f"moe/S{size}/wire-{wire}",
            measured_s=float(leg["hierarchical_ms"]) / 1e3,
            hops={f: 2 * h for f, h in one_way.hops.items()},
            wire_bytes={
                f: 2 * b for f, b in one_way.wire_bytes.items()
            },
            source="moe",
        )
        rows.append(r)
    shapes = bench.get("shapes", {})
    for leg in bench.get("collective_matmul_microbench", []):
        if "fwd_overlapped_ms" not in leg or not shapes:
            continue
        size = int(leg["axis_size"])
        bx = (shapes["batch"] * shapes["seq_per_shard"] * size
              * shapes["d_model"] * 4)
        bh = (shapes["batch"] * shapes["seq_per_shard"] * size
              * shapes["d_ff"] * 4)
        rows.append(CalibrationRow(
            name=f"cm/S{size}",
            measured_s=float(leg["fwd_overlapped_ms"]) / 1e3,
            hops={"ici": 2 * (size - 1)},  # ag ring + rs ring
            wire_bytes={"ici": (size - 1) / size * (bx + bh)},
            source="cm",
        ))
    return rows


# --------------------------------------------------------------- fit


def fit_constants(rows: Sequence[CalibrationRow]) -> dict:
    """Least-squares fit of the four fabric constants (+ one compute
    intercept per row source). Returns {"constants": {...},
    "intercepts_s": {...}, "residual_rms_s": ..., "n_rows": ...};
    raises ValueError when the rows cannot identify the parameters
    (fewer rows than unknowns, or a fabric no row touches)."""
    import numpy as np

    rows = list(rows)
    touched = {f for r in rows for f in (*r.hops, *r.wire_bytes)}
    params = [
        (f, kind, key) for f, kind, key in _PARAM_KEYS if f in touched
    ]
    sources = sorted({r.source for r in rows})
    n_cols = len(params) + len(sources)
    if len(rows) < n_cols:
        raise ValueError(
            f"{len(rows)} measured rows cannot identify {n_cols} "
            "parameters (4 fabric constants + one intercept per "
            "source) — add more microbench legs"
        )
    a = np.zeros((len(rows), n_cols))
    b = np.array([r.measured_s for r in rows])
    for i, r in enumerate(rows):
        for j, (f, kind, _key) in enumerate(params):
            a[i, j] = (
                r.hops.get(f, 0.0) if kind == "alpha"
                else r.wire_bytes.get(f, 0.0)
            )
        a[i, len(params) + sources.index(r.source)] = 1.0
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    constants: Dict[str, float] = {}
    for j, (_f, kind, key) in enumerate(params):
        v = float(sol[j])
        if kind == "bw":
            # The design matrix carries 1/bw; a non-positive solve
            # means the rows cannot see that fabric's bandwidth —
            # report infinity-free by falling back to the committed
            # value and letting the drift report say "unidentified".
            constants[key] = (1.0 / v) if v > 0 else CONSTANTS[key]
        else:
            constants[key] = max(v, 0.0)
    for key, committed in CONSTANTS.items():
        constants.setdefault(key, committed)
    resid = a @ sol - b
    return {
        "constants": constants,
        "intercepts_s": {
            s: float(sol[len(params) + i])
            for i, s in enumerate(sources)
        },
        "residual_rms_s": float(np.sqrt(np.mean(resid ** 2))),
        "n_rows": len(rows),
    }


def drift_report(fitted: Dict[str, float],
                 committed: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
    """Percent drift of each fitted constant vs the committed one."""
    committed = committed if committed is not None else CONSTANTS
    return {
        k: round((fitted[k] - committed[k]) / committed[k] * 100.0, 2)
        for k in sorted(committed)
        if k in fitted and committed[k]
    }


def calibration_payload(fit: dict, note: str = "",
                        fitted_from: Optional[dict] = None) -> dict:
    """The versioned calibration artifact."""
    return {
        "version": CALIBRATION_VERSION,
        "constants": {
            k: fit["constants"][k] for k in sorted(fit["constants"])
        },
        "committed_constants": dict(CONSTANTS),
        "drift_pct": drift_report(fit["constants"]),
        "intercepts_s": fit["intercepts_s"],
        "residual_rms_s": fit["residual_rms_s"],
        "n_rows": fit["n_rows"],
        "fitted_from": fitted_from or {},
        "note": note,
    }


def write_calibration(path: str, payload: dict) -> str:
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


# --------------------------------------------------------------- CLI


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m distributed_model_parallel_tpu_torch.observability.calibrate",
        description=(
            "Fit the alpha-beta fabric constants from measured benchmark "
            "rows and write a versioned calibration.json."
        ),
    )
    parser.add_argument(
        "--bench", action="append", default=[], metavar="JSON",
        help="a benchmark's JSON to pull reducer / moe / cm legs from "
             "(the reference's table layout); repeatable",
    )
    parser.add_argument(
        "--out", default=DEFAULT_OUT,
        help="where the calibration file goes (default: beside this "
             "module)",
    )
    parser.add_argument("--note", default="")
    args = parser.parse_args(argv)
    rows: List[CalibrationRow] = []
    for path in args.bench:
        with open(path) as f:
            rows += rows_from_bench(json.load(f))
    if not rows:
        print("[calibrate] no measured rows found", file=sys.stderr)
        return 2
    try:
        fit = fit_constants(rows)
    except ValueError as e:
        print(f"[calibrate] {e}", file=sys.stderr)
        return 2
    payload = calibration_payload(
        fit, note=args.note,
        fitted_from={"bench": [os.path.basename(p)
                               for p in args.bench]},
    )
    write_calibration(args.out, payload)
    for k, pct in payload["drift_pct"].items():
        print(f"[calibrate] {k}: committed {CONSTANTS[k]:g} -> "
              f"fitted {payload['constants'][k]:g} ({pct:+.1f}%)")
    print(json.dumps({"calibrate": {
        "out": args.out, "n_rows": fit["n_rows"],
        "residual_rms_s": round(fit["residual_rms_s"], 9),
    }}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())


__all__ = [
    "CALIBRATION_VERSION",
    "CalibrationRow",
    "calibration_payload",
    "drift_report",
    "features_to_seconds",
    "fit_constants",
    "flat_all_to_all_features",
    "hierarchical_all_to_all_features",
    "main",
    "ring_all_reduce_features",
    "rows_from_bench",
    "two_level_features",
    "write_calibration",
]
