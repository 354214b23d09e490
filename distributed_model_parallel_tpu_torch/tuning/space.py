"""The declarative search space (port of `tuning/space.py`): which knobs
exist a family, which values each may take, and which CLI flag and
engine field each drives.

Every `Knob` names its real surfaces (`cli_flag`, `engine_param`), and
`scan_knob_surface` checks the port's own sources for them: a knob that
no CLI or engine of the port accepts would be a plan nobody can apply.

`candidates(family, dcn)` expands the cross-product, drops what the
engines refuse (wire compression without a 'dcn' axis, overlap chunking
without the hierarchical dispatch, ...), sets inapplicable knobs to None
so equivalent configurations dedupe, and returns the list in a
deterministic order, which is part of the search's byte-stability
contract. The grids and the order are the reference's, value for value.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
from typing import Dict, List, Optional, Tuple

# Engine families the tuner knows how to search. They are the lint
# matrix's combo vocabulary (`analysis/lint.py` builders), which is
# what makes "price a candidate" a one-liner: every candidate maps to
# a Combo the shared lowering path already understands.
FAMILIES = ("ddp", "fsdp", "sp_lm", "ep", "tp", "serve", "plan")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable dimension: its value grid and its REAL surfaces."""

    name: str            # canonical key in a plan's "knobs" object
    values: tuple        # the enumerable grid
    cli_flag: str        # the training-CLI flag that sets it
    engine_param: str    # the engine dataclass field it lands on


# Bucket grid: 25 is the DDP Reducer's default cap; the sub-MB values
# matter twice — small real models, and the tiny lint proxies whose
# whole gradient fits one 0.1 MB bucket (a grid that never splits the
# proxy would make bucket_mb a phantom knob on every searched cell).
_BUCKET_GRID = (0.02, 0.1, 1.0, 25.0)

_REDUCER_KNOBS = (
    Knob("grad_reduction", ("monolithic", "bucketed", "overlapped"),
         "--grad-reduction", "grad_reduction"),
    Knob("bucket_mb", _BUCKET_GRID, "--bucket-mb", "bucket_mb"),
    # 0 = the engines' auto default (min(4, blocks)).
    Knob("overlap_stages", (0, 2), "--overlap-stages",
         "overlap_stages"),
    Knob("dcn_compression", ("none", "bf16", "int8"),
         "--dcn-compression", "dcn_compression"),
)

_CM_KNOB = Knob("collective_matmul", (False, True),
                "--collective-matmul", "collective_matmul")


# --------------------------------------------- the composed-plan family
#
# The "plan" family searches WHOLE mesh factorizations, not per-engine
# schedule knobs: each grid value is a ParallelPlan spec string
# ("pp2xsp2xdp2", "fsdp8", ...) that `build_plan_engine` runs directly.
# This module carries its own mirror of `parallel/plan.py`'s token
# grammar; tests/test_torch_port_tuning.py holds `plan_spec_axes`
# against `parse_plan` on the whole grid.

_PLAN_TOKEN_RE = re.compile(
    r"^(pp|sp|tp|dp|fsdp|ep)(\d+)(?:-(1f1b|int(\d+)))?$"
)

_PLAN_TOKEN_AXIS = {
    "pp": "pp", "sp": "sp", "tp": "sp", "dp": "dp", "fsdp": "dp",
    "ep": "ep",
}


def plan_spec_axes(spec: str) -> dict:
    """Parse of a plan spec string into
    {"pp", "sp", "dp", "ep", "fsdp", "schedule", "virtual"} — the same
    grammar as `parallel.plan.parse_plan` (tokens
    `(pp|sp|tp|dp|fsdp|ep)<n>` joined by 'x', duplicate axes rejected;
    the `-1f1b` / `-int<V>` schedule suffix rides the pp token
    only)."""
    axes = {"pp": 1, "sp": 1, "dp": 1, "ep": 1, "fsdp": False,
            "schedule": "gpipe", "virtual": 1}
    seen = set()
    for tok in spec.split("x"):
        tok = tok.strip().rstrip("-")
        m = _PLAN_TOKEN_RE.match(tok)
        if not m:
            raise ValueError(
                f"bad plan token {tok!r} in {spec!r} (want "
                "(pp|sp|tp|dp|fsdp|ep)<n>[-1f1b|-int<V>] joined by "
                "'x')"
            )
        field = _PLAN_TOKEN_AXIS[m.group(1)]
        if field in seen:
            raise ValueError(f"duplicate axis {field!r} in {spec!r}")
        seen.add(field)
        axes[field] = int(m.group(2))
        if m.group(1) == "fsdp":
            axes["fsdp"] = True
        if m.group(3):
            if m.group(1) != "pp":
                raise ValueError(
                    f"schedule suffix on non-pp token {tok!r} in "
                    f"{spec!r} (ParallelPlan.schedule rides the pp "
                    "token)"
                )
            if m.group(3) == "1f1b":
                axes["schedule"] = "1f1b"
            else:
                v = int(m.group(4))
                if v < 2:
                    raise ValueError(
                        f"int{v} in {spec!r}: V=1 interleaving IS "
                        "1f1b — spell it pp<S>-1f1b"
                    )
                axes["schedule"] = "interleaved"
                axes["virtual"] = v
    return axes


def _plan_spec(pp: int, sp: int, dp: int, fsdp: bool,
               schedule: str = "gpipe", virtual: int = 1) -> str:
    """Spec-string builder matching `ParallelPlan.spec` byte-for-byte:
    only non-1 axes are emitted, in order pp, sp, dp-or-fsdp (the dp
    bit also appears when it is the ONLY axis); the schedule suffix
    rides the pp bit."""
    bits = []
    if pp > 1:
        sched = {"gpipe": "", "1f1b": "-1f1b",
                 "interleaved": f"-int{virtual}"}[schedule]
        bits.append(f"pp{pp}{sched}")
    if sp > 1:
        bits.append(f"sp{sp}")
    if dp > 1 or not bits:
        bits.append(("fsdp" if fsdp else "dp") + str(dp))
    return "x".join(bits)


def plan_specs(total: int) -> tuple:
    """All power-of-2 (pp, sp, dp) factorizations of `total` devices,
    each dp>1 point twinned with its fsdp variant, and each pp>1 point
    twinned with its 1f1b and int2 scheduled variants (the
    gpipe plan stays a point in the scheduled space). Deterministic
    order (pp outer, sp inner, dense before fsdp, gpipe before 1f1b
    before int2) — the enumeration order is part of the byte-stability
    contract."""
    sizes = []
    w = 1
    while w <= total:
        sizes.append(w)
        w *= 2
    if sizes[-1] != total:
        raise ValueError(f"plan grid wants a power-of-2 size, got {total}")
    out = []
    for pp in sizes:
        for sp in sizes:
            if total % (pp * sp):
                continue
            dp = total // (pp * sp)
            schedules = [("gpipe", 1)]
            if pp > 1:
                schedules += [("1f1b", 1), ("interleaved", 2)]
            for sched, v in schedules:
                out.append(_plan_spec(pp, sp, dp, False, sched, v))
                if dp > 1:
                    out.append(_plan_spec(pp, sp, dp, True, sched, v))
    return tuple(out)


# The searched grid: the reference's two mesh sizes, 8 devices
# (plangate's plan/S8 cell) and a 64-way scaling study, and before them
# the worlds of 2 and 4 ranks that one host's cards give `cli.lm --plan
# auto` (the reference's grid has no 2- or 4-device point, so its search
# finds no candidate there). Each size's specs keep the reference's
# order, and `candidates` filters the grid to the cell's size.
_PLAN_GRID = plan_specs(2) + plan_specs(4) + plan_specs(8) + plan_specs(64)


def scheduled_plan_candidates(total: int) -> List[dict]:
    """The plangate sched cell's scoped space (plan/S<n>/sched): the
    pp2 gpipe / 1f1b / int2 twins at num_microbatches=4, M just above
    pp, the first point where a scheduled plan's smaller bubble can beat
    its gpipe twin's shorter tick program. All three are recorded (3 <=
    DEFAULT_FINALISTS), so the pinned argmin is decided at the recorded
    tier, not the closed form."""
    if total % 2:
        raise ValueError(
            f"sched cell wants an even device count, got {total}"
        )
    dp = total // 2
    return [
        {"plan": _plan_spec(2, 1, dp, False, sched, v),
         "num_microbatches": 4}
        for sched, v in (
            ("gpipe", 1), ("1f1b", 1), ("interleaved", 2),
        )
    ]

SPACES: Dict[str, Tuple[Knob, ...]] = {
    "ddp": _REDUCER_KNOBS,
    "fsdp": _REDUCER_KNOBS,
    "sp_lm": _REDUCER_KNOBS + (_CM_KNOB,),
    "ep": (
        Knob("dispatch", ("gspmd", "hierarchical"), "--moe-dispatch",
             "dispatch"),
        Knob("overlap", (False, True), "--moe-overlap", "overlap"),
        Knob("dcn_compression", ("none", "bf16", "int8"),
             "--dcn-compression", "dcn_compression"),
    ),
    "tp": (_CM_KNOB,),
    # Serving (the paged KV cache): page size
    # trades per-token page WRITE-BACK bytes (the decode step rewrites
    # one whole page per slot per step) against page-allocation
    # launches over the sequence lifetime; prefill chunk trades
    # per-chunk launches against padded prompt compute. Priced by the
    # cost engine's closed form (`search.serve_closed_form_s`); the
    # engine lives under serving/ (`scan_knob_surface` scans it
    # alongside parallel/). Values sized to divide the lint serve
    # proxy's 16-position cache — the same proxy-fits-the-grid
    # compromise as _BUCKET_GRID's sub-MB values.
    # compute_dtype: the decode projection GEMM arithmetic
    # (`ops/quant_matmul.py`), priced by the MXU/HBM roofline closed
    # form (`cost.serve_decode_compute_s`).
    # speculative_k (`serving/speculative.py`): draft
    # lookahead depth — 0 is plain decode; k >= 1 trades k draft steps
    # (at DRAFT_COST_RATIO of a target step) for one k+1-wide verify
    # step whose weight stream costs the same as ONE decode step,
    # amortized over the expected accepted tokens
    # (`cost.serve_speculative_request_s`). Every serve grid point is
    # paged, so the rollback-by-block-table requirement always holds.
    "serve": (
        Knob("page_size", (4, 8, 16), "--page-size", "page_size"),
        Knob("prefill_chunk", (4, 8, 16), "--prefill-chunk",
             "prefill_chunk"),
        Knob("compute_dtype", ("f32", "bf16", "int8"),
             "--compute-dtype", "compute_dtype"),
        Knob("speculative_k", (0, 2, 4), "--speculative-k",
             "speculative_k"),
    ),
    # Composed mesh-axis plans: one spec-string knob whose
    # grid IS the factorization space — including the
    # schedule suffixes (pp<S>-1f1b / pp<S>-int<V>), so the tuner
    # trades bubble against wire hops inside ONE family. The engine
    # field is `ComposedPlanEngine.plan`; the CLI flag is the training
    # CLIs' `--plan`. num_microbatches sizes the pipeline fill (0 =
    # the engine default M = pp*V); M just above pp is where a
    # scheduled plan first beats its gpipe twin. Candidate filtering
    # (device count, DCN slice boundaries, M bounds) happens in
    # `_canonicalize` against the cell's mesh.
    "plan": (
        Knob("plan", _PLAN_GRID, "--plan", "plan"),
        Knob("num_microbatches", (0, 4), "--microbatches",
             "num_microbatches"),
    ),
}


def canonical_key(knobs: dict) -> str:
    """The deterministic identity of one candidate (sort/tie-break and
    dedupe key)."""
    return json.dumps(knobs, sort_keys=True)


def _canonicalize(family: str, knobs: dict, dcn: int,
                  size: Optional[int] = None) -> Optional[dict]:
    """Normalize one raw cross-product point: inapplicable knobs go to
    None so equivalent configurations collapse; invalid combinations
    (the ones the engines refuse at construction) return None. `size`
    (total device count) gates the plan family's grid to the cell's
    mesh."""
    k = dict(knobs)
    if family == "plan":
        ax = plan_spec_axes(k["plan"])
        ndev = ax["pp"] * ax["sp"] * ax["dp"]
        if size is not None and ndev != size:
            return None  # grid point for a different mesh size
        if dcn > 1:
            # On a factored ('dcn','ici') fabric the slice boundary
            # must fall BETWEEN pipeline stages (stage wire is the only
            # collective the plan sends across DCN; pp=1 plans keep the
            # data axis across slices — the DDP case).
            if ax["pp"] > 1 and ax["pp"] % dcn:
                return None
            if ax["sp"] > ndev // dcn:
                return None  # a ring-attention hop would cross DCN
        m = k.get("num_microbatches") or 0
        if ax["pp"] == 1 or not m:
            # No pipeline to fill (or the engine default M = pp*V):
            # not a knob — collapse so equivalent configs dedupe.
            k["num_microbatches"] = None
        else:
            # The engine's own fail-fast guards: M >= pp*V fills every
            # (virtual) stage; the interleaved builder round-robins
            # microbatch groups of S (M % pp == 0).
            if m < ax["pp"] * ax["virtual"] or m % ax["pp"]:
                return None
        return k
    if family in ("ddp", "fsdp", "sp_lm"):
        if k["dcn_compression"] != "none" and dcn < 2:
            return None  # no 'dcn' hop to compress (engine guard)
        if k["grad_reduction"] == "monolithic":
            # Monolithic has no bucket surface (the compressed variant
            # routes through ONE flat bucket, MONOLITHIC_BUCKET_MB —
            # still not a knob) and no backward to segment.
            k["bucket_mb"] = None
            k["overlap_stages"] = None
        elif k["grad_reduction"] == "bucketed":
            k["overlap_stages"] = None
    elif family == "ep":
        if k["dispatch"] == "gspmd":
            # The gspmd flat exchange has no explicit 'dcn' seam and no
            # chunk ring to overlap; on a factored (dcn > 1) fabric it
            # is exactly the lowering the hierarchical exchange
            # replaced, so it leaves the space entirely there.
            if dcn > 1 or k["overlap"] or k["dcn_compression"] != "none":
                return None
        elif k["dcn_compression"] != "none" and dcn < 2:
            return None
    return k


def preference(family: str, knobs: dict) -> tuple:
    """Deterministic tie-break among equal-cost candidates (the cost
    engine prices what the program ASKS the network for; two configs
    with identical asks differ only in schedule). Lower sorts first:
    prefer the more-overlapped config (overlap changes dependency
    structure at zero asked-bytes cost — the linter's dependency pins
    prove the overlap is real), then the larger bucket (fewer
    launches), then the LESS exotic wire (a codec the bytes don't pay
    for is free complexity)."""
    if family in ("ddp", "fsdp", "sp_lm"):
        return (
            {"overlapped": 0, "bucketed": 1, "monolithic": 2}[
                knobs["grad_reduction"]],
            -(knobs["bucket_mb"] or float("inf")),
            ("none", "bf16", "int8").index(knobs["dcn_compression"]),
            knobs["overlap_stages"] or 0,
            0 if knobs.get("collective_matmul") else 1,
        )
    if family == "ep":
        return (
            0 if knobs["dispatch"] == "hierarchical" else 1,
            0 if knobs["overlap"] else 1,
            ("none", "bf16", "int8").index(knobs["dcn_compression"]),
        )
    if family == "serve":
        # Equal-cost ties break toward less HBM overscan (smaller
        # pages), then fewer ingest launches (larger chunks), then the
        # LESS exotic arithmetic (quantization the roofline doesn't
        # pay for is free numerics risk — mirrors the wire tie-break),
        # then the SHALLOWER lookahead (a draft model the amortization
        # doesn't pay for is free machinery).
        return (
            knobs["page_size"], -knobs["prefill_chunk"],
            ("f32", "bf16", "int8").index(
                knobs.get("compute_dtype") or "f32"
            ),
            knobs.get("speculative_k") or 0,
        )
    if family == "plan":
        # Equal-cost ties break toward the LEAST-restructured plan:
        # fewer pipeline stages, then fewer sequence shards, then dense
        # dp over fsdp (resharding machinery the cost model doesn't pay
        # for is free complexity), then the SIMPLER schedule (gpipe
        # before 1f1b before interleaved — a tick table the bubble
        # term doesn't pay for is free machinery), then fewer
        # microbatches (a deeper fill the bubble doesn't pay for is
        # free latency).
        ax = plan_spec_axes(knobs["plan"])
        return (
            ax["pp"], ax["sp"], int(ax["fsdp"]),
            {"gpipe": 0, "1f1b": 1, "interleaved": 2}[ax["schedule"]],
            ax["virtual"],
            knobs.get("num_microbatches") or 0,
        )
    # tp: prefer the ring decomposition on a tie (latency hiding).
    return (0 if knobs["collective_matmul"] else 1,)


def candidates(family: str, dcn: int = 1, allow_cm: bool = True,
               size: Optional[int] = None) -> List[dict]:
    """The deduped, deterministically ordered candidate list for one
    engine family on a mesh with `dcn` cross-slice factor. `allow_cm`
    drops the collective_matmul=True half when the run has no ring axis
    (lm CLI with --seq-shards 1). `size` (total devices) restricts the
    plan family's spec grid to factorizations of the cell's mesh."""
    if family not in SPACES:
        raise ValueError(
            f"no search space for engine family {family!r} "
            f"(tunable families: {', '.join(sorted(SPACES))})"
        )
    knob_list = SPACES[family]
    out: Dict[str, dict] = {}
    for values in itertools.product(*(k.values for k in knob_list)):
        raw = {k.name: v for k, v in zip(knob_list, values)}
        if not allow_cm and raw.get("collective_matmul"):
            continue
        k = _canonicalize(family, raw, dcn, size)
        if k is not None:
            out.setdefault(canonical_key(k), k)
    return [out[key] for key in sorted(out)]


# ------------------------------------------------- the knob surface check


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_sources(subdir: str) -> str:
    root = os.path.join(_package_root(), subdir)
    chunks = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            with open(os.path.join(root, name)) as f:
                chunks.append(f.read())
    return "\n".join(chunks)


def scan_knob_surface() -> Dict[str, List[str]]:
    """Literal source scan of the port's own sources: every knob
    the space enumerates must exist as (a) a CLI flag literal somewhere
    under `cli/` and (b) an engine dataclass field (annotated
    attribute) somewhere under `parallel/` or `serving/` (the serve
    family's engine lives in `serving/engine.py`). Returns
    {knob_name: [what's missing, ...]} — empty means the space and the
    real surfaces agree."""
    cli_src = _read_sources("cli")
    engine_src = (
        _read_sources("parallel") + "\n" + _read_sources("serving")
    )
    strays: Dict[str, List[str]] = {}
    seen = set()
    for family, knob_list in sorted(SPACES.items()):
        for knob in knob_list:
            if (knob.name, knob.cli_flag, knob.engine_param) in seen:
                continue
            seen.add((knob.name, knob.cli_flag, knob.engine_param))
            missing = []
            if f'"{knob.cli_flag}"' not in cli_src:
                missing.append(
                    f"CLI flag {knob.cli_flag} not found under cli/"
                )
            if not re.search(
                rf"^\s*{re.escape(knob.engine_param)}\s*:",
                engine_src, re.MULTILINE,
            ):
                missing.append(
                    f"engine field {knob.engine_param!r} not found "
                    "under parallel/ or serving/"
                )
            if missing:
                strays.setdefault(
                    f"{family}.{knob.name}", []
                ).extend(missing)
    return strays


__all__ = [
    "FAMILIES",
    "Knob",
    "SPACES",
    "candidates",
    "canonical_key",
    "plan_spec_axes",
    "plan_specs",
    "preference",
    "scan_knob_surface",
    "scheduled_plan_candidates",
]
