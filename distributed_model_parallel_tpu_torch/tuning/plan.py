"""`plan.json`, the tuner's versioned artifact (port of `tuning/plan.py`,
schema `dmpt.plan.v1`, so either package reads the other's plans).

One plan is one cell's answer: the mesh factorization and lint-proxy
model it was searched for, the chosen knob values, the predicted step
breakdown of the winning configuration (the cost engine's
`CostBreakdown.as_row()`), the constants it was priced under, and the
search's audit trail (candidate count, how many were recorded, the
linter's verdict on the winner).

Validation is strict both ways: unknown top-level fields and unknown
schema versions are refused, not ignored. The byte form is canonical
(`dumps_plan`: sorted keys, fixed indent, trailing newline), so two
identical searches write byte-identical files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

PLAN_SCHEMA = "dmpt.plan.v1"

_TOP_FIELDS = {
    "schema", "cell", "knobs", "combo", "predicted", "constants",
    "search",
}
_REQUIRED_FIELDS = _TOP_FIELDS - {"search"}
_CELL_FIELDS = {"family", "model", "mesh"}
_MESH_FIELDS = {"data", "dcn"}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One tuning cell: engine family x mesh factorization x lint-proxy
    model. `size` is the family's PRIMARY parallel axis in the lint
    matrix's vocabulary (the data world for ddp/fsdp/sp_lm and the
    hierarchical-ep fabric; the 'model' axis for tp); `dcn` its
    cross-slice factor."""

    family: str
    size: int
    dcn: int = 1
    model: str = "mlp"

    @property
    def name(self) -> str:
        bits = [self.family, f"S{self.size}"]
        if self.dcn > 1:
            bits.append(f"dcn{self.dcn}")
        if self.model != "mlp":
            bits.append(self.model)
        return "/".join(bits)

    def as_record(self) -> dict:
        return {
            "family": self.family,
            "model": self.model,
            "mesh": {"data": int(self.size), "dcn": int(self.dcn)},
        }

    @staticmethod
    def from_record(rec: dict) -> "Cell":
        return Cell(
            family=rec["family"],
            size=int(rec["mesh"]["data"]),
            dcn=int(rec["mesh"]["dcn"]),
            model=rec["model"],
        )


def make_plan(cell: Cell, knobs: dict, combo_name: str,
              predicted: dict, constants_source: str,
              constants: dict, search: Optional[dict] = None) -> dict:
    plan = {
        "schema": PLAN_SCHEMA,
        "cell": cell.as_record(),
        "knobs": dict(knobs),
        "combo": combo_name,
        "predicted": dict(predicted),
        "constants": {
            "source": constants_source,
            "values": {k: constants[k] for k in sorted(constants)},
        },
    }
    if search is not None:
        plan["search"] = dict(search)
    return plan


def _check_knobs(family: str, knobs: dict, origin: str) -> None:
    """Knob-level strictness, same spirit as the field gate: every
    knob must exist in the family's search space and carry a value of
    the grid's type (None = the canonicalized not-applicable form) —
    a hand-edited `"bucket_mb": "25"` must fail HERE naming the knob,
    not as an anonymous TypeError deep in engine construction."""
    from distributed_model_parallel_tpu_torch.tuning.space import SPACES

    if not isinstance(family, str) or family not in SPACES:
        raise ValueError(
            f"{origin}: cell.family {family!r} is not a tunable "
            f"family (one of {', '.join(sorted(SPACES))})"
        )
    allowed = {k.name: k for k in SPACES[family]}
    unknown = sorted(set(knobs) - set(allowed))
    if unknown:
        raise ValueError(
            f"{origin}: knobs has unknown key(s) "
            f"{', '.join(unknown)} for family {family!r} (space: "
            f"{', '.join(sorted(allowed))})"
        )
    for name in sorted(knobs):
        val = knobs[name]
        if val is None:
            continue
        kinds = tuple({type(v) for v in allowed[name].values})
        ok = isinstance(val, kinds) or (
            float in kinds and isinstance(val, int)
            and not isinstance(val, bool)
        )
        if bool not in kinds and isinstance(val, bool):
            ok = False
        if not ok:
            raise ValueError(
                f"{origin}: knobs.{name} is {val!r} "
                f"({type(val).__name__}); the {family!r} space "
                f"expects {'/'.join(sorted(k.__name__ for k in kinds))}"
                " or null"
            )


def validate_plan(obj, origin: str = "plan") -> dict:
    """Schema gate: raises ValueError naming the offending field."""
    if not isinstance(obj, dict):
        raise ValueError(f"{origin}: not a JSON object")
    schema = obj.get("schema")
    if schema != PLAN_SCHEMA:
        raise ValueError(
            f"{origin}: schema is {schema!r}, this tree reads "
            f"{PLAN_SCHEMA!r} — regenerate with --auto-tune search"
        )
    unknown = sorted(set(obj) - _TOP_FIELDS)
    if unknown:
        raise ValueError(
            f"{origin}: unknown field(s) {', '.join(unknown)} — a "
            "newer plan schema must not half-apply"
        )
    missing = sorted(_REQUIRED_FIELDS - set(obj))
    if missing:
        raise ValueError(
            f"{origin}: missing field(s) {', '.join(missing)}"
        )
    cell = obj["cell"]
    if not isinstance(cell, dict) or set(cell) != _CELL_FIELDS:
        raise ValueError(
            f"{origin}: cell must carry exactly "
            f"{sorted(_CELL_FIELDS)}, got "
            f"{sorted(cell) if isinstance(cell, dict) else cell!r}"
        )
    mesh = cell["mesh"]
    if not isinstance(mesh, dict) or set(mesh) != _MESH_FIELDS:
        raise ValueError(
            f"{origin}: cell.mesh must carry exactly "
            f"{sorted(_MESH_FIELDS)}, got "
            f"{sorted(mesh) if isinstance(mesh, dict) else mesh!r}"
        )
    for key in _MESH_FIELDS:
        if not isinstance(mesh[key], int) or mesh[key] < 1:
            raise ValueError(
                f"{origin}: cell.mesh.{key} must be a positive "
                f"integer, got {mesh[key]!r}"
            )
    if not isinstance(obj["knobs"], dict) or not obj["knobs"]:
        raise ValueError(f"{origin}: knobs must be a non-empty object")
    _check_knobs(cell["family"], obj["knobs"], origin)
    predicted = obj["predicted"]
    if (
        not isinstance(predicted, dict)
        or "predicted_step_s" not in predicted
    ):
        raise ValueError(
            f"{origin}: predicted must be an object carrying "
            "predicted_step_s (the cost engine's gated number)"
        )
    constants = obj["constants"]
    if (
        not isinstance(constants, dict)
        or set(constants) != {"source", "values"}
    ):
        raise ValueError(
            f"{origin}: constants must carry exactly "
            "['source', 'values'] (provenance of the physics the plan "
            "was priced under)"
        )
    return obj


def dumps_plan(plan: dict) -> str:
    """Canonical byte form (determinism contract: same search, same
    bytes)."""
    return json.dumps(plan, indent=1, sort_keys=True) + "\n"


def save_plan(path: str, plan: dict) -> str:
    with open(path, "w") as f:
        f.write(dumps_plan(validate_plan(plan)))
    return path


def load_plan(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: not JSON ({e})") from e
    return validate_plan(obj, origin=path)


__all__ = [
    "Cell",
    "PLAN_SCHEMA",
    "dumps_plan",
    "load_plan",
    "make_plan",
    "save_plan",
    "validate_plan",
]
