"""The port's auto-tuner (`distributed_model_parallel_tpu_torch/tuning/`)
against the reference's (`distributed_model_parallel_tpu/tuning/`).

* Space and plans: `space.candidates`, `plan_specs`, `preference` and
  the scheduled cell's candidates equal the reference's for every
  family at the grid's sizes (the port's plan grid adds the 2- and
  4-rank worlds); `plan_spec_axes` agrees with the port's `parse_plan`
  on the whole grid; the knob surfaces exist in the port's CLIs and
  engines; a plan file written by either package validates in the
  other.
* The closed-form tier: `cell_payload` equal and `rank_candidates` in
  the same order, with scores within rtol 1e-12, for all 12 grid cells
  under the reference's constants.
* Searches: the pre-gate cell ddp S8 dcn2 tinycnn, searched by both
  packages under the reference's constants, picks the same knobs. The
  port's pruned search equals its brute force, two searches are
  byte-identical, and measured constants move the argmin as in the
  reference's case.
* The CLI hooks: every guard of the reference's `tuning/apply.py` fires
  in the port with its message (the explicit-knob refusals parametrised
  over the reference's own `_reject_explicit` lists, read from its
  source); a matching plan file applies its knobs.
* plangate: `gate_check`'s verdicts equal the reference's on its cases;
  the committed grid covers the reference's 12 cells under the port's
  constants; `--pregate --device cpu` exits 0; without a GPU the CLI
  asks for `--device cpu`.
* Multi-rank (one spawn of 4 gloo CPU ranks): `cli.data_parallel
  --engine ddp --auto-tune PLAN.json` on 2 ranks is bit-equal to the
  same run with the knobs spelled by hand, and `cli.lm --plan auto
  --auto-tune search` on 4 ranks picks one spec on every rank and is
  bit-equal to `--plan <that spec>`.

This module imports the JAX package only inside its tests: the spawned
ranks import it to find their target, and they run torch alone.
"""

import ast
import importlib
import json
import math
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import pytest
import torch

from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.observability import cost
from distributed_model_parallel_tpu_torch.tuning import apply
from distributed_model_parallel_tpu_torch.tuning import plan as tplan
from distributed_model_parallel_tpu_torch.tuning import plangate, search
from distributed_model_parallel_tpu_torch.tuning import space
from distributed_model_parallel_tpu_torch.tuning.plan import Cell
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12


def _ref():
    """The reference's modules (imported here, not at module level)."""
    from distributed_model_parallel_tpu.observability import cost as jcost
    from distributed_model_parallel_tpu.tuning import apply as japply
    from distributed_model_parallel_tpu.tuning import plan as jplan
    from distributed_model_parallel_tpu.tuning import plangate as jplangate
    from distributed_model_parallel_tpu.tuning import search as jsearch
    from distributed_model_parallel_tpu.tuning import space as jspace

    return dict(cost=jcost, apply=japply, plan=jplan, plangate=jplangate,
                search=jsearch, space=jspace)


def _jconst():
    jcost = _ref()["cost"]
    return {**jcost.CONSTANTS, **jcost.COMPUTE_CONSTANTS}


def _no_process_group():
    """The search records on torch's fake process group, which needs a
    process without one (an in-process CLI run leaves one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_reject_lists() -> dict:
    """{hook name: [flag, ...]} of the reference's `_reject_explicit`
    calls, read from its source (no jax import)."""
    tree = ast.parse((REPO / "distributed_model_parallel_tpu" / "tuning"
                      / "apply.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "_reject_explicit"):
                out[fn.name] = [e.elts[0].value for e in node.args[0].elts]
    return out


REJECT = _reference_reject_lists()
# what sets each knob flag on the command line
FLAG_ARGV = {
    "--grad-reduction": ["--grad-reduction", "bucketed"],
    "--bucket-mb": ["--bucket-mb", "4"],
    "--overlap-stages": ["--overlap-stages", "2"],
    "--dcn-compression": ["--dcn-compression", "bf16"],
    "--collective-matmul": ["--collective-matmul"],
    "--plan": ["--plan", "dp2"],
    "--moe-dispatch": ["--moe-dispatch", "hierarchical"],
    "--moe-overlap": ["--moe-overlap"],
}
DP_BASE = ["--device", "cpu", "--engine", "ddp", "--model", "tinycnn", "-type",
           "Synthetic"]
LM_BASE = ["--device", "cpu"]


# --------------------------------------------------------- space, plans


def test_reject_lists_are_read_from_the_reference():
    assert set(REJECT) == {"auto_tune_data_parallel", "auto_tune_lm"}
    assert set(FLAG_ARGV) == set(REJECT["auto_tune_data_parallel"]) | \
        set(REJECT["auto_tune_lm"])


def test_candidates_and_plan_specs_equal_the_reference():
    r = _ref()
    jspace, jplangate = r["space"], r["plangate"]
    for n in (2, 4, 8, 64):
        assert space.plan_specs(n) == jspace.plan_specs(n)
    cells = jplangate.grid()
    for c in cells:
        if c.model == "sched":
            got = space.scheduled_plan_candidates(c.size)
            assert got == jspace.scheduled_plan_candidates(c.size)
            continue
        for allow_cm in (True, False):
            got = space.candidates(c.family, c.dcn, allow_cm=allow_cm,
                                   size=c.size)
            want = jspace.candidates(c.family, c.dcn, allow_cm=allow_cm,
                                     size=c.size)
            assert got == want, c.name
            assert [space.preference(c.family, k) for k in got] == \
                [jspace.preference(c.family, k) for k in want]
            assert [space.canonical_key(k) for k in got] == \
                [jspace.canonical_key(k) for k in want]
    for family in space.FAMILIES:
        for dcn in (1, 2):
            size = 8 if family == "plan" else None
            assert space.candidates(family, dcn, size=size) == \
                jspace.candidates(family, dcn, size=size), (family, dcn)
    assert [k.name for k in space.SPACES["ddp"]] == \
        [k.name for k in jspace.SPACES["ddp"]]
    # the port's plan grid: the reference's, and the 2- and 4-rank worlds
    assert len(space.candidates("plan", 1, size=8)) == 55
    assert len(space.candidates("plan", 2, size=64)) == 171
    assert len(space.candidates("plan", 1, size=4)) == 28
    assert len(space.candidates("plan", 1, size=2)) == 9
    assert jspace.candidates("plan", 1, size=4) == []


def test_plan_grid_agrees_with_parse_plan_and_the_knobs_exist():
    from distributed_model_parallel_tpu_torch.parallel.plan import parse_plan

    for spec in space.SPACES["plan"][0].values:
        ax = space.plan_spec_axes(spec)
        p = parse_plan(spec)
        assert (ax["pp"], ax["sp"], ax["dp"], ax["ep"], ax["fsdp"],
                ax["schedule"], ax["virtual"]) == (
            p.pp, p.tp_or_sp, p.dp, p.ep, p.fsdp, p.schedule,
            p.virtual_stages), spec
    assert space.scan_knob_surface() == {}


def _jax_plan(cell, knobs, combo):
    r = _ref()
    return r["plan"].make_plan(
        r["plan"].Cell(cell.family, cell.size, cell.dcn, cell.model), knobs,
        combo, {"predicted_step_s": 1e-4, "alpha_s": 1e-4, "beta_s": 0.0,
                "n_collectives": 4},
        "hand", dict(r["cost"].CONSTANTS),
        search={"candidates": 39, "lowered": 4, "lint_violations": 0,
                "lint_rules": 20})


KNOBS = {"grad_reduction": "bucketed", "bucket_mb": 25.0,
         "overlap_stages": None, "dcn_compression": "bf16"}


def test_a_plan_file_of_either_package_validates_in_the_other(tmp_path):
    r = _ref()
    cell = Cell("ddp", 8, 2, "tinycnn")
    jpath = tmp_path / "jax.json"
    r["plan"].save_plan(str(jpath), _jax_plan(
        cell, KNOBS, "ddp/S8/dcn2/bucketed/wire-bf16/b25/tinycnn"))
    got = tplan.load_plan(str(jpath))
    assert tplan.dumps_plan(got) == jpath.read_text()
    ppath = tmp_path / "port.json"
    tplan.save_plan(str(ppath), tplan.make_plan(
        cell, KNOBS, "ddp/S8/dcn2/bucketed/wire-bf16/b25/tinycnn",
        {"predicted_step_s": 2e-4}, "hand", dict(cost.CONSTANTS),
        search={"candidates": 39, "lowered": 4}))
    assert r["plan"].load_plan(str(ppath))["knobs"] == KNOBS
    # the committed grid's rows are plans of the reference's schema too
    art = plangate.load_plans(plangate.DEFAULT_PLANS)
    for name, row in art["cells"].items():
        family = name.split("/")[0]
        tplan._check_knobs(family, row["knobs"], name)
        r["plan"]._check_knobs(family, row["knobs"], name)
    for bad, match in (({"schema": "dmpt.plan.v2"}, "schema"),
                       ({"surprise": 1}, "unknown field")):
        with pytest.raises(ValueError, match=match):
            tplan.validate_plan({**got, **bad})


# ----------------------------------------------------- closed-form tier


def test_closed_form_ranking_equals_the_reference_on_the_grid(monkeypatch):
    """All 12 cells, the reference's constants passed to both; the serve
    cell's compute term reads each package's module set, so the port's
    is patched to the reference's for this test."""
    r = _ref()
    jcost, jsearch, jspace = r["cost"], r["search"], r["space"]
    consts = _jconst()
    monkeypatch.setattr(cost, "COMPUTE_CONSTANTS",
                        dict(jcost.COMPUTE_CONSTANTS))
    for c in r["plangate"].grid():
        cell = Cell(c.family, c.size, c.dcn, c.model)
        payload = search.cell_payload(cell)
        assert payload == jsearch.cell_payload(c), c.name
        cands = (space.scheduled_plan_candidates(c.size) if c.model ==
                 "sched" else space.candidates(c.family, c.dcn,
                                               size=c.size))
        got = search.rank_candidates(c.family, cands, payload,
                                     c.size // c.dcn, c.dcn, consts)
        want = jsearch.rank_candidates(c.family, cands, payload,
                                       c.size // c.dcn, c.dcn, consts)
        assert [k for _, k in got] == [k for _, k in want], c.name
        for (s, _), (w, _) in zip(got, want):
            assert s == pytest.approx(w, rel=RTOL, abs=0.0), c.name
        if c.model != "sched":
            assert search.closed_form_argmin(
                c.family, payload, c.size // c.dcn, c.dcn, consts) == \
                jsearch.closed_form_argmin(c.family, payload,
                                           c.size // c.dcn, c.dcn, consts)
    assert jspace.FAMILIES == space.FAMILIES


# ------------------------------------------------------------- searches


def test_the_pregate_ddp_cell_picks_the_references_knobs(monkeypatch):
    """ddp S8 dcn2 tinycnn, both searches under the reference's
    constants. The reference's recorded tier lowers on this process's 8
    virtual CPU devices. Its verification needs two shims under the
    installed jax: `jax.core.ClosedJaxpr` / `Jaxpr` moved to
    `jax.extend.core`, and its `dcn-compressed-payload` and
    `no-grad-all-reduce` rules misread its own compressed lowering (the
    failures tests/test_hlolint.py and tests/test_wire_codec.py show on
    this jax); both are patched for the reference's search alone."""
    import jax
    import jax.extend.core as xc

    import distributed_model_parallel_tpu.analysis.rules as jrules

    r = _ref()
    _no_process_group()
    consts = _jconst()
    monkeypatch.setattr(jax.core, "ClosedJaxpr", xc.ClosedJaxpr,
                        raising=False)
    monkeypatch.setattr(jax.core, "Jaxpr", xc.Jaxpr, raising=False)
    real = jrules.run_rules
    monkeypatch.setattr(jrules, "run_rules", lambda ctx: [
        f for f in real(ctx) if f.rule not in ("dcn-compressed-payload",
                                               "no-grad-all-reduce")])
    want = r["search"].search_cell(r["plan"].Cell("ddp", 8, 2, "tinycnn"),
                                   constants=consts)
    got = search.search_cell(Cell("ddp", 8, 2, "tinycnn"), constants=consts,
                             device="cpu")
    assert got["knobs"] == want["knobs"]
    assert got["combo"] == want["combo"]
    assert got["search"]["finalist_combos"] == \
        want["search"]["finalist_combos"]
    assert got["search"]["lint_violations"] == 0


_SMALL_SPACE = (
    {"grad_reduction": "bucketed", "bucket_mb": 25.0,
     "overlap_stages": None, "dcn_compression": "none"},
    {"grad_reduction": "bucketed", "bucket_mb": 25.0,
     "overlap_stages": None, "dcn_compression": "bf16"},
    {"grad_reduction": "bucketed", "bucket_mb": 25.0,
     "overlap_stages": None, "dcn_compression": "int8"},
)
_CELL = Cell("ddp", 4, 2, "mlp")


def test_search_is_deterministic_and_equals_brute_force():
    from distributed_model_parallel_tpu_torch.analysis.rules import REGISTRY

    _no_process_group()
    p1 = search.search_cell(_CELL, space_knobs=_SMALL_SPACE, finalists=2,
                            device="cpu")
    p2 = search.search_cell(_CELL, space_knobs=_SMALL_SPACE, finalists=2,
                            device="cpu")
    assert tplan.dumps_plan(p1) == tplan.dumps_plan(p2)
    brute = search.search_cell(_CELL, space_knobs=_SMALL_SPACE,
                               finalists=None, device="cpu")
    assert brute["search"]["lowered"] == len(_SMALL_SPACE)
    assert (p1["knobs"], p1["combo"], p1["predicted"]) == \
        (brute["knobs"], brute["combo"], brute["predicted"])
    assert p1["search"]["lint_violations"] == 0
    assert p1["search"]["lint_rules"] == len(REGISTRY)
    assert p1["constants"] == {"source": "hand", "values": {
        k: cost.CONSTANTS[k] for k in sorted(cost.CONSTANTS)}}
    # the whole pre-gate cell too: pruned == brute force
    cell = Cell("ddp", 8, 2, "tinycnn")
    pruned = search.search_cell(cell, device="cpu")
    full = search.search_cell(cell, device="cpu", finalists=None)
    assert pruned["knobs"] == full["knobs"]
    assert pruned["predicted"] == full["predicted"]


def test_measured_constants_move_the_argmin():
    """The reference's case: with per-hop latency on 'dcn' and bytes
    cheap, the bf16 wire wins the compressed pair (int8's scale sidecars
    cost hops); with 'dcn' latency free and its bytes scarce, int8
    wins."""
    _no_process_group()
    pair = _SMALL_SPACE[1:]
    hand = search.search_cell(_CELL, space_knobs=pair, finalists=None,
                              device="cpu")
    assert hand["knobs"]["dcn_compression"] == "bf16"
    fitted = dict(cost.CONSTANTS, alpha_dcn_hop_s=1e-12,
                  bw_dcn_effective_bytes_per_s=1e6)
    cal = search.search_cell(_CELL, space_knobs=pair, finalists=None,
                             device="cpu", constants=fitted,
                             constants_source="calibration:test")
    assert cal["knobs"]["dcn_compression"] == "int8"
    assert cal["constants"] == {"source": "calibration:test",
                                "values": fitted}


# ------------------------------------------------------------ the hooks


def _exit(fn, *args) -> str:
    with pytest.raises(SystemExit) as e:
        fn(*args)
    return str(e.value.code)


def _both_hooks(hook, argv, world, monkeypatch, cli):
    """(port message, reference message) of one hook on one argv, at a
    world of `world` ranks (devices)."""
    import jax

    r = _ref()
    jcli = importlib.import_module(
        f"distributed_model_parallel_tpu.cli.{cli}")
    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setenv("WORLD_SIZE", str(world))
    port = getattr(apply, hook)
    ref = getattr(r["apply"], hook)
    mine = (dp_cli if cli == "data_parallel" else lm_cli).build_parser()
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    return (_exit(port, mine.parse_args(argv)),
            _exit(ref, jcli.build_parser().parse_args(jargv)))


@pytest.mark.parametrize("flag", REJECT["auto_tune_data_parallel"])
def test_data_parallel_hook_refuses_each_knob_flag_as_the_reference(
        flag, monkeypatch):
    got, want = _both_hooks("auto_tune_data_parallel",
                            DP_BASE + ["--auto-tune", "search",
                                       *FLAG_ARGV[flag]], 2, monkeypatch,
                            "data_parallel")
    assert got == want and flag in got


@pytest.mark.parametrize("flag", REJECT["auto_tune_lm"])
def test_lm_hook_refuses_each_knob_flag_as_the_reference(flag, monkeypatch):
    got, want = _both_hooks("auto_tune_lm",
                            LM_BASE + ["--auto-tune", "search",
                                       *FLAG_ARGV[flag]], 4, monkeypatch,
                            "lm")
    assert got == want and flag in got


HOOK_GUARDS = [  # (hook, cli, argv after the base, world)
    ("auto_tune_data_parallel", "data_parallel",
     ["--engine", "gspmd", "--auto-tune", "search"], 2),
    ("auto_tune_data_parallel", "data_parallel",
     ["--engine", "tp", "--model-shards", "1", "--auto-tune", "search"], 2),
    ("auto_tune_data_parallel", "data_parallel",
     ["--engine", "fsdp", "--auto-tune", "search"], 1),
    ("auto_tune_data_parallel", "data_parallel",
     ["--engine", "ddp", "--auto-tune", "plan.json",
      "--auto-tune-calibration", "cal.json"], 2),
    ("auto_tune_lm", "lm", ["--pipeline-stages", "2", "--auto-tune",
                            "search"], 4),
    ("auto_tune_lm", "lm", ["--plan", "auto", "--auto-tune", "search",
                            "--dcn-slices", "2"], 4),
    ("auto_tune_lm", "lm", ["--plan", "auto", "--auto-tune", "search",
                            "--moe-experts", "4"], 4),
    ("auto_tune_lm", "lm", ["--plan", "auto", "--auto-tune", "search"], 1),
    ("auto_tune_lm", "lm", ["--moe-experts", "8", "--expert-shards", "2",
                            "--auto-tune", "search"], 4),
    ("auto_tune_lm", "lm", ["--moe-experts", "8", "--auto-tune", "search"],
     1),
    ("auto_tune_lm", "lm", ["--auto-tune", "search"], 1),
    ("auto_tune_lm", "lm", ["--seq-shards", "4", "--auto-tune", "search"],
     4),
]


@pytest.mark.parametrize("hook,cli,argv,world", HOOK_GUARDS,
                         ids=[" ".join(g[2]) + f" w{g[3]}"
                              for g in HOOK_GUARDS])
def test_every_other_hook_guard_matches_the_reference(hook, cli, argv, world,
                                                      monkeypatch):
    base = ["--device", "cpu"] + (["--model", "tinycnn", "-type",
                                   "Synthetic"] if cli == "data_parallel"
                                  else [])
    got, want = _both_hooks(hook, base + argv, world, monkeypatch, cli)
    assert got == want


@pytest.mark.parametrize("argv,field", [
    (["--engine", "ddp"], "cell.mesh.data"),
    (["--engine", "fsdp", "--dcn-slices", "2"], "cell.family"),
    (["--engine", "ddp", "--dcn-slices", "2", "--model", "bert_tiny",
      "-type", "SyntheticText"], "cell.model"),
], ids=["data", "family", "model"])
def test_a_mismatched_plan_file_is_refused_naming_the_field(
        argv, field, tmp_path, monkeypatch):
    r = _ref()
    path = str(tmp_path / "plan.json")
    r["plan"].save_plan(path, _jax_plan(
        Cell("ddp", 8, 2, "tinycnn"), KNOBS,
        "ddp/S8/dcn2/bucketed/wire-bf16/b25/tinycnn"))
    world = 4 if field == "cell.mesh.data" else 8
    got, want = _both_hooks(
        "auto_tune_data_parallel",
        ["--device", "cpu", "--model", "tinycnn", "-type", "Synthetic",
         "--auto-tune", path, *argv], world, monkeypatch, "data_parallel")
    assert got == want and field in got


def test_a_matching_plan_file_applies_its_knobs(tmp_path, monkeypatch,
                                                capsys):
    r = _ref()
    path = str(tmp_path / "plan.json")
    r["plan"].save_plan(path, _jax_plan(
        Cell("ddp", 8, 2, "tinycnn"), KNOBS,
        "ddp/S8/dcn2/bucketed/wire-bf16/b25/tinycnn"))
    monkeypatch.setenv("WORLD_SIZE", "8")
    out = str(tmp_path / "out.json")
    args = dp_cli.build_parser().parse_args(
        DP_BASE + ["--dcn-slices", "2", "--auto-tune", path,
                   "--auto-tune-out", out])
    apply.auto_tune_data_parallel(args)
    assert (args.grad_reduction, args.bucket_mb, args.overlap_stages,
            args.dcn_compression) == ("bucketed", 25.0, None, "bf16")
    assert tplan.load_plan(out)["knobs"] == KNOBS
    assert "applied ddp/S8/dcn2/bucketed/wire-bf16/b25/tinycnn" in \
        capsys.readouterr().out
    monkeypatch.setenv("RANK", "1")  # a peer writes and prints nothing
    os.remove(out)
    apply.auto_tune_data_parallel(dp_cli.build_parser().parse_args(
        DP_BASE + ["--dcn-slices", "2", "--auto-tune", path,
                   "--auto-tune-out", out]))
    assert not os.path.exists(out) and capsys.readouterr().out == ""


def test_search_mode_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = dp_cli.build_parser().parse_args(
        ["--engine", "ddp", "--model", "tinycnn", "-type", "Synthetic",
         "--auto-tune", "search"])
    with pytest.raises(SystemExit, match="--device cpu"):
        apply.auto_tune_data_parallel(args)


# ------------------------------------------------------------- plangate

_ROW = {"knobs": dict(KNOBS), "combo": "ddp/S8/dcn2/bucketed/wire-bf16/b25/"
        "tinycnn", "predicted_step_s": 2e-3}
_C = "ddp/S8/dcn2/tinycnn"


def _gate_cases():
    """(artifact rows, results, kwargs, constants edit): the reference's
    cases."""
    drifted = {**_ROW, "knobs": {**_ROW["knobs"], "dcn_compression": "int8"}}
    cases = [({_C: _ROW}, {_C: dict(_ROW)}, {}, None),
             ({_C: _ROW}, {_C: drifted}, {}, None)]
    for factor in (1.5, 0.5, 1.04, 0.96):
        cases.append(({_C: _ROW}, {_C: {
            **_ROW, "predicted_step_s": _ROW["predicted_step_s"] * factor}},
            {}, None))
    cases += [
        ({_C: _ROW}, {"ep/S4/dcn2": dict(_ROW)}, {}, None),
        ({_C: _ROW}, {_C: dict(_ROW)},
         {"require_rows_for": [_C, "tp/S4"]}, None),
        ({_C: _ROW}, {_C: dict(_ROW)}, {}, "alpha_hop_s"),
        ({_C: _ROW}, {_C: {**_ROW, "predicted_step_s": 2.08e-3}},
         {"tolerance": 0.01}, None),
        ({_C: _ROW, "ep/S16/dcn2": _ROW}, {_C: dict(_ROW)},
         {"known_cells": [_C]}, None),
    ]
    return cases


@pytest.mark.parametrize("case", range(len(_gate_cases())))
def test_plangate_gate_check_verdicts_equal_the_reference(case):
    r = _ref()
    rows, results, kw, drift = _gate_cases()[case]
    mine = plangate.make_artifact(dict(rows), 0.05)
    ref = r["plangate"].make_artifact(dict(rows), 0.05)
    if drift:
        mine["constants"][drift] = 9e-9
        ref["constants"][drift] = 9e-9
    got = plangate.gate_check(mine, results, **kw)
    want = r["plangate"].gate_check(ref, results, **kw)
    assert sorted(f.split(":", 1)[0] for f in got) == \
        sorted(f.split(":", 1)[0] for f in want)
    for g, w in zip(got, want):
        for word in ("argmin drifted", "predicted step time drifted",
                     "no committed plan", "constants drift",
                     "no longer in the grid"):
            assert (word in g) == (word in w), (g, w)
        if "argmin drifted" in w:
            assert w.split(" (")[0] == g.split(" (")[0]


def test_the_committed_grid_covers_the_references_cells():
    r = _ref()
    assert [c.name for c in plangate.grid()] == \
        [c.name for c in r["plangate"].grid()]
    assert [c.name for c in plangate.pregate_cells()] == \
        [c.name for c in r["plangate"].pregate_cells()]
    art = plangate.load_plans(plangate.DEFAULT_PLANS)
    assert art["constants"] == cost.CONSTANTS
    names = [c.name for c in plangate.grid()]
    assert sorted(art["cells"]) == sorted(names)
    assert plangate.gate_check(art, {}, require_rows_for=names,
                               known_cells=names) == []


def test_plangate_pregate_cli_exits_0_and_refuses_without_a_gpu():
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_model_parallel_tpu_torch.tuning.plangate",
         "--pregate", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.splitlines()[-1])["plangate"]
    assert summary["failures"] == 0 and summary["gated"] == 2
    assert summary["name_checked"] == 12
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            plangate.main(["--pregate"])


# ------------------------------------------------------- multi-rank runs

TIMEOUT_S = 240


def _tuning_rank(rank, runs, out):
    """One rank of the spawned world: each run of `runs` whose world
    holds this rank, as `cli.<cli>.main(argv)` in a process group of the
    run's own (the CLI joins it from the launcher's variables, after
    its tuner hook), from this rank's directory. An argv item "{spec}"
    is the spec this rank's previous run applied."""
    try:
        import torch.distributed as dist

        import _torch_port_ranks as ranks
        from distributed_model_parallel_tpu_torch.data import datasets

        torch.set_num_threads(1)
        datasets.DatasetCollection.init = ranks.val_cut(
            datasets.DatasetCollection.init, 64)
        results = []
        for run in runs:
            if rank >= run["world"]:
                results.append(None)
                continue
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(run["world"]),
                              LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(run["port"]))
            os.chdir(run["dirs"][rank])
            mod = importlib.import_module(
                f"distributed_model_parallel_tpu_torch.cli.{run['cli']}")
            hook = ("auto_tune_lm" if run["cli"] == "lm"
                    else "auto_tune_data_parallel")
            applied = []
            real = getattr(mod, hook)
            setattr(mod, hook, lambda args: applied.append(real(args))
                    or applied[-1])
            spec = results[-1]["spec"] if results and results[-1] else None
            argv = [spec if a == "{spec}" else a for a in run["argv"]]
            try:
                history = mod.main(argv)["history"]
            finally:
                setattr(mod, hook, real)
                if dist.is_initialized():
                    dist.destroy_process_group()
            results.append({
                "history": history,
                "plan": applied[0] if applied else None,
                "spec": applied[0]["knobs"].get("plan") if applied
                else None})
        result = (True, results)
    except BaseException:  # noqa: BLE001 -- reported to the parent
        result = (False, traceback.format_exc())
    Path(out).write_bytes(pickle.dumps(result))


def _spawn(world, runs, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_tuning_rank, args=(r, runs, str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {TIMEOUT_S} s"
    results = [pickle.loads(o.read_bytes()) for o in outs]
    for r, (ok, value) in enumerate(results):
        assert ok, f"rank {r} failed:\n{value}"
    return [value for _, value in results]


DP_RUN = DP_BASE + ["-b", "64", "--epochs", "1", "--steps-per-epoch", "4"]
LM_RUN = ["--device", "cpu", "--vocab-size", "61", "--dim", "32", "--layers",
          "4", "--heads", "4", "--seq-len", "16", "-b", "8", "--epochs", "1",
          "--steps-per-epoch", "2", "--corpus-tokens", "2048", "--optimizer",
          "sgd", "--lr", "0.1"]


def _sums(history) -> list:
    """A history's metrics, without its timings."""
    return [{k: {m: e[k][m] for m in ("loss", "acc1", "acc5", "count")}
             for k in ("train", "val")} for e in history]


def _knob_argv(knobs: dict) -> list:
    flags = {"grad_reduction": "--grad-reduction", "bucket_mb": "--bucket-mb",
             "overlap_stages": "--overlap-stages",
             "dcn_compression": "--dcn-compression"}
    argv = []
    for k, flag in flags.items():
        if knobs[k] is not None and knobs[k] not in ("monolithic", "none"):
            argv += [flag, str(knobs[k])]
    return argv


def test_tuned_runs_on_gloo_ranks_equal_the_knobs_spelled_by_hand(tmp_path):
    """One spawn of 4 ranks: ranks 0-1 run the DP CLI from a searched
    plan file and with its knobs by hand; all four run `cli.lm --plan
    auto --auto-tune search` and `--plan <the applied spec>`."""
    from distributed_model_parallel_tpu_torch.runtime.dist import free_port

    _no_process_group()
    dp_plan = search.search_cell(Cell("ddp", 2, 1, "tinycnn"), device="cpu")
    path = tmp_path / "dp_plan.json"
    tplan.save_plan(str(path), dp_plan)
    runs = []
    for name, cli, world, argv in (
            ("dp_tuned", "data_parallel", 2,
             DP_RUN + ["--auto-tune", str(path)]),
            ("dp_hand", "data_parallel", 2,
             DP_RUN + _knob_argv(dp_plan["knobs"])),
            ("lm_tuned", "lm", 4,
             LM_RUN + ["--plan", "auto", "--auto-tune", "search"]),
            ("lm_hand", "lm", 4, LM_RUN + ["--plan", "{spec}"])):
        dirs = []
        for r in range(world):
            d = tmp_path / name / str(r)
            d.mkdir(parents=True)
            dirs.append(str(d))
        runs.append({"cli": cli, "world": world, "argv": argv,
                     "port": free_port(), "dirs": dirs})
    got = _spawn(4, runs, tmp_path)
    dp_tuned, dp_hand = [g[0] for g in got[:2]], [g[1] for g in got[:2]]
    assert all(g[0] is None and g[1] is None for g in got[2:])
    for r in dp_tuned:
        assert r["plan"]["knobs"] == dp_plan["knobs"]
    assert dp_plan["knobs"]["grad_reduction"] != "monolithic"
    assert _sums(dp_tuned[0]["history"]) == _sums(dp_hand[0]["history"])
    assert _sums(dp_tuned[1]["history"]) == _sums(dp_hand[1]["history"])
    lm_tuned, lm_hand = [g[2] for g in got], [g[3] for g in got]
    plans = [r["plan"] for r in lm_tuned]
    assert all(tplan.dumps_plan(p) == tplan.dumps_plan(plans[0])
               for p in plans)
    spec = plans[0]["knobs"]["plan"]
    assert plans[0]["cell"]["family"] == "plan" and spec == "pp2xdp2"
    for t, h in zip(lm_tuned, lm_hand):
        assert _sums(t["history"]) == _sums(h["history"])
        assert all(math.isfinite(e["train"]["loss"]) for e in t["history"])
