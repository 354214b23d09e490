"""The port's cost engine, calibration and costgate
(`distributed_model_parallel_tpu_torch/observability/cost.py`,
`calibrate.py`, `costgate.py`) against the reference's
(`distributed_model_parallel_tpu/observability/`).

* Closed forms: every public closed form of `cost.py` over a seeded
  argument grid, both packages under the reference's constants passed
  explicitly, within rtol 1e-12.
* Constants: the port's are the H100's (none of the reference's TPU
  values), each with its source beside it, the per-hop latencies marked
  as priors; the key names are the reference's.
* The walker: one seeded table of (kind, bytes, axes) on a (dcn 2, ici
  4) mesh and on a (data, model, expert) mesh, built as each package's
  `ClassifiedCollective` (the port's all_gather record holds a rank's
  shard, the reference's instruction the gathered whole; a port recv is
  free), priced within rtol 1e-12.
* Calibration: rows made from the closed forms at known constants plus
  intercepts fit back to them in both packages, the fits agreeing
  within rtol 1e-9; features times constants equal the closed forms;
  `rows_from_bench` reads the reference's table layout as the
  reference does; the CLI writes a file both packages load.
* costgate: `gate_check`'s verdicts and named combos equal the
  reference's on its cases (regression, tolerance boundary, missing
  row, constants drift); the committed ledger covers the full matrix
  under the port's constants; `--pregate --device cpu` exits 0; a
  missing row fails by name (exit 4); `--update` twice writes the same
  bytes; a subset update onto a ledger of other constants is refused;
  without a GPU the CLI asks for `--device cpu`.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu_torch.analysis import lint
from distributed_model_parallel_tpu_torch.analysis.collectives import (
    ClassifiedCollective,
    MeshModel,
)
from distributed_model_parallel_tpu_torch.observability import (
    calibrate,
    cost,
    costgate,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent

import distributed_model_parallel_tpu.observability.calibrate as jcalibrate  # noqa: E402,E501
import distributed_model_parallel_tpu.observability.cost as jcost  # noqa: E402
import distributed_model_parallel_tpu.observability.costgate as jcostgate  # noqa: E402,E501
from distributed_model_parallel_tpu.analysis import (  # noqa: E402
    collectives as jcoll,
)

# The reference's constants, both sets in one dict: the plan forms hand
# their `constants` to the compute roofline too (in both packages).
JCONST = {**jcost.CONSTANTS, **jcost.COMPUTE_CONSTANTS}
RTOL = 1e-12


def _close(a, b, rtol=RTOL):
    return a == pytest.approx(b, rel=rtol, abs=0.0)


# ------------------------------------------------------------ constants

TPU_VALUES = (100e9, 25e9, 1e-6, 10e-6, 800e9, 49e12, 197e12, 394e12)


def test_constants_are_the_h100s_with_their_sources():
    assert set(cost.CONSTANTS) == set(jcost.CONSTANTS)
    assert set(cost.COMPUTE_CONSTANTS) == set(jcost.COMPUTE_CONSTANTS)
    assert cost.CONSTANTS["bw_ici_effective_bytes_per_s"] == 450e9
    assert cost.CONSTANTS["bw_dcn_effective_bytes_per_s"] == 50e9
    assert cost.COMPUTE_CONSTANTS["bw_hbm_effective_bytes_per_s"] == 3.35e12
    assert [cost.MXU_RATE[m] for m in ("f32", "bf16", "int8")] == [
        67e12, 989e12, 1979e12]
    physics = [v for k, v in {**cost.CONSTANTS,
                              **cost.COMPUTE_CONSTANTS}.items()
               if not k.startswith("spec_")]
    assert not set(physics) & set(TPU_VALUES)
    src = (REPO / "distributed_model_parallel_tpu_torch" / "observability"
           / "cost.py").read_text()
    for name in ("BW_ICI_EFFECTIVE", "ALPHA_HOP_S", "BW_DCN_EFFECTIVE",
                 "ALPHA_DCN_HOP_S", "BW_HBM_EFFECTIVE"):
        line = re.search(rf"^{name} = .*$", src, re.M).group(0)
        assert "#" in line, line  # its source (or 'prior') beside it
        if name.startswith("ALPHA"):
            assert "prior" in line
    for v in ("100e9", "25e9", "1e-6", "10e-6", "800e9", "49e12", "197e12",
              "394e12"):
        assert not re.search(rf"(?<![\w.]){re.escape(v)}(?![\w.])", src), v


# --------------------------------------------------------- closed forms


def _grid(seed=0, n=12):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield dict(nbytes=float(rng.randint(1, 1 << 28)),
                   ici=int(rng.choice([1, 2, 4, 8, 16])),
                   dcn=int(rng.choice([1, 2, 4])),
                   n=int(rng.randint(1, 40)),
                   wire=str(rng.choice(["none", "f32", "bf16", "int8"])),
                   m=int(rng.choice([1, 3, 8, 64])),
                   k=int(rng.choice([16, 768, 3072])),
                   ncol=int(rng.choice([16, 768, 2304])),
                   mode=str(rng.choice(["f32", "bf16", "int8"])),
                   acc=float(rng.rand()),
                   spec=int(rng.choice([1, 2, 4])),
                   page=int(rng.choice([4, 8, 16])),
                   chunk=int(rng.choice([4, 8, 16])),
                   prompt=int(rng.randint(1, 200)),
                   new=int(rng.randint(1, 64)))


def _both(name, *args, **kw):
    return getattr(cost, name)(*args, **kw), getattr(jcost, name)(*args, **kw)


def test_every_closed_form_equals_the_reference():
    seen = set()

    def check(name, *args, **kw):
        seen.add(name)
        got, want = _both(name, *args, **kw)
        assert _close(got, want), (name, args, kw, got, want)

    for g in _grid():
        s = g["ici"] * g["dcn"]
        check("ring_all_reduce_s", g["nbytes"], s, g["n"], bw=7e10,
              alpha=3e-6)
        check("two_level_all_reduce_s", g["nbytes"], g["ici"], g["dcn"],
              g["n"], g["wire"], constants=JCONST)
        check("flat_all_to_all_s", g["n"] * 1000, 2, g["ici"], g["dcn"],
              constants=JCONST)
        check("hierarchical_all_to_all_s", g["n"] * 1000, 4, g["ici"],
              g["dcn"], wire=g["wire"], constants=JCONST)
        for sched, v in (("gpipe", 1), ("1f1b", 1), ("interleaved", 2)):
            for m in (0, 4, 8):
                check("plan_bubble_factor", g["spec"], sched, v, m)
                check("composed_plan_step_s", g["spec"], 2, g["dcn"],
                      g["nbytes"], 4, 64, 32, 61, 8, g["ici"], g["dcn"],
                      fsdp=bool(m), constants=JCONST, schedule=sched,
                      virtual_stages=v, num_microbatches=m,
                      compute_s=g["acc"] * 1e-3)
        check("plan_step_compute_s", 11104, g["n"] * 64, s, g["mode"],
              constants=JCONST)
        check("quant_matmul_s", g["m"], g["k"], g["ncol"], g["mode"],
              constants=JCONST)
        check("serve_decode_compute_s", 2, 16 * g["spec"], 32, g["m"],
              g["mode"], g["spec"], constants=JCONST)
        check("serve_verify_compute_s", 2, 16, 32, g["m"], g["spec"],
              g["mode"], g["spec"], constants=JCONST)
        check("speculative_expected_tokens", g["acc"], g["spec"])
        check("serve_speculative_token_s", 1e-4, 2e-4, g["spec"],
              constants=JCONST)
        check("serve_speculative_token_s", 1e-4, 2e-4, g["spec"],
              accept_rate=g["acc"], draft_cost_ratio=0.3, constants=JCONST)
        check("serve_paged_request_s", 32, g["prompt"], g["new"], 256,
              g["page"], g["chunk"], constants=JCONST)
        check("serve_speculative_request_s", g["prompt"], g["new"], 256,
              g["page"], g["chunk"], g["spec"], decode_compute_s=1e-5,
              verify_compute_s=2e-5, constants=JCONST,
              compute_constants=JCONST)
        combo = lint.Combo("serve", g["spec"], compute_dtype=g["mode"])
        got = cost.serve_combo_compute_s(combo, JCONST)
        assert _close(got, jcost.serve_combo_compute_s(combo, JCONST))
        seen.add("serve_combo_compute_s")
    public = {n for n in cost.__all__
              if n.endswith("_s") or n in ("plan_bubble_factor",
                                           "speculative_expected_tokens")}
    assert public - seen == {"plan_combo_compute_s"}  # below


def test_plan_combo_compute_counts_the_ports_own_proxy():
    """The plan combos' compute term: the port counts the proxy GPT's
    parameters from its own model (the reference from a jax.eval_shape);
    the counts and the terms agree."""
    for combo in lint.full_matrix():
        if combo.engine != "plan":
            continue
        got = cost.plan_combo_compute_s(combo, JCONST)
        assert _close(got, jcost.plan_combo_compute_s(combo, JCONST)), combo
        row = {"predicted_step_s": 1e-4}
        assert cost.add_plan_compute(row, combo, JCONST) == \
            jcost.add_plan_compute(row, combo, JCONST)


def test_serve_compute_fold_equals_the_reference(monkeypatch):
    """`add_serve_compute` (the serve rows' compute fold) under the
    reference's compute constants, the module set patched: the fold
    reads the module's set, in both packages."""
    monkeypatch.setattr(cost, "COMPUTE_CONSTANTS",
                        dict(jcost.COMPUTE_CONSTANTS))
    for combo in lint.full_matrix():
        if combo.engine == "serve":
            row = {"predicted_step_s": 3e-5}
            assert cost.add_serve_compute(row, combo) == \
                jcost.add_serve_compute(row, combo), combo.name


# ------------------------------------------------------------ the walker

# (reference kind, port kind) a row of the table
KINDS = (("all-reduce", "all_reduce"), ("all-gather", "all_gather"),
         ("reduce-scatter", "reduce_scatter"), ("all-to-all", "all_to_all"),
         ("collective-permute", "send"))


def _walker_table(axis_sets, seed):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(40):
        kinds = KINDS[rng.randint(len(KINDS))]
        axes = axis_sets[rng.randint(len(axis_sets))]
        rows.append((kinds, 64 * int(rng.randint(1, 1 << 16)), axes))
    return rows


@pytest.mark.parametrize("axes,dcn_axis,axis_sets", [
    ((("dcn", 2), ("ici", 4)), "dcn",
     (frozenset(), frozenset({"ici"}), frozenset({"dcn"}),
      frozenset({"dcn", "ici"}), None)),
    ((("data", 2), ("model", 2), ("expert", 2)), None,
     (frozenset({"data"}), frozenset({"model"}), frozenset({"expert"}),
      frozenset({"model", "expert"}), frozenset({"data", "model",
                                                 "expert"}), None)),
], ids=["dcn2xici4", "data_model_expert"])
@pytest.mark.parametrize("constants", ["reference", "port"])
def test_walker_prices_the_table_as_the_reference(axes, dcn_axis, axis_sets,
                                                  constants):
    pmesh = MeshModel.from_axes(axes)
    jmesh = jcoll.MeshModel(pmesh.axis_names, pmesh.shape, pmesh.coords)
    table = _walker_table(axis_sets, seed=len(axes))
    fab = cost.fabrics_from_constants(JCONST if constants == "reference"
                                      else cost.CONSTANTS)
    jfab = tuple(jcost.Fabric(f.name, f.alpha_s, f.bw_bytes_per_s)
                 for f in fab)
    mine, ref = [], []
    for (jkind, pkind), nbytes, ax in table:
        group = (int(np.prod([pmesh.size(a) for a in ax])) if ax
                 else (int(np.prod(pmesh.shape)) if ax is None else 1))
        shard = nbytes // group if pkind == "all_gather" else nbytes
        mine.append(ClassifiedCollective(None, pkind, ax, shard,
                                         pkind == "send"))
        ref.append(jcoll.ClassifiedCollective(None, jkind, ax, nbytes,
                                              jkind == "collective-permute"))
        if pkind == "send":  # its receive, which the sender pays for
            mine.append(ClassifiedCollective(None, "recv", ax, nbytes, True))
    got = cost.predict_collectives(mine, pmesh, dcn_axis, fabrics=fab)
    want = jcost.predict_collectives(ref, jmesh, dcn_axis, fabrics=jfab)
    assert got.n_collectives == want.n_collectives > 0
    assert got.bytes_by_fabric == want.bytes_by_fabric
    assert _close(got.alpha_s, want.alpha_s)
    assert _close(got.beta_s, want.beta_s)
    assert set(got.seconds_by_fabric) == set(want.seconds_by_fabric)
    for k, v in want.seconds_by_fabric.items():
        assert _close(got.seconds_by_fabric[k], v)


def test_combo_cost_row_shape_and_device_independence():
    """One cheap combo through record + classify + price; the row is a
    function of shapes and the mesh alone."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    row = cost.combo_cost(lint.Combo("cm_ag", 2), "cpu")
    assert row["n_collectives"] == 1 and row["predicted_step_s"] > 0
    assert set(row) >= {"predicted_step_s", "alpha_s", "beta_s",
                        "n_collectives", "bytes_by_fabric",
                        "seconds_by_fabric"}
    assert row == cost.combo_cost(lint.Combo("cm_ag", 2), "cpu")


# ----------------------------------------------------------- calibration


def _calibration_rows(mod, true, intercept):
    rows = []
    for s in (2, 4, 8, 16):
        for wire in ("none", "bf16", "int8"):
            for nbytes in (1.5e6, 24e6):
                r = mod.two_level_features(nbytes, ici=max(s // 2, 1), dcn=2,
                                           n_buckets=2, wire=wire)
                r.measured_s = mod.features_to_seconds(r, true) + intercept
                rows.append(r)
        r = mod.hierarchical_all_to_all_features(1e6, 4, ici=max(s // 2, 1),
                                                 dcn=2)
        r.measured_s = mod.features_to_seconds(r, true) + intercept
        rows.append(r)
    return rows


@pytest.mark.parametrize("true", [
    {"alpha_hop_s": 2e-6, "bw_ici_effective_bytes_per_s": 8e10,
     "alpha_dcn_hop_s": 2.5e-5, "bw_dcn_effective_bytes_per_s": 2e10},
    dict(cost.CONSTANTS),
], ids=["reference_case", "h100"])
def test_both_fits_recover_the_constants_and_agree(true):
    intercept = 1e-4
    got = calibrate.fit_constants(_calibration_rows(calibrate, true,
                                                    intercept))
    want = jcalibrate.fit_constants(_calibration_rows(jcalibrate, true,
                                                      intercept))
    for key in cost.CONSTANTS:
        assert got["constants"][key] == pytest.approx(
            want["constants"][key], rel=1e-9)
        assert abs(got["constants"][key] - true[key]) / true[key] < 0.01
    assert got["intercepts_s"]["rows"] == pytest.approx(
        want["intercepts_s"]["rows"], rel=1e-9)
    assert got["n_rows"] == want["n_rows"]
    assert got["residual_rms_s"] < 1e-9


def test_features_times_constants_equal_the_closed_forms():
    cases = [
        ("ring_all_reduce_features", (100e6, 64), {"n_ops": 161},
         "ring_all_reduce_s"),
        ("two_level_features", (100e6, 32, 2), {"n_buckets": 4},
         "two_level_all_reduce_s"),
        ("two_level_features", (100e6, 32, 2), {"n_buckets": 4,
                                                "wire": "int8"},
         "two_level_all_reduce_s"),
        ("flat_all_to_all_features", (12_500_000, 2, 32, 2), {},
         "flat_all_to_all_s"),
        ("hierarchical_all_to_all_features", (12_500_000, 2, 32, 2),
         {"wire": "int8"}, "hierarchical_all_to_all_s"),
    ]
    for consts in (JCONST, cost.CONSTANTS):
        for feat, args, kw, form in cases:
            row = getattr(calibrate, feat)(*args, **kw)
            jrow = getattr(jcalibrate, feat)(*args, **kw)
            assert (row.hops, row.wire_bytes) == (jrow.hops, jrow.wire_bytes)
            if form == "ring_all_reduce_s":
                want = cost.ring_all_reduce_s(
                    *args, bw=consts["bw_ici_effective_bytes_per_s"],
                    alpha=consts["alpha_hop_s"], **kw)
            else:
                want = getattr(cost, form)(*args, constants=consts, **kw)
            assert _close(calibrate.features_to_seconds(row, consts), want)


BENCH = {  # the reference's table layout, made up for the test
    "grad_mb": 9.2, "n_buckets": 3, "dispatch_payload_mb": 2.0,
    "reducer_microbench": [
        {"axis_size": s, "wire": w, "hierarchical_ms": 0.1 * s + i}
        for i, w in enumerate(("f32", "bf16", "int8")) for s in (4, 8, 16)],
    "moe_microbench": [
        {"axis_size": s, "wire": w, "hierarchical_ms": 0.3 * s + i}
        for i, w in enumerate(("f32", "int8")) for s in (4, 8)],
    "shapes": {"batch": 2, "seq_per_shard": 64, "d_model": 256,
               "d_ff": 1024},
    "collective_matmul_microbench": [
        {"axis_size": s, "fwd_overlapped_ms": 0.05 * s} for s in (2, 4)],
}


def test_rows_from_bench_and_the_cli(tmp_path, capsys):
    import dataclasses

    rows = calibrate.rows_from_bench({"parsed": BENCH})
    want = jcalibrate.rows_from_bench(BENCH)
    assert [dataclasses.asdict(r) for r in rows] == \
        [dataclasses.asdict(r) for r in want]
    assert {r.source for r in rows} == {"reducer", "moe", "cm"}
    src = tmp_path / "bench.json"
    src.write_text(json.dumps(BENCH))
    out = tmp_path / "cal.json"
    assert calibrate.main(["--bench", str(src), "--out", str(out),
                           "--note", "made up"]) == 0
    payload = json.loads(out.read_text())
    assert payload["version"] == jcalibrate.CALIBRATION_VERSION
    assert cost.load_calibration(str(out)) == \
        jcost.load_calibration(str(out))
    assert set(payload["drift_pct"]) == set(cost.CONSTANTS)
    assert calibrate.main(["--out", str(out)]) == 2  # no rows
    assert calibrate.DEFAULT_OUT.startswith(str(
        REPO / "distributed_model_parallel_tpu_torch"))
    with pytest.raises(ValueError, match="missing constants"):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"constants": {"alpha_hop_s": 1.0}}))
        cost.load_calibration(str(bad))


# -------------------------------------------------------------- costgate


def _named(failures):
    return sorted(f.split(":", 1)[0] for f in failures)


def _gate_cases():
    """(ledger rows, predictions, kwargs, ledger constants edit): the
    reference's cases."""
    one = {"predicted_step_s": 1e-3}
    return [
        ({"ddp/S4/bucketed": one},
         {"ddp/S4/bucketed": {"predicted_step_s": 1.2e-3}}, {}, None),
        ({"x": one}, {"x": {"predicted_step_s": 1.05e-3}}, {}, None),
        ({"x": one}, {"x": {"predicted_step_s": 1.06e-3}}, {}, None),
        ({"x": one}, {"x": {"predicted_step_s": 0.5e-3}}, {}, None),
        ({"x": one}, {"x": one, "new/S2": one}, {}, None),
        ({"x": one}, {"x": one},
         {"require_rows_for": ["x", "unrecorded/S8"]}, None),
        ({"x": one}, {"x": {"predicted_step_s": 1.04e-3}},
         {"tolerance": 0.01}, None),
        ({"x": one}, {"x": one}, {}, "alpha_hop_s"),
        ({"x": one}, {"x": one}, {}, "mxu_bf16_flop_per_s"),
    ]


@pytest.mark.parametrize("case", range(len(_gate_cases())))
def test_costgate_gate_check_verdicts_equal_the_reference(case):
    rows, preds, kw, drift = _gate_cases()[case]
    mine = costgate.make_ledger(rows, tolerance=0.05)
    ref = jcostgate.make_ledger(rows, tolerance=0.05)
    if drift:
        mine["constants"][drift] = 123.0
        ref["constants"][drift] = 123.0
    got = costgate.gate_check(mine, preds, **kw)
    want = jcostgate.gate_check(ref, preds, **kw)
    assert len(got) == len(want)
    assert _named(got) == _named(want)
    for g, w in zip(got, want):  # the same kind of failure
        for word in ("regressed", "no ledger row", "constants drift"):
            assert (word in g) == (word in w)
    if drift:
        assert drift in got[0]


def test_the_committed_ledger_covers_the_full_matrix():
    ledger = costgate.load_ledger(costgate.DEFAULT_LEDGER)
    assert ledger["constants"] == {**cost.CONSTANTS, **cost.COMPUTE_CONSTANTS}
    names = [c.name for c in lint.full_matrix()]
    assert costgate.gate_check(ledger, {}, require_rows_for=names) == []
    assert sorted(ledger["combos"]) == sorted(set(names))
    assert len(ledger["combos"]) == 104


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_costgate_pregate_cli_exits_0_against_the_committed_ledger():
    proc = _run("distributed_model_parallel_tpu_torch.observability.costgate",
                "--pregate", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines()
             if s.startswith("{")]
    legs = [s["leg"]["name"] for s in lines if "leg" in s]
    assert legs == [c.name for c in lint.pregate_matrix()]
    summary = lines[-1]["costgate"]
    assert summary["failures"] == 0 and summary["name_checked"] == 104
    committed = costgate.load_ledger(costgate.DEFAULT_LEDGER)["combos"]
    for s in lines:
        if "leg" in s:
            leg = s["leg"]
            assert leg["predicted_step_s"] == \
                committed[leg["name"]]["predicted_step_s"]


def test_costgate_update_is_byte_stable_and_a_missing_row_fails_by_name(
        tmp_path):
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    pick = ["--filter", "^(cm_ag/S2|tp/S2|serve/S2/q-int8)$", "--device",
            "cpu"]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert costgate.main(["--update", "--ledger", str(a), *pick]) == 0
    assert costgate.main(["--update", "--ledger", str(b), *pick]) == 0
    assert a.read_bytes() == b.read_bytes()
    ledger = json.loads(a.read_text())
    assert sorted(ledger["combos"]) == ["cm_ag/S2", "serve/S2/q-int8",
                                        "tp/S2"]
    committed = costgate.load_ledger(costgate.DEFAULT_LEDGER)["combos"]
    assert all(ledger["combos"][k] == committed[k] for k in ledger["combos"])
    del ledger["combos"]["tp/S2"]
    a.write_text(json.dumps(ledger))
    assert costgate.main(["--ledger", str(a), *pick]) == \
        costgate.EXIT_GATE_FAILED == 4
    # a subset update onto a ledger of other constants: refused (exit 2)
    # before anything is recorded, and the file left as it was
    ledger["constants"]["alpha_hop_s"] = 123.0
    a.write_text(json.dumps(ledger))
    assert costgate.main(["--update", "--ledger", str(a), *pick]) == 2
    assert json.loads(a.read_text()) == ledger


def test_costgate_defaults_to_cuda_and_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    with pytest.raises(SystemExit, match="--device cpu"):
        costgate.main(["--pregate"])
