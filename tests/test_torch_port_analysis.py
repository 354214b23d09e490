"""The port's collective-contract linter (`distributed_model_parallel_tpu_
torch/analysis/`) against the reference's (`distributed_model_parallel_
tpu/analysis/`).

* Registry parity: the port's 20 rules carry the reference's ids,
  severities and contract sentences, and the reference's
  registry loads without jax (its package `__init__` imports jax; the
  three modules themselves do not).
* Polarity: every rule with a counterpart has a positive case (records
  built by hand that break it, caught by name) and a negative one
  (clean); `test_every_ported_rule_has_both_polarities` fails when a
  rule lacks either. The rules with no counterpart report it as an
  exemption with their reason, which ROADMAP.md lists.
* The expectation helpers (`_bucket_plan`, `_reducer_plans`,
  `_wire_chunk_expectations`, `_fsdp_gather_chunk_expectations`) equal
  the reference's on the same plans, called with plain data.
* The pre-gate matrix lints clean through the CLI (`--device cpu`; the
  CLI defaults to the card and refuses to start without one),
  `--list-rules` prints the 20 ids, and every family's deliberate break
  (`_torch_port_ranks.lint_breaks`) is named by its rule.
* The recorder sees every collective call site of the port: each is an
  attribute call on `torch.distributed` (which `recording()` wraps),
  and each is recorded when the lint matrix, the breaks and a few
  drivers run.
* One combo a family recorded on 8 real gloo ranks (one spawn) equals
  its record on the fake process group: the engines issue the same
  collectives whether or not the received values are real.
* The full matrix (`slow`; its tier-1 twin is the pre-gate CLI test)
  lints clean.
"""

import ast
import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu_torch.analysis import lint
from distributed_model_parallel_tpu_torch.analysis.collectives import (
    MeshModel,
)
from distributed_model_parallel_tpu_torch.analysis.record import (
    Note,
    Record,
)
from distributed_model_parallel_tpu_torch.analysis.rules import (
    REGISTRY,
    LintContext,
    LintTarget,
    run_rules,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_model_parallel_tpu_torch"
WORLD = 8
# one combo a family, each spanning the 8 ranks of the gloo spawn
GLOO_COMBOS = [
    dict(engine="dp", size=8),
    dict(engine="ddp", size=8, grad_reduction="overlapped",
         model="tinycnn"),
    dict(engine="fsdp", size=8, grad_reduction="overlapped", dcn=2,
         dcn_compression="int8"),
    dict(engine="tp", size=4, collective_matmul=True),
    dict(engine="sp", size=4, collective_matmul=True),
    dict(engine="sp_lm", size=4, grad_reduction="overlapped", dcn=2,
         dcn_compression="int8"),
    dict(engine="ep", size=8, dcn=2, moe_dispatch="hierarchical",
         moe_overlap=True, dcn_compression="int8"),
    dict(engine="ep", size=2, model_shards=2, collective_matmul=True),
    dict(engine="pipeline", size=1),
    dict(engine="cm_ag", size=8),
    dict(engine="cm_rs", size=8, bf16=True),
    dict(engine="serve", size=8, collective_matmul=True,
         compute_dtype="int8"),
    dict(engine="plan", size=8, plan="pp2xsp2xdp2"),
]
COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "broadcast", "send", "recv", "isend",
               "irecv", "batch_isend_irecv"}


def _run(code: str, timeout: int = 600) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _cli(*args, timeout: int = 600):
    return subprocess.run(
        [sys.executable, "-m", "distributed_model_parallel_tpu_torch."
         "analysis.lint", "--device", "cpu", *args], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The gloo ranks' rows (one spawn of 8), and in a process of its
    own the same combos on the fake group and every call site the
    recorder saw."""
    code = ("import json, sys; sys.path.insert(0, 'tests'); "
            "import _torch_port_ranks as r; "
            f"print(json.dumps({{'fake': r.fake_lint_records({GLOO_COMBOS!r}),"
            " 'sites': r.lint_sites()}))")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_run, code)
        gloo = ranks.spawn(WORLD, "lint_records", {"combos": GLOO_COMBOS},
                           tmp_path_factory.mktemp("lint_ranks"))
        local = json.loads(fut.result().strip().splitlines()[-1])
    return {"gloo": gloo, **local}


# ------------------------------------------------------------ registry


def _reference_registry() -> dict:
    """The reference's registry, read in a process where jax cannot be
    imported: its package `__init__` imports jax, so the package and its
    `analysis` subpackage stand in as bare namespaces over their
    directories."""
    code = (
        "import json, sys, types\n"
        "sys.modules['jax'] = None\n"
        "for name, sub in (('distributed_model_parallel_tpu', ''),\n"
        "                  ('distributed_model_parallel_tpu.analysis',\n"
        "                   '/analysis')):\n"
        "    m = types.ModuleType(name)\n"
        "    m.__path__ = ['distributed_model_parallel_tpu' + sub]\n"
        "    sys.modules[name] = m\n"
        "from distributed_model_parallel_tpu.analysis.rules import REGISTRY\n"
        "print(json.dumps({r.id: [r.severity, r.contract]\n"
        "                  for r in REGISTRY.values()}))\n")
    return json.loads(_run(code, 120).strip().splitlines()[-1])


def test_registry_equals_the_reference_and_loads_without_jax():
    want = _reference_registry()
    got = {r.id: [r.severity, r.contract] for r in REGISTRY.values()}
    assert list(got) == list(want)
    assert got == want
    assert len(got) == 20


def test_rules_with_no_counterpart_say_why_and_roadmap_lists_them():
    roadmap = (REPO / "ROADMAP.md").read_text()
    none = [r for r in REGISTRY.values() if r.no_counterpart]
    assert [r.id for r in none] == ["donated-step-aliased"]
    for r in none:
        assert len(r.no_counterpart) > 40
        assert f"`{r.id}`" in roadmap and "no counterpart" in roadmap
        ctx = LintContext.build(
            LintTarget("t", "ddp", donate=True, n_param_leaves=3), [],
            MeshModel.from_axes((("data", 2),)))
        found = [f for f in run_rules(ctx) if f.rule == r.id]
        assert len(found) == 1 and found[0].exempted
        assert found[0].message == f"no counterpart: {r.no_counterpart}"


# ------------------------------------------------------------ polarity

DCN = MeshModel.from_axes((("dcn", 2), ("ici", 2)))
DATA4 = MeshModel.from_axes((("data", 4),))
DATA2 = MeshModel.from_axes((("data", 2),))
MODEL4 = MeshModel.from_axes((("model", 4),))
MODEL2 = MeshModel.from_axes((("data", 1), ("model", 2), ("seq", 1),
                              ("expert", 1)))
PLAN_PP = MeshModel.from_axes((("stage", 2), ("data", 1), ("seq", 1)))
PLAN_DS = MeshModel.from_axes((("stage", 1), ("data", 2), ("seq", 2)))


def _events(*items):
    """Records and notes in issue order, each a tuple: ("note", kind,
    facts) or (op, ranks, elems[, dtype[, scope]])."""
    out = []
    for i, item in enumerate(items):
        if item[0] == "note":
            out.append(Note(i, item[1], "", tuple(sorted(item[2].items()))))
            continue
        op, ranks_, elems, dtype, scope = \
            tuple(item) + ("f32", "")[len(item) - 3:]
        width = {"f32": 4, "bf16": 2, "s8": 1}[dtype]
        out.append(Record(i, op, op, tuple(ranks_), dtype, elems,
                          elems * width, scope))
    return out


REDUCER = dict(engine="ddp", grad_reduction="bucketed",
               bucket_plans=(((8, "f32"),),))
HYBRID = dict(REDUCER, data_axes=("dcn", "ici"), ici_axis="ici",
              dcn_axis="dcn", ici_size=2, dcn_size=2)
SERVE = dict(engine="serve", collective_matmul=True, cm_axis="model")
WIRE = dict(HYBRID, dcn_compression="int8",
            dcn_wire_chunks=((2, "s8"), (2, "s8")))
OVERLAP = dict(engine="ddp", grad_reduction="overlapped", ici_size=2,
               overlap_segments=2)
PREFETCH = dict(engine="fsdp", grad_reduction="overlapped",
                overlap_segments=2, fsdp_full_leaf_shapes=((8, 4),),
                at_rest_shapes=((4, 4),))
PLAN = dict(engine="plan", plan_axes=(("stage", 2), ("data", 1),
                                      ("seq", 1)), plan_microbatches=2)
PLAN_GRAD = dict(engine="plan", plan_axes=(("stage", 1), ("data", 2),
                                           ("seq", 2)))

# rule -> {"pos": (target kw, mesh, events), "neg": ...}
CASES = {
    "dcn-grad-all-reduce": {
        "pos": (HYBRID, DCN, _events(("all_reduce", (0, 2), 8))),
        "neg": (HYBRID, DCN, _events(("all_reduce", (0, 2), 4)))},
    "bucket-ring-permutes": {
        "pos": (dict(REDUCER, ici_size=2), DATA2, _events(
            ("reduce_scatter", (0, 1), 8, "f32", "bucket_ring"))),
        "neg": (dict(REDUCER, ici_size=2), DATA2, _events(
            ("reduce_scatter", (0, 1), 8, "f32", "bucket_ring"),
            ("all_gather", (0, 1), 4, "f32", "bucket_ring")))},
    "dcn-bucket-psum-shard": {
        "pos": (HYBRID, DCN, _events(("all_reduce", (0, 2), 8))),
        "neg": (HYBRID, DCN, _events(("all_reduce", (0, 2), 4)))},
    "no-grad-all-reduce": {
        "pos": (dict(REDUCER, ici_size=4), DATA4, _events(
            ("all_reduce", (0, 1, 2, 3), 100))),
        "neg": (dict(REDUCER, ici_size=4, state_leaf_shapes=((50,),)),
                DATA4, _events(
                    ("all_reduce", (0, 1, 2, 3), 100),
                    ("all_reduce", (0, 1, 2, 3), 4, "f32", "metrics")))},
    "cm-ring-permutes": {
        "pos": (dict(engine="cm_ag", cm_axis="model", expected_permutes=3),
                MODEL4, _events(("send", (0, 1), 8), ("send", (0, 1), 8))),
        "neg": (dict(engine="cm_ag", cm_axis="model", expected_permutes=3),
                MODEL4, _events(*[("send", (0, 1), 8)] * 3))},
    "cm-monolithic-collective": {
        "pos": (dict(engine="cm_rs", cm_axis="model", expected_permutes=1),
                MODEL4, _events(("send", (0, 1), 8),
                                ("all_gather", (0, 1, 2, 3), 8))),
        "neg": (dict(engine="cm_rs", cm_axis="model", expected_permutes=1),
                MODEL4, _events(("send", (0, 1), 8)))},
    "fsdp-at-rest-sharded": {
        "pos": (dict(PREFETCH, at_rest_shapes=((8, 4),)), DATA2, []),
        "neg": (PREFETCH, DATA2, [])},
    "overlap-first-bucket-free": {
        "pos": (OVERLAP, DATA2, _events(
            ("note", "bwd_stage", {"stage": 0}),
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage1"),
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage0"))),
        "neg": (OVERLAP, DATA2, _events(
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage1"),
            ("note", "bwd_stage", {"stage": 0}),
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage0")))},
    "prefetch-gather-free": {
        "pos": (PREFETCH, DATA2, _events(
            ("note", "bwd_stage", {"stage": 1}),
            ("all_gather", (0, 1), 16, "f32", "prefetch_gather_stage0"),
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage1"))),
        "neg": (PREFETCH, DATA2, _events(
            ("all_gather", (0, 1), 16, "f32", "prefetch_gather_stage0"),
            ("note", "bwd_stage", {"stage": 1}),
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage1"),
            ("note", "bwd_stage", {"stage": 0}),
            ("all_reduce", (0, 1), 1, "f32", "grad_reduce_stage0"),
            ("note", "reduce_wait", {})))},
    "serve-decode-ring": {
        "pos": (dict(SERVE, serve_decode_permutes=2), MODEL2, _events(
            ("send", (0, 1), 8, "f32", "serve_ring"))),
        "neg": (dict(SERVE, serve_decode_permutes=2), MODEL2, _events(
            ("send", (0, 1), 8, "f32", "serve_ring"),
            ("send", (0, 1), 8, "f32", "serve_ring"),
            ("all_gather", (0, 1), 16, "f32", "serve_logits")))},
    "spec-verify-step": {
        "pos": (dict(SERVE, speculative_k=2, spec_verify_permutes=1),
                MODEL2, _events(("send", (0, 1), 8, "f32", "serve_ring"),
                                ("all_gather", (0, 1), 8))),
        "neg": (dict(SERVE, speculative_k=2, spec_verify_permutes=1),
                MODEL2, _events(("send", (0, 1), 8, "f32", "serve_ring")))},
    "decode-quantized-matmul": {
        "pos": (dict(engine="serve", compute_dtype="int8",
                     quant_dot_count=2, head_weight_shape=(16, 61)),
                MODEL2, _events(
                    ("note", "dot", {"mode": "int8", "shape": (16, 48)}),
                    ("note", "dot", {"mode": "f32", "shape": (16, 16)}),
                    ("note", "dot", {"mode": "f32", "shape": (16, 61)}))),
        "neg": (dict(engine="serve", compute_dtype="int8",
                     quant_dot_count=2, head_weight_shape=(16, 61)),
                MODEL2, _events(
                    ("note", "dot", {"mode": "int8", "shape": (16, 48)}),
                    ("note", "dot", {"mode": "int8", "shape": (16, 16)}),
                    ("note", "dot", {"mode": "f32", "shape": (16, 61)})))},
    "bf16-ring-upcast": {
        "pos": (dict(engine="cm_ag", bf16=True, cm_axis="model"), MODEL4,
                _events(("send", (0, 1), 8, "f32", "ag_matmul"))),
        "neg": (dict(engine="cm_ag", bf16=True, cm_axis="model"), MODEL4,
                _events(("send", (0, 1), 8, "bf16", "ag_matmul"),
                        ("send", (0, 1), 8, "f32", "kv_ring")))},
    "moe-hierarchical-a2a": {
        "pos": (dict(engine="ep", moe_dispatch="hierarchical",
                     moe_ring_permutes=2, ici_size=4), DATA4, _events(
                         ("all_to_all", (0, 1, 2, 3), 64))),
        "neg": (dict(engine="ep", moe_dispatch="hierarchical",
                     moe_ring_permutes=2, ici_size=4), DATA4, _events(
                         ("send", (0, 1), 16, "f32", "moe_ring"),
                         ("recv", (1, 0), 16, "f32", "moe_ring"),
                         ("send", (0, 1), 16, "f32", "moe_ring")))},
    "dcn-compressed-payload": {
        "pos": (WIRE, DCN, _events(
            ("all_to_all", (0, 2), 4, "f32", "dcn_wire"),
            ("all_to_all", (0, 2), 2, "f32", "dcn_scale"),
            ("all_gather", (0, 2), 2, "f32", "dcn_wire"),
            ("all_gather", (0, 2), 1, "f32", "dcn_scale"))),
        "neg": (WIRE, DCN, _events(
            ("reduce_scatter", (0, 1), 8, "f32", "bucket_ring"),
            ("all_to_all", (0, 2), 4, "s8", "dcn_wire"),
            ("all_to_all", (0, 2), 2, "f32", "dcn_scale"),
            ("all_gather", (0, 2), 2, "s8", "dcn_wire"),
            ("all_gather", (0, 2), 1, "f32", "dcn_scale"),
            ("all_gather", (0, 1), 4, "f32", "bucket_ring")))},
    "collective-fabric-known": {
        "pos": (dict(engine="dp"), DATA2, _events(("all_reduce", (0, 9), 1))),
        "neg": (dict(engine="dp"), DATA2, _events(("all_reduce", (0, 1), 1)))},
    "plan-wire-fabric": {
        "pos": (PLAN, PLAN_PP, _events(
            *[("send", (0, 1), 64, "f32", "plan_wire")] * 3)),
        "neg": (PLAN, PLAN_PP, _events(
            *[("send", (0, 1), 64, "f32", "plan_wire")] * 2,
            *[("recv", (1, 0), 64, "f32", "plan_wire")] * 2))},
    "plan-seq-fabric": {
        "pos": (PLAN_GRAD, PLAN_DS, _events(
            ("send", (0, 2), 8, "f32", "kv_ring"))),
        "neg": (PLAN_GRAD, PLAN_DS, _events(
            ("send", (0, 1), 8, "f32", "kv_ring"),
            ("send", (0, 1), 8, "f32", "ag_matmul")))},
    "plan-grad-fabric": {
        "pos": (PLAN_GRAD, PLAN_DS, _events(
            ("all_reduce", (0, 1), 32, "f32", "plan_grad"),
            ("all_reduce", (0, 2), 32, "f32", "plan_grad"))),
        "neg": (PLAN_GRAD, PLAN_DS, _events(
            ("all_reduce", (0, 1, 2, 3), 32, "f32", "plan_grad"),
            ("all_gather", (0, 2), 8, "f32", "plan_fsdp_gather")))},
}
PORTED = [r.id for r in REGISTRY.values() if not r.no_counterpart]


def _violations(case):
    kw, mesh, events = case
    ctx = LintContext.build(LintTarget("case", **kw), events, mesh)
    return {f.rule for f in run_rules(ctx) if not f.exempted}


def test_every_ported_rule_has_both_polarities():
    assert sorted(CASES) == sorted(PORTED)
    for rule_id, cases in CASES.items():
        assert set(cases) == {"pos", "neg"}, rule_id


@pytest.mark.parametrize("rule_id", PORTED)
def test_rule_catches_its_violation_by_name(rule_id):
    assert rule_id in _violations(CASES[rule_id]["pos"])


@pytest.mark.parametrize("rule_id", PORTED)
def test_rule_passes_its_clean_case(rule_id):
    assert rule_id not in _violations(CASES[rule_id]["neg"])


# ------------------------------------------------- expectation helpers


def _ref_lint():
    from distributed_model_parallel_tpu.analysis import lint as jlint

    return jlint


def test_bucket_plan_equals_the_reference():
    jlint = _ref_lint()
    shapes = [(3, 5), (7,), (64, 32), (2,), (128, 16), (9,)]
    leaves_np = [np.zeros(s, np.float32) for s in shapes]
    leaves_t = [torch.zeros(s) for s in shapes]
    for mb in (0.002, 0.02, 1.0):
        for pad in (1, 2, 4, 8):
            assert lint._bucket_plan(leaves_t, mb, pad) == \
                jlint._bucket_plan(leaves_np, mb, pad)


@pytest.mark.parametrize("grad_reduction,dcn,wire", [
    ("bucketed", 1, "none"), ("overlapped", 1, "none"),
    ("bucketed", 2, "int8"), ("monolithic", 2, "bf16"),
    ("monolithic", 1, "none")])
def test_reducer_plans_equal_the_reference(grad_reduction, dcn, wire):
    """Both packages' staged lint MLP (the same tree, in the same leaf
    order) planned alike: bucket plans, segments and state shapes."""
    jlint = _ref_lint()
    model = lint.staged_mlp()
    params, state = model.init(torch.Generator())
    got = lint._reducer_plans(params, state, len(model.parts.blocks),
                              grad_reduction, lint.BUCKET_MB, 2, dcn, wire)
    want = jlint._reducer_plans(jlint.staged_mlp(), grad_reduction,
                                jlint.BUCKET_MB, 2, dcn, wire)
    assert got == want


def test_wire_and_gather_chunk_expectations_equal_the_reference():
    jlint = _ref_lint()
    plans = (((64, "f32"), (32, "f32")), ((128, "bf16"),))
    for ici, k, wire in ((2, 2, "int8"), (4, 2, "bf16"), (2, 4, "int8"),
                         (2, 1, "int8"), (2, 2, "none")):
        assert lint._wire_chunk_expectations(plans, ici, k, wire) == \
            jlint._wire_chunk_expectations(plans, ici, k, wire)
    shapes = ((8, 4), (16,), (4, 4, 2))
    for k, wire, n in ((2, "int8", 1), (2, "bf16", 2), (4, "int8", 2),
                       (1, "int8", 1), (2, "none", 1)):
        assert lint._fsdp_gather_chunk_expectations(shapes, k, wire, n) == \
            jlint._fsdp_gather_chunk_expectations(shapes, k, wire, n)


# -------------------------------------------------------------- the CLI


def test_pregate_lints_clean_and_list_rules_prints_the_ids():
    proc = _cli("--pregate")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    legs = [line["leg"] for line in lines if "leg" in line]
    assert [leg["name"] for leg in legs] == [
        c.name for c in lint.pregate_matrix()]
    assert all(leg["violations"] == 0 and leg["collectives"] > 0
               for leg in legs)
    summary = lines[-1]["hlo_lint"]
    assert summary["errors"] == 0 and summary["rules"] == 20
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert [line.split()[0] for line in listed.stdout.splitlines()] == \
        list(REGISTRY)


def test_the_cli_defaults_to_cuda_and_refuses_without_a_gpu():
    assert lint.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    with pytest.raises(SystemExit, match="--device cpu"):
        lint.main(["--pregate"])


def test_each_family_break_is_named_by_its_rule():
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import _torch_port_ranks as r; "
            "sys.exit(r.lint_self_test('cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = [json.loads(line)["self_test"] for line in proc.stdout.splitlines()
           if line.startswith("{")]
    assert [g["family"] for g in got] == [b[0] for b in ranks.lint_breaks()]
    assert all(g["caught"] and g["expected"] in g["named"] for g in got)


def test_the_cli_exits_1_naming_the_rule_on_a_violation():
    """A break lints through `main`: exit 1 and the rule on stderr."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_port_ranks as r\n"
        "from distributed_model_parallel_tpu_torch.analysis import lint\n"
        "with r.flat_moe_exchange():\n"
        "    rc = lint.main(['--device', 'cpu', '--filter',\n"
        "                    '^ep/S4/dcn2/hierarchical/ov$'])\n"
        "sys.exit(0 if rc == 1 else 3)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "moe-hierarchical-a2a" in proc.stderr


# ------------------------------------------------------ the recorder


def _collective_sites():
    """(path, line, name) of every collective call in the port outside
    the linter, and any that does not reach `torch.distributed` by
    attribute (which `recording()` could not see)."""
    sites, hidden = [], []
    for path in sorted(PORT.rglob("*.py")):
        if "analysis" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("torch.distributed"):
                hidden += [(str(path), node.lineno, a.name)
                           for a in node.names if a.name in COLLECTIVES]
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in COLLECTIVES:
                base = ast.unparse(f.value)
                if base in ("dist", "torch.distributed"):
                    sites.append((str(path), node.lineno, f.attr))
                elif base not in ("self", "ctx") and f.attr not in (
                        "send", "recv"):
                    hidden.append((str(path), node.lineno, f.attr))
    return sites, hidden


def test_every_collective_site_goes_through_torch_distributed():
    sites, hidden = _collective_sites()
    assert hidden == []
    assert len(sites) >= 34


def test_the_recorder_sees_every_collective_site(recorded):
    sites, _ = _collective_sites()
    seen = {tuple(s.rsplit(":", 1)) for s in recorded["sites"]}
    missed = [(Path(p).relative_to(REPO).as_posix(), line, name)
              for p, line, name in sites if (p, str(line)) not in seen]
    assert missed == []


@pytest.mark.parametrize("kw", GLOO_COMBOS,
                         ids=[lint.Combo(**kw).name for kw in GLOO_COMBOS])
def test_fake_group_records_equal_the_gloo_ranks(recorded, kw):
    name = lint.Combo(**kw).name
    fake = [tuple(tuple(x) if isinstance(x, list) else x for x in row)
            for row in recorded["fake"][name]]
    gloo = [tuple(row) for row in recorded["gloo"][0][name]]
    assert len(gloo) > 0
    assert fake == gloo


@pytest.mark.slow
def test_full_matrix_lints_clean():
    """The whole matrix (104 combos; tier-1 twin:
    test_pregate_lints_clean_and_list_rules_prints_the_ids)."""
    proc = _cli(timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.splitlines()[-1])["hlo_lint"]
    assert summary["lowered"] == summary["targets"] == \
        len(lint.full_matrix())
    assert summary["errors"] == 0 and summary["violations"] == 0
