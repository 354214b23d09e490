"""The port's composed parallel plans (`parallel/plan.py`, the plan mesh
of `runtime/mesh.make_plan_mesh`, the stage ranks of
`parallel/pipeline.run_stage_ticks`, `--plan` on the LM and
data-parallel CLIs) held against the JAX package on the 8-virtual-device
CPU mesh.

One spawn of 8 gloo ranks (`tests/_torch_port_ranks.py` `plan_suite`)
holds every multi-rank case, in waves on disjoint ranks. Sizes: the
reference's `TINY` GPT (vocab 61, dim 32, 4 layers, 4 heads, FFN 64,
T 16, no dropout), global batches of 8 sequences, 3 SGD(0.9, 1e-4)
steps at lr 0.1, from the reference's seed-0 weights.

* `parse_plan` / `ParallelPlan`: the same specs give the same fields and
  the same canonical spec, and the same bad specs are refused with the
  same messages.
* `build_plan_engine`'s degenerate map picks the counterpart of the
  engine the reference picks, with the same refusals.
* The LM and data-parallel CLIs' `--plan` guards refuse what the JAX
  CLIs refuse, with their messages.
* `pp2xsp2xdp2` (gpipe) on the 8 ranks against the reference's
  `ComposedPlanEngine` on the same spec: losses at rtol 1e-5 and every
  parameter at the port's f32 bar (rtol 1e-5 / atol 1e-6), the eval
  step, and the stage-wire hops and fused reductions a rank.
* `pp2-1f1bxsp2` (M 4), `pp2xfsdp2`, `pp2-int2xsp2`, `fsdp2`, `dp1` and
  `pp2xsp2` with the FFN rings (`collective_matmul`), the Ulysses flash
  core and remat against the reference's dense trajectory at the
  reference test's own bars (losses rtol 1e-5, parameters rtol 2e-4 /
  atol 2e-5), the FSDP ranks' leaves at the reference's per-parameter
  layout, and `state_partition_specs` equal to the reference's.
* `pp2` routes to `LMPipelineEngine` on stage ranks, whose run from the
  same weights follows the reference's `build_plan_engine("pp2")` (its
  `LMPipelineEngine`): per-step sums, eval and parameters at rtol 1e-5 /
  atol 1e-6, and equals the port's one-process pipeline engine's.
* A composed engine built without a device runs on the card, not the
  CPU.
"""

import concurrent.futures
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.cli import data_parallel as j_dp_cli
from distributed_model_parallel_tpu.cli import lm as j_lm_cli
from distributed_model_parallel_tpu.models import layers as JL
from distributed_model_parallel_tpu.models.gpt import GPTConfig as JGPTConfig
from distributed_model_parallel_tpu.models.gpt import gpt_lm as j_gpt_lm
from distributed_model_parallel_tpu.models.gpt import lm_loss as j_lm_loss
from distributed_model_parallel_tpu.models import staging as j_staging
from distributed_model_parallel_tpu.parallel import plan as jplan
from distributed_model_parallel_tpu.parallel.data_parallel import (
    TrainState as JTrainState,
)
from distributed_model_parallel_tpu.parallel.fsdp import (
    fsdp_specs as j_fsdp_specs,
)
from distributed_model_parallel_tpu.parallel.pipeline import (
    LMPipelineEngine as JLMPipelineEngine,
)
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.cli import common
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
)
from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
from distributed_model_parallel_tpu_torch.models.gpt import split_stages
from distributed_model_parallel_tpu_torch.parallel import plan as tplan
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    LMPipelineEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    Mesh,
    MeshSpec,
)
from distributed_model_parallel_tpu_torch.training.optim import SGD

GPT = dict(vocab_size=61, dim=32, num_layers=4, num_heads=4, ffn_dim=64,
           max_position=16, dropout_rate=0.0)
B, T, LR, STEPS = 8, 16, 0.1, 3
SGD_ARGS = (0.9, 1e-4)
WORLD = 8
TOL = dict(rtol=1e-5, atol=1e-6)
DENSE_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_plan.py _run_parity
R4, R8 = [0, 1, 2, 3], list(range(8))
RUNS = [
    ("composed", "pp2xsp2xdp2", R8, {}),
    ("1f1b", "pp2-1f1bxsp2", R4, {"kw": {"num_microbatches": 4}}),
    ("pp_fsdp", "pp2xfsdp2", [4, 5, 6, 7], {"fsdp_shapes": True}),
    ("fsdp", "fsdp2", [0, 1], {"fsdp_shapes": True}),
    ("pp_only", "pp2", [2, 3], {}),
    ("interleaved", "pp2-int2xsp2", [4, 5, 6, 7], {}),
    ("dp1", "dp1", [0], {}),
    ("cm_ulysses_remat", "pp2xsp2", [4, 5, 6, 7],
     {"kw": {"collective_matmul": True, "attention": "ulysses_flash",
             "remat": True}}),
]
AGAINST_DENSE = ("1f1b", "pp_fsdp", "interleaved", "fsdp", "dp1",
                 "cm_ulysses_remat")


def _batches():
    rng = np.random.RandomState(7)
    return [rng.randint(1, GPT["vocab_size"], size=(B, T)).astype(np.int32)
            for _ in range(STEPS)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_dense(params, state):
    """The reference's dense trajectory (tests/test_plan.py
    `_dense_step_fn`): per-step mean losses, the final parameters and
    the eval loss on the last batch."""
    model = j_gpt_lm(JGPTConfig(**GPT))
    opt = JSGD(*SGD_ARGS)

    @jax.jit
    def step(p, o, ids):
        def loss_fn(q):
            logits, _ = model.apply(q, state, ids, JL.Context(train=True))
            return j_lm_loss(logits, ids)

        loss, g = jax.value_and_grad(loss_fn)(p)
        p, o = opt.update(p, o, g, jnp.float32(LR))
        return p, o, loss

    p, o, losses = params, opt.init(params), []
    for ids in _batches():
        p, o, loss = step(p, o, jnp.asarray(ids))
        losses.append(float(loss))
    ids = jnp.asarray(_batches()[-1])
    logits, _ = model.apply(p, state, ids, JL.Context(train=False))
    return {"losses": losses, "params": _np(p),
            "eval": float(j_lm_loss(logits, ids))}


def _jax_composed(params, state):
    """The reference's `ComposedPlanEngine` on pp2xsp2xdp2 from the same
    weights: per-step metric sums, the canonical parameters, the eval."""
    eng = jplan.build_plan_engine(JGPTConfig(**GPT), JSGD(*SGD_ARGS),
                                  "pp2xsp2xdp2", donate=False)
    assert isinstance(eng, jplan.ComposedPlanEngine)
    opt = JSGD(*SGD_ARGS)
    ts = eng.from_canonical(JTrainState(params, state, opt.init(params),
                                        jnp.zeros((), jnp.int32)))
    sums = []
    for ids in _batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), jnp.float32(LR))
        sums.append({k: float(v) for k, v in m.items()})
    ev = eng.eval_step(ts, *eng.shard_batch(_batches()[-1]))
    return {"sums": sums, "params": _np(eng.to_canonical(ts).params),
            "eval": {k: float(v) for k, v in ev.items()}}


def _jax_pp_only(params, state):
    """The reference's `build_plan_engine("pp2")` (its `LMPipelineEngine`)
    from the same weights cut into its two stages: per-step metric sums,
    the canonical per-chunk parameters, the eval."""
    eng = jplan.build_plan_engine(JGPTConfig(**GPT), JSGD(*SGD_ARGS),
                                  "pp2", donate=False)
    assert isinstance(eng, JLMPipelineEngine)
    cuts = j_staging.split_points(2, None, GPT["num_layers"])
    p, s = (tuple(j_staging.partition_tree(t, cuts)) for t in (params, state))
    ts = eng.from_canonical(JTrainState(p, s, JSGD(*SGD_ARGS).init(p),
                                        jnp.zeros((), jnp.int32)))
    sums = []
    for ids in _batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), jnp.float32(LR))
        sums.append({k: float(v) for k, v in m.items()})
    ev = eng.eval_step(ts, *eng.shard_batch(_batches()[-1]))
    return {"sums": sums, "params": _np(eng.to_canonical(ts).params),
            "eval": {k: float(v) for k, v in ev.items()}}


@pytest.fixture(scope="module")
def weights():
    params, state = j_gpt_lm(JGPTConfig(**GPT)).init(jax.random.PRNGKey(0))
    return params, state


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The ranks' results (one spawn), computed while the reference's
    dense and composed runs compile and step here."""
    params, state = weights
    root = tmp_path_factory.mktemp("plan_ranks")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks.spawn, WORLD, "plan_suite", dict(
            gpt=GPT, params=_np(params), batches=_batches(), lr=LR,
            sgd=SGD_ARGS, runs=RUNS), root)
        dense = _jax_dense(params, state)
        composed = _jax_composed(params, state)
        pp_only = _jax_pp_only(params, state)
        got = {}
        for part in fut.result():
            got.update(part)
    return {"ranks": got, "dense": dense, "composed": composed,
            "pp_only": pp_only}


@pytest.fixture(scope="module", autouse=True)
def _no_process_group_left():
    """The in-process CLI runs join a one-rank gloo world; it is closed
    when the module ends."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, a), b in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------ the spec

SPECS = [
    "pp2xsp2xdp2", "pp2xfsdp4", "tp4", "dp1", "fsdp8", "ep2", "sp4xdp2",
    "pp2-1f1bxsp2xdp2", "pp4-int2xdp2", "pp2-1f1b-xsp2", "pp2xdp2",
    "dp2xpp2", "PP2XSP2",
    # refused
    "", "pp2x", "xx4", "pp2xpp2", "sp2xtp2", "dp3x2", "pp0", "pp2-int1",
    "sp2-1f1b", "dp4-int2", "pp1-1f1b", "pp2-gpipe", "fsdp1", "dpx",
]
PLANS = [
    dict(pp=2, schedule="interleaved", virtual_stages=1),
    dict(pp=1, schedule="1f1b"), dict(pp=2, virtual_stages=2),
    dict(pp=2, schedule="zigzag"), dict(dp=0), dict(dp=1, fsdp=True),
    dict(pp=4, schedule="interleaved", virtual_stages=2, dp=2, fsdp=True),
]


def _outcome(fn, *args, **kw):
    try:
        p = fn(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)
    return dataclasses.asdict(p), p.spec, p.num_devices


@pytest.mark.parametrize("case", SPECS + PLANS, ids=str)
def test_parse_plan_and_plan_fields_match_reference(case):
    """The same spec strings (and ParallelPlan fields) give the same
    fields, canonical spec and device count, and the same bad ones are
    refused with the same message (tests/test_plan.py's cases)."""
    if isinstance(case, str):
        got = _outcome(tplan.parse_plan, case)
        want = _outcome(jplan.parse_plan, case)
    else:
        got = _outcome(tplan.ParallelPlan, **case)
        want = _outcome(jplan.ParallelPlan, **case)
    assert got == want
    if isinstance(case, str) and got[0] != "ValueError":
        assert tplan.parse_plan(got[1]) == tplan.parse_plan(case)


# ------------------------------------------- the degenerate-plan map

ROUTES = [
    ("pp2", 0), ("sp2", 0), ("dp8", 0), ("fsdp4", 0), ("pp2xdp2", 0),
    ("sp2xdp2", 0), ("pp2-1f1b", 0), ("pp2-int2", 0), ("dp1", 0),
    ("pp2xsp2xdp2", 0), ("ep2", 0), ("ep2", 4), ("dp2", 4),
    ("ep2xdp2", 4), ("pp2xep2", 4), ("sp2xep2", 4), ("fsdp2xep2", 4),
]


@pytest.mark.parametrize("spec,experts", ROUTES)
def test_build_plan_engine_routes_like_reference(spec, experts,
                                                 monkeypatch):
    """`plan_route` (what `build_plan_engine` builds) names the
    counterpart of the engine class the reference's `build_plan_engine`
    returns for the same spec, or refuses with the same exception and
    message. The reference's ep route hands its engine the config where
    that engine takes a model, so the engine is stood in by a class of
    its name, which records the route."""
    from distributed_model_parallel_tpu.parallel import expert_parallel

    class ExpertParallelLMEngine:
        def __init__(self, *args, **kw):
            assert kw["dispatch"] == "hierarchical"

    monkeypatch.setattr(expert_parallel, "ExpertParallelLMEngine",
                        ExpertParallelLMEngine)

    def outcome(fn):
        try:
            return fn()
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__, str(e)

    jcfg = JGPTConfig(**GPT, num_experts=experts)
    want = outcome(lambda: type(jplan.build_plan_engine(
        jcfg, JSGD(), spec, donate=False)).__name__)
    got = outcome(lambda: tplan.plan_route(
        GPTConfig(**GPT, num_experts=experts), tplan.parse_plan(spec)))
    assert got == want


def test_composed_engine_refusals_match_reference():
    """The composed engine's guards: uniform chunks (num_layers % pp*V),
    microbatches that fill the pipeline, MoE configs and the plan mesh."""
    from distributed_model_parallel_tpu_torch.runtime.mesh import PlanMesh

    cases = [("pp8", {}, 0), ("pp2xdp2", {"num_microbatches": 1}, 0),
             ("pp2-int2xdp2", {"num_microbatches": 2}, 0),
             ("pp2-int4xdp2", {}, 0), ("pp2xdp2", {}, 4)]
    for spec, kw, experts in cases:
        plan = tplan.parse_plan(spec)
        mesh = PlanMesh(plan.pp, plan.dp, plan.tp_or_sp,
                        tuple(range(plan.num_devices)), "cpu")
        with pytest.raises((ValueError, NotImplementedError)) as got:
            tplan.ComposedPlanEngine(
                GPTConfig(**GPT, num_experts=experts), SGD(), mesh,
                plan=plan, device="cpu", **kw)
        with pytest.raises((ValueError, NotImplementedError)) as want:
            jplan.build_plan_engine(
                JGPTConfig(**GPT, num_experts=experts), JSGD(), spec,
                force_composed=True, **kw)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value), spec
    with pytest.raises(ValueError, match="wants 2-way 'stage'"):
        tplan.ComposedPlanEngine(GPTConfig(**GPT), SGD(),
                                 PlanMesh(1, 2, 1, (0, 1), "cpu"),
                                 plan=tplan.parse_plan("pp2"))


def test_mesh_spec_refusals_name_the_plan_mesh_and_ep_tp():
    with pytest.raises(ValueError, match="EP x TP mesh item"):
        MeshSpec(model=2, expert=2).resolve(4)
    with pytest.raises(ValueError, match="make_plan_mesh"):
        MeshSpec(seq=2, expert=2).resolve(4)


# ------------------------------------------------------------ the CLIs

LM_CLI = ["--vocab-size", "61", "--dim", "32", "--layers", "4", "--heads",
          "4", "--seq-len", "16", "-b", "8"]
LM_GUARDS = [
    ["--plan", "auto"], ["--plan", "zz4"], ["--plan", "pp2xpp2"],
    ["--plan", "sp2xdp4", "--seq-shards", "2"],
    ["--plan", "pp2", "--pipeline-stages", "2"],
    ["--plan", "pp2", "--pipeline-schedule", "1f1b"],
    ["--plan", "pp2", "--virtual-stages", "2"],
    ["--plan", "dp2", "--microbatches", "2"], ["--plan", "ep2"],
    ["--plan", "dp2", "--moe-experts", "4"],
    ["--plan", "pp2", "--attention", "ring_flash"],
    ["--plan", "dp2", "--collective-matmul"],
    ["--plan", "dp2", "--dcn-slices", "2"],
    ["--plan", "dp2", "--grad-reduction", "bucketed"],
    ["--plan", "dp2", "--bucket-mb", "4"],
    ["--plan", "dp2", "--overlap-stages", "2"],
    ["--plan", "dp2", "--dcn-compression", "int8"],
    ["--plan", "dp16"], ["--plan", "pp2xdp2", "-b", "6"],
    ["--plan", "pp2-int2xdp2", "-b", "4"],
    ["--plan", "sp4", "--seq-len", "30"],
]


def _exit_message(fn, argv) -> str:
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value.code)


def _port_lm_guards(argv):
    args = lm_cli.build_parser().parse_args(argv)
    plan = common.check_lm_args(args)
    common.check_plan_world(plan, min(plan.num_devices, WORLD),
                            args.batch_size, args.seq_len,
                            args.microbatches)
    raise AssertionError(f"{argv} passed the port's guards")


@pytest.mark.parametrize("flags", LM_GUARDS, ids=" ".join)
def test_lm_cli_plan_guards_match_reference(flags):
    """`cli.lm --plan` refuses the flag sets the JAX CLI refuses, with
    its message (the world checks at the reference's 8 devices)."""
    argv = LM_CLI + flags
    want = _exit_message(j_lm_cli.main, argv)
    got = _exit_message(_port_lm_guards, argv)
    if flags[1] == "auto":  # both name the tuner; the port its slice too
        assert "rides the tuner" in want and "rides the tuner" in got
        assert "auto-tuning slice" in got
        return
    assert got == want


def test_lm_cli_refuses_a_world_the_plan_does_not_fill():
    """The port's ranks are its devices: a plan of fewer ranks than the
    world would leave ranks idle, so it is refused (the reference runs
    the plan on the first devices)."""
    with pytest.raises(SystemExit, match=r"factors 2 device\(s\); this "
                                         r"world has 4 ranks"):
        common.check_plan_world(tplan.parse_plan("dp2"), 4, 8, 16, 1)
    with pytest.raises(SystemExit, match=r"needs 2 device\(s\), 1 present"):
        lm_cli.main(["--device", "cpu", *LM_CLI, "--plan", "pp2"])


DP_GUARDS = [["--plan", "pp2"], ["--plan", "sp2xdp2"],
             ["--plan", "fsdp2", "--engine", "ddp"],
             ["--plan", "dp2", "--engine", "tp"], ["--plan", "zz4"],
             ["--plan", "dp4"]]


@pytest.mark.parametrize("flags", DP_GUARDS, ids=" ".join)
def test_data_parallel_cli_plan_guards_match_reference(flags):
    """`cli.data_parallel --plan` keeps the data axis only, conflicts
    with another --engine and must factor the world (here one rank, the
    reference's eight devices: the count is masked)."""
    argv = ["--dataset-type", "Synthetic", "--model", "tinycnn", *flags]
    want = _exit_message(j_dp_cli.main, argv)
    got = _exit_message(dp_cli.main, ["--device", "cpu", *argv])
    mask = re.compile(r"this world has \d+")
    assert mask.sub("", got) == mask.sub("", want)


# ------------------------------------------------- the ranks' runs


def test_composed_pp2xsp2xdp2_matches_reference_engine(runs):
    """THE acceptance pin: stages as ranks of their own beside seq and
    data ranks follow the reference's composed engine on the same spec,
    weights and batches."""
    got, want = runs["ranks"]["composed"], runs["composed"]
    for g, w in zip(got["sums"], want["sums"]):
        assert g["count"] == w["count"] == B * (T - 1)
        np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], rtol=1e-5)
        assert g["correct1"] == w["correct1"]
    _close(got["params"], want["params"], **TOL)
    np.testing.assert_allclose(got["eval"]["loss_sum"],
                               want["eval"]["loss_sum"], rtol=1e-5)
    # gpipe at M = S = 2: stage 0 sends two activations a step (and two
    # in the eval), stage 1 two cotangents; one fused reduction a step.
    assert got["hops"] == [8] * 4 + [6] * 4
    assert got["reductions"] == [STEPS] * 8


@pytest.mark.parametrize("name", AGAINST_DENSE)
def test_plans_follow_the_dense_trajectory(runs, name):
    """1f1b with M above pp, ZeRO-3 on the plan's data axis (with and
    without stages), interleaved chunks, the one-rank plan and the seq
    leg's FFN rings with the Ulysses flash core under remat follow the
    reference's dense trajectory at its own bars."""
    got, dense = runs["ranks"][name], runs["dense"]
    losses = [s["loss_sum"] / s["count"] for s in got["sums"]]
    np.testing.assert_allclose(losses, dense["losses"], rtol=1e-5)
    _close(got["params"], dense["params"], **DENSE_TOL)
    np.testing.assert_allclose(got["eval"]["loss_sum"] / got["eval"]
                               ["count"], dense["eval"], rtol=1e-5)


def test_fsdp_plans_shard_leaves_at_the_reference_layout(runs, weights):
    """Each FSDP rank holds its stage's leaves at the reference's
    per-parameter layout (`fsdp_specs` on the canonical shapes): the
    sharded dimension 1/dp, small leaves whole."""
    params, _ = weights
    specs = j_fsdp_specs(params, 2, min_shard_elems=1024, axes="data")
    shapes = {jax.tree_util.keystr(p).replace("']['", "/").strip("[']"):
              (tuple(a.shape), s) for (p, a), s in zip(
                  jax.tree_util.tree_leaves_with_path(params),
                  jax.tree_util.tree_leaves(
                      specs, is_leaf=lambda x: isinstance(
                          x, jax.sharding.PartitionSpec)))}
    seen = 0
    for key, got in runs["ranks"].items():
        if not (isinstance(key, tuple) and key[1] == "shapes"):
            continue
        for path, shape in got.items():
            full, spec = shapes[path]
            want = tuple(n // 2 if part is not None else n
                         for n, part in zip(full, tuple(spec) +
                                            (None,) * len(full)))
            assert shape == want, (key, path)
            seen += 1
    # fsdp2: both ranks every leaf; pp2xfsdp2: each stage's half.
    n_leaves = len(shapes)
    assert seen == 2 * n_leaves + 2 * n_leaves


@pytest.mark.parametrize("spec", ["fsdp4", "pp2xfsdp2", "pp2xsp2xdp2"])
def test_state_partition_specs_match_reference(spec):
    """The sharded manifest's layout seam: the same PartitionSpec a
    parameter and optimizer leaf as the reference's composed engine
    (AdamW: the moments follow the parameters, the count replicated)."""
    from distributed_model_parallel_tpu.training.optim import (
        AdamW as JAdamW,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import PlanMesh
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )
    from distributed_model_parallel_tpu_torch.training.optim import AdamW

    plan = tplan.parse_plan(spec)
    eng = tplan.ComposedPlanEngine(
        GPTConfig(**GPT), AdamW(),
        PlanMesh(plan.pp, plan.dp, plan.tp_or_sp,
                 tuple(range(plan.num_devices)), "cpu"), plan=plan,
        device="cpu")
    jeng = jplan.build_plan_engine(JGPTConfig(**GPT), JAdamW(), spec,
                                   force_composed=True, donate=False)
    got = eng.state_partition_specs()
    want = jeng.state_partition_specs()
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for field in ("params", "mu", "nu"):
        g = flatten_tree(got.params if field == "params"
                         else getattr(got.opt_state, field))
        w = jax.tree_util.tree_leaves_with_path(
            want.params if field == "params"
            else getattr(want.opt_state, field), is_leaf=is_spec)
        assert len(g) == len(w)
        for path, spec_w in w:
            key = jax.tree_util.keystr(path).replace("']['", "/").strip(
                "[']")
            assert tuple(g[key]) == tuple(spec_w), (field, key)
    assert tuple(got.opt_state.count) == tuple(want.opt_state.count) == ()


def test_pp_only_plan_runs_the_pipeline_engine_on_stage_ranks(runs,
                                                               weights):
    """`pp2` routes to `LMPipelineEngine` with its stages on two ranks
    (gpipe's reversed backward ticks on the wire); from the same weights
    its run follows the reference's `build_plan_engine("pp2")` and equals
    the port's one-process pipeline engine's."""
    got, want = runs["ranks"]["pp_only"], runs["pp_only"]
    for g, w in zip(got["sums"], want["sums"]):
        assert g["count"] == w["count"] == B * (T - 1)
        np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], rtol=1e-5)
        assert g["correct1"] == w["correct1"]
    np.testing.assert_allclose(got["eval"]["loss_sum"],
                               want["eval"]["loss_sum"], rtol=1e-5)
    assert len(got["params"]) == len(want["params"]) == 2
    _close(tuple(got["params"]), tuple(want["params"]), **TOL)
    assert got["hops"] == [8, 6] and got["reductions"] == [0, 0]

    cfg = GPTConfig(**GPT)
    eng = LMPipelineEngine(split_stages(2, cfg), SGD(*SGD_ARGS),
                           Mesh(1, None, stage=2), num_microbatches=2,
                           pad_token_id=None)
    cuts = staging.split_points(2, None, GPT["num_layers"])
    empty = {"stem": {}, "head": {},
             "blocks": {str(i): {} for i in range(GPT["num_layers"])}}
    ts = eng.state_from_params(
        staging.partition_tree(from_jax_params(_np(weights[0])), cuts),
        staging.partition_tree(empty, cuts))
    sums = []
    for ids in _batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), LR)
        sums.append({k: float(v) for k, v in m.items()})
    for g, w in zip(got["sums"], sums):
        np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], rtol=1e-5)
        assert g["count"] == w["count"]
    _close(tuple(got["params"]), tuple(eng.to_canonical(ts)["params"]),
           **TOL)


def test_composed_engine_defaults_to_the_card():
    """Without a device argument the plan mesh and the composed engine
    compute on CUDA: only a caller that passes "cpu" gets the CPU. Here,
    with no card, the engine's first tensor on its device raises."""
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        make_plan_mesh,
    )

    mesh = make_plan_mesh(1, 1, 1)
    assert mesh.device.type == "cuda"
    eng = tplan.ComposedPlanEngine(GPTConfig(**GPT), SGD(), mesh)
    assert eng.device.type == "cuda"
    with pytest.raises(ValueError, match="make_plan_mesh's device"):
        tplan.ComposedPlanEngine(GPTConfig(**GPT), SGD(),
                                 make_plan_mesh(1, 1, 1, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            eng.init_state(0)
