"""The port's expert parallelism across ranks (`ops/expert_dispatch.py`,
`parallel/expert_parallel.py`, `DDPEngine(expert_dispatch=...)`, the LM
CLI's MoE runs) held against the JAX package on the 8-virtual-device CPU
mesh.

One spawn of 4 gloo ranks (`tests/_torch_port_ranks.py` `moe_suite`)
holds every multi-rank case (each spawn costs the suite its processes).
Sizes: GPT vocab 64, dim 32, 2 layers (block 1 MoE), 4 heads, FFN 64, E
4, top-2, capacity factor 0.5 (so tokens are dropped), 3 SGD(0.9, 1e-2)
steps at lr 0.1 on global batches of 8 sequences of 16 tokens with pad
(0) tails; the MoE BERT classifier (hidden 32, 2 layers, E 4) for the
DDP and DP engines.

Bars: f32 rtol 1e-5 / atol 1e-6; the compressed cross-slice wires 1e-2
(bf16) and 5e-2 (int8), relative to the largest magnitude.

* The exchange at S 4 and dcn 2 x ici 2: `dispatch_exchange` equals the
  flat all-to-all and a numpy permutation of the sources' buffers,
  `combine_exchange` returns them; the unfused and overlapped exchange
  + FFN match the reference's `expert_ffn` on every source's buffer
  (outputs, input and expert-weight gradients) under each wire; the
  hops equal `exchange_permutes` forward and again backward.
* `ExpertParallelLMEngine` in gspmd mode at (data, expert) (2, 2) and
  (1, 4), hierarchical at S 4 and dcn 2 x ici 2, with and without
  overlap, against the reference engine's f32 run (per-step metric
  sums, the gathered canonical parameters; the compressed dcn runs
  within their budgets); expert bytes a rank 1/N of the stacks.
* `DDPEngine(expert_dispatch="hierarchical")` under monolithic,
  bucketed (with overlap) and overlapped reduction, and without the
  dispatch, against the reference's hierarchical DDP engine;
  `DataParallelEngine` on the MoE BERT against the reference's.
* A hierarchical EP state saved at S 4 in the sharded format restores at
  gspmd (2, 2) and (1, 4) on the ranks and at S 1 here: its next step
  equals the S 4 run's.
* The LM CLI on the 4 ranks resumed from the port's one-rank MoE
  checkpoint equals the one-rank resume.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.models import moe as jmoe
from distributed_model_parallel_tpu.models.bert import (
    BertConfig as JBertConfig,
)
from distributed_model_parallel_tpu.models.bert import (
    bert_for_classification as j_bert,
)
from distributed_model_parallel_tpu.models.gpt import GPTConfig as JGPTConfig
from distributed_model_parallel_tpu.models.gpt import gpt_lm as j_gpt_lm
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DataParallelEngine as JDataParallelEngine,
)
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.parallel.expert_parallel import (
    ExpertParallelLMEngine as JEPLMEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch import checkpointing
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.models.gpt import (
    GPTConfig,
    gpt_lm_model,
)
from distributed_model_parallel_tpu_torch.ops.expert_dispatch import (
    exchange_permutes,
)
from distributed_model_parallel_tpu_torch.parallel.expert_parallel import (
    ExpertParallelLMEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import SGD

TOL = dict(rtol=1e-5, atol=1e-6)
BUDGET = {"none": None, "bf16": 1e-2, "int8": 5e-2}
LR = 0.1
GPT = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
           max_position=16, dropout_rate=0.0, pad_token_id=0,
           num_experts=4, moe_every=2, moe_top_k=2,
           moe_capacity_factor=0.5)
BERT = dict(vocab_size=67, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=16, dropout_rate=0.0,
            num_experts=4, moe_every=2, moe_capacity_factor=0.5)
CLASSES = 3
WORLD = 4  # one spawn of gloo ranks holds every multi-rank case
# (dcn, overlap, wire) cases of the exchange ops
OPS = [(1, False, "none"), (1, True, "none"), (2, False, "none"),
       (2, True, "none"), (2, False, "bf16"), (2, True, "int8")]
# (data, expert, dcn, dispatch, overlap, wire)
EP = [(2, 2, 1, "gspmd", False, "none"),
      (1, 4, 1, "gspmd", False, "none"),
      (4, 1, 1, "hierarchical", False, "none"),
      (4, 1, 1, "hierarchical", True, "none"),
      (4, 1, 2, "hierarchical", False, "none"),
      (4, 1, 2, "hierarchical", True, "bf16"),
      (4, 1, 2, "hierarchical", False, "int8")]
# (grad_reduction, expert_dispatch, expert_overlap)
DDP = [("monolithic", "hierarchical", False),
       ("bucketed", "hierarchical", True),
       ("overlapped", "hierarchical", False),
       ("monolithic", None, False),
       ("gspmd", None, False)]  # DataParallelEngine: the aux over ranks
# the S 4 hierarchical state's file restored on the ranks at these
# layouts, and at S 1 in this process
RESTORE = [(2, 2, 1, "gspmd", False, "none"),
           (1, 4, 1, "gspmd", False, "none")]
# the LM CLI on the ranks, resumed from the port's one-rank file
CLI = ["--device", "cpu", "--dim", "32", "--layers", "2", "--heads", "4",
       "--seq-len", "16", "-b", "8", "--vocab-size", "64",
       "--corpus-tokens", "2048", "--moe-experts", "8", "--optimizer",
       "sgd", "--lr", "0.1", "--steps-per-epoch", "4"]
CLI_RUNS = [["--expert-shards", "2"],
            ["--moe-dispatch", "hierarchical", "--moe-overlap",
             "--dcn-slices", "2"]]
E, B_LOC, CAP, D = 4, 2, 3, 8


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ids():
    rng = np.random.RandomState(0)
    out = []
    for i in range(3):
        ids = rng.randint(1, 64, size=(8, 16)).astype(np.int32)
        ids[i % 8, -4:] = 0
        out.append(ids)
    return out


def _bert_batches():
    rng = np.random.RandomState(1)
    out = []
    for _ in range(3):
        ids = rng.randint(1, 67, size=(8, 16)).astype(np.int32)
        ids[:, -3:] = 0
        out.append((ids, rng.randint(0, CLASSES, 8).astype(np.int32)))
    return out


def _ops_data(world):
    rng = np.random.RandomState(world)
    h = 16
    w = {"w_in": rng.randn(E, D, h).astype(np.float32) * 0.3,
         "b_in": rng.randn(E, h).astype(np.float32) * 0.1,
         "w_out": rng.randn(E, h, D).astype(np.float32) * 0.3,
         "b_out": rng.randn(E, D).astype(np.float32) * 0.1}
    xin = rng.randn(world, E, B_LOC, CAP, D).astype(np.float32)
    cot = rng.randn(world, E, B_LOC, CAP, D).astype(np.float32)
    return xin, w, cot


def _jmesh(d):
    return j_mesh(JMeshSpec(data=d), devices=jax.devices()[:d])


def _jax_ep():
    """The reference engine's one-device f32 run: its initial parameters,
    per-step sums and final canonical parameters."""
    eng = JEPLMEngine(j_gpt_lm(JGPTConfig(**GPT)), JSGD(0.9, 1e-2),
                      _jmesh(1), pad_token_id=0, donate=False)
    ts = eng.init_state(jax.random.PRNGKey(0))
    params = _np(ts.params)
    sums = []
    for ids in _ids():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), jnp.float32(LR))
        sums.append({key: float(v) for key, v in m.items()})
    return params, (sums, _np(eng.to_canonical(ts).params))


@pytest.fixture(scope="module")
def reference():
    params, run = _jax_ep()
    out = {"params": params, "ep": run}
    model = j_bert(CLASSES, JBertConfig(**BERT))
    ddp = JDDPEngine(model, JSGD(0.9, 1e-2), _jmesh(WORLD), donate=False,
                     expert_dispatch="hierarchical")
    ts = ddp.init_state(jax.random.PRNGKey(1))
    out["bert_params"], out["bert_state"] = _np(ts.params), _np(
        ts.model_state)
    out["ddp"] = _jax_bert_run(ddp, ts)
    gspmd = JDataParallelEngine(model, JSGD(0.9, 1e-2), _jmesh(WORLD),
                                donate=False)
    out["gspmd"] = _jax_bert_run(gspmd, gspmd.init_state(
        jax.random.PRNGKey(1)))
    return out


def _jax_bert_run(eng, ts):
    sums = []
    for ids, labels in _bert_batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids, labels),
                               jnp.float32(LR))
        sums.append({key: float(v) for key, v in m.items()})
    return sums, _np(ts.params)


@pytest.fixture(scope="module", autouse=True)
def _no_process_group_left():
    """The in-process CLI runs join a one-rank gloo world; it is closed
    when the module ends."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cli(directory, argv):
    cwd = os.getcwd()
    os.makedirs(directory, exist_ok=True)
    try:
        os.chdir(directory)
        return lm_cli.main(argv)["history"]
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """The ranks' results, and the port's one-rank CLI runs: a one-epoch
    checkpoint the ranks resume, and its two-epoch resume."""
    root = tmp_path_factory.mktemp("moe_ranks")
    _cli(root / "one", CLI + ["--epochs", "1", "--checkpoint-dir",
                              str(root / "ck")])
    shutil.copytree(root / "ck", root / "ck1")
    one_rank = _cli(root / "one", CLI + ["--epochs", "2", "--resume",
                                         "--checkpoint-dir",
                                         str(root / "ck1")])
    dirs, runs = [], []
    for i, flags in enumerate(CLI_RUNS):
        shutil.copytree(root / "ck", root / f"ck_r{i}")
        dirs.append([str(root / f"run{i}_r{r}") for r in range(WORLD)])
        for d in dirs[-1]:
            os.makedirs(d)
        runs.append(("lm", CLI + flags + [
            "--epochs", "2", "--resume", "--checkpoint-dir",
            str(root / f"ck_r{i}")], i))
    xin, w, cot = _ops_data(WORLD)
    got = ranks.spawn(WORLD, "moe_suite", dict(
        gpt=GPT, params=reference["params"], ids=_ids(), lr=LR, ops=OPS,
        xin=xin, w=w, cot=cot, ep=EP, ddp=DDP, bert=BERT, classes=CLASSES,
        bert_params=reference["bert_params"],
        bert_state=reference["bert_state"], bert_batches=_bert_batches(),
        save=str(root / "sharded"), restore=RESTORE,
        restore_dir=str(root / "sharded"),
        cli={"runs": runs, "dirs": dirs}), root)
    return {"ranks": got, "one_rank_cli": one_rank,
            "sharded": str(root / "sharded")}


def _close(got, want, budget=None, **tol):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        if budget is None:
            np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(
                path), **tol)
        else:
            np.testing.assert_allclose(
                g, w, rtol=budget, atol=budget * max(np.abs(w).max(), 1e-6),
                err_msg=jax.tree_util.keystr(path))


def _expected_ops(world):
    """The reference's expert FFN on every source's buffer, its input and
    weight gradients of sum(out * cot), and the dispatched buffers."""
    xin, w, cot = _ops_data(world)
    wj = jax.tree.map(jnp.asarray, w)

    def loss(w, xs):
        return sum(jnp.sum(jmoe.expert_ffn(w, xs[s]) * cot[s])
                   for s in range(world))

    ys = [np.asarray(jmoe.expert_ffn(wj, jnp.asarray(xin[s])))
          for s in range(world)]
    dw, dx = jax.grad(loss, argnums=(0, 1))(wj, jnp.asarray(xin))
    el = E // world
    z = [np.concatenate([xin[s][r * el:(r + 1) * el] for s in range(world)],
                        axis=1) for r in range(world)]
    return ys, np.asarray(dx), _np(dw), z


@pytest.mark.parametrize("case", OPS, ids=[
    f"S4-dcn{c[0]}-{'overlap' if c[1] else 'fused'}-{c[2]}" for c in OPS])
def test_exchange_matches_flat_and_the_reference_ffn(port, case):
    k, overlap, wire = case
    ys, dx, dw, z = _expected_ops(WORLD)
    el = E // WORLD
    budget = BUDGET[wire]
    xin = _ops_data(WORLD)[0]
    for r, res in enumerate(port["ranks"]):
        got = res["ops", case]
        if "z" in got:
            np.testing.assert_array_equal(got["z"], z[r])
            np.testing.assert_array_equal(got["flat"], z[r])
            np.testing.assert_array_equal(got["back"], xin[r])
            np.testing.assert_array_equal(got["flat_back"], xin[r])
        _close(got["y"], ys[r], budget, **TOL)
        _close(got["dx"], dx[r], budget, **TOL)
        _close(got["dw"], {n: v[r * el:(r + 1) * el] for n, v in dw.items()},
               budget, **TOL)
        ici = WORLD // k
        assert got["fwd_hops"] == exchange_permutes(ici, k)
        assert got["bwd_hops"] == exchange_permutes(ici, k)


def _sums_close(got, want, budget):
    for g, w in zip(got, want):
        assert g["count"] == w["count"]
        np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                   rtol=budget or TOL["rtol"])
        if budget is None:
            assert g["correct1"] == w["correct1"]


@pytest.mark.parametrize("config", EP, ids=["d{}-e{}-dcn{}-{}-{}-{}".format(
    *c) for c in EP])
def test_ep_engine_matches_reference(port, reference, config):
    """Metric sums on every rank and the gathered canonical parameters
    after 3 steps, against the reference engine's f32 run (its GSPMD
    layouts compute the same function; the compressed wires within
    their budgets of it)."""
    d, n, k, dispatch, overlap, wire = config
    want = reference["ep"]
    budget = BUDGET[wire]
    for res in port["ranks"]:
        got = res["ep", config]
        _sums_close(got["sums"], want[0], budget)
        _close(got["tree"]["params"], want[1], budget, **TOL)
        ways = n if dispatch == "gspmd" else d
        full = sum(v.size * 4 for b in want[1]["blocks"].values()
                   if "moe" in b for v in b["moe"]["experts"].values())
        assert got["expert_bytes"] * ways == full
        hops = (exchange_permutes(d // k, k) * 2 * 3
                if dispatch == "hierarchical" else 0)
        assert got["hops"] == hops  # one MoE layer, 3 steps
        assert got["grad_reductions"] == 3


def test_ep_ranks_hold_equal_replicated_state(port):
    """Every rank of a run gathers the same canonical tree (the replicated
    leaves stay bit-equal across the ranks)."""
    for config in EP:
        trees = [res["ep", config]["tree"] for res in port["ranks"]]
        for t in trees[1:]:
            for a, b in zip(jax.tree_util.tree_leaves(trees[0]),
                            jax.tree_util.tree_leaves(t)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("config", DDP, ids=lambda c: "-".join(map(str, c)))
def test_ddp_expert_dispatch_matches_reference(port, reference, config):
    """The DDP engines (per-rank aux loss, the reference's shard_map) with
    and without the hierarchical dispatch against the reference's
    hierarchical DDP engine; `DataParallelEngine` (the aux statistics
    summed over the ranks) against the reference's global-batch one."""
    sums, params = reference["gspmd" if config[0] == "gspmd" else "ddp"]
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(params)}
    for res in port["ranks"]:
        got = res["ddp", config]
        _sums_close(got["sums"], sums, None)
        assert len(got["params"]) == len(flat)
        for path, v in got["params"].items():
            key = "".join(f"['{p}']" for p in path.split("/"))
            np.testing.assert_allclose(v, flat[key], err_msg=path, **TOL)


def test_ep_sharded_checkpoint_restores_at_another_s(port):
    """The S 4 hierarchical state, saved in the sharded format after two
    steps, restored at gspmd (2, 2) and (1, 4) on the ranks and at S 1 in
    this process: the third step's sums and parameters equal the S 4
    run's."""
    want = port["ranks"][0]["saved_then"]
    got = []
    for config in RESTORE:
        got += [res["restored", config] for res in port["ranks"]]
    eng = ExpertParallelLMEngine(gpt_lm_model(GPTConfig(**GPT)),
                                 SGD(0.9, 1e-2), Mesh(1, None), device="cpu",
                                 dispatch="hierarchical", pad_token_id=0)
    like = eng.init_state(0)
    tree, _, _ = checkpointing.restore_checkpoint(port["sharded"],
                                                  eng.canonical_spec(like))
    ts = eng.from_canonical(tree, like)
    ts, m = eng.train_step(ts, *eng.shard_batch(_ids()[-1]), LR)
    got.append({"sums": [{k: float(v) for k, v in m.items()}],
                "tree": eng.to_canonical(ts)})
    for g in got:
        _sums_close(g["sums"], want["sums"], None)
        _close(g["tree"]["params"], want["tree"]["params"], **TOL)
        _close(g["tree"]["opt_state"], want["tree"]["opt_state"], **TOL)


@pytest.mark.parametrize("case", range(len(CLI_RUNS)),
                         ids=["_".join(f) for f in CLI_RUNS])
def test_cli_on_four_ranks_resumes_like_one_rank(port, case):
    """The LM CLI on 4 ranks (gspmd data 2 x expert 2; hierarchical +
    overlap over dcn 2 x ici 2), resumed from the port's one-rank MoE
    checkpoint: its second epoch equals the one-rank resume's (which
    `tests/test_torch_port_moe_cli.py` holds against the JAX CLI)."""
    want = port["one_rank_cli"][-1]
    for res in port["ranks"]:
        got = res["cli"][case]
        assert len(got) == 1
        for key in ("train", "val"):
            np.testing.assert_allclose(
                [got[0][key][m] for m in ("loss", "acc1", "count")],
                [want[key][m] for m in ("loss", "acc1", "count")],
                rtol=1e-5)
