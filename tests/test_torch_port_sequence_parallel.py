"""The port's sequence-parallel engines at N > 1 shards held against the
JAX package: `CausalLMSequenceParallelEngine` and `SequenceParallelEngine`
on `MeshSpec(data=D, seq=S[, dcn=K])` meshes of gloo ranks
(`tests/_torch_port_ranks.sp_suite`: one spawn for each world size),
the reference on as many virtual CPU devices of the same mesh, from the
same weights and batches, 3 SGD steps; then the LM CLI at `--seq-shards
2` against `--seq-shards 1`, its checkpoints across S and from the JAX
CLI, and its refusals against the JAX CLI's messages.

The LM configurations are a matrix over (D, S) = (1, 2), (2, 2), (1, 4)
that runs each attention and each gradient-reduction mode, plus (2 data
ranks as 2 slices, 2 shards) with the int8 cross-slice wire. Tolerances:
losses, parameters and SGD momentum rtol 1e-5 / atol 1e-6 with the f32
wire (the sums run in another order; the plain ring's backward is held
at the reference's sharded bar in `test_torch_port_ring_attention.py`),
the reference's trajectory budget with int8 (5e-2 on the losses); counts
and top-k counts equal.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.cli import lm as jlm_cli
from distributed_model_parallel_tpu.models import gpt as jgpt
from distributed_model_parallel_tpu.models.bert import (
    BertConfig as JBertConfig,
)
from distributed_model_parallel_tpu.parallel import sequence_parallel as jsp
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
from distributed_model_parallel_tpu_torch.parallel import (
    sequence_parallel as tsp,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh, MeshSpec
from distributed_model_parallel_tpu_torch.training.optim import SGD

TOL = dict(rtol=1e-5, atol=1e-6)
BUDGET = {"none": None, "int8": 5e-2}
GPT_KW = dict(vocab_size=64, dim=32, num_heads=4, ffn_dim=64,
              max_position=16, dropout_rate=0.0, pad_token_id=0)
BERT_KW = dict(vocab_size=67, hidden_size=32, num_layers=1, num_heads=4,
               intermediate_size=64, max_position=16, dropout_rate=0.0)
CLASSES, LR, BERT_LR = 4, 0.05, 0.05
# (data, seq, dcn, attention, grad_reduction, wire, layers)
LM_CONFIGS = {
    2: [(1, 2, 1, "ring", "monolithic", "none", 1),
        (1, 2, 1, "ulysses", "bucketed", "none", 1),
        (1, 2, 1, "ring_flash", "overlapped", "none", 2),
        (1, 2, 1, "ulysses_flash", "monolithic", "none", 1)],
    4: [(2, 2, 1, "ring_flash", "monolithic", "none", 1),
        (2, 2, 1, "ring", "bucketed", "none", 1),
        (2, 2, 1, "ulysses", "overlapped", "none", 2),
        (1, 4, 1, "ulysses_flash", "bucketed", "none", 1),
        (1, 4, 1, "ring", "overlapped", "none", 2),
        (2, 2, 2, "ring_flash", "bucketed", "int8", 1)],
}
BERT_CONFIGS = [(2, 2, "ring"), (2, 2, "ulysses")]
# Collective matmul (the FFN pair on the rings over 'seq'), each config
# also run above without it.
LM_CM_CONFIGS = [LM_CONFIGS[2][0], LM_CONFIGS[2][2]]
BERT_CM_CONFIGS = [BERT_CONFIGS[0]]


@pytest.fixture(scope="module", autouse=True)
def _no_process_group_left():
    """The in-process CLI runs below join a one-rank gloo world; it is
    closed when the module ends, so later tests in this worker start
    with none."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ids():
    """3 global batches of 4 sequences of 16 tokens, pad (0) tails."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(3):
        ids = rng.randint(1, 64, size=(4, 16)).astype(np.int32)
        ids[i % 4, -3:] = 0
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


def _jmesh(d, s, k=1):
    return j_mesh(JMeshSpec(data=d, seq=s, dcn=k),
                  devices=jax.devices()[:d * s])


def _gpt(layers):
    return jgpt.GPTConfig(**GPT_KW, num_layers=layers)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for layers in (1, 2):
        eng = jsp.CausalLMSequenceParallelEngine(
            _gpt(layers), JSGD(0.9, 1e-2), _jmesh(1, 1), donate=False)
        out[layers] = _np(eng.init_state(jax.random.PRNGKey(0)).params)
    bert = jsp.SequenceParallelEngine(JBertConfig(**BERT_KW), CLASSES,
                                      JSGD(), _jmesh(1, 1), donate=False)
    out["bert"] = _np(bert.init_state(jax.random.PRNGKey(0)).params)
    return out


@pytest.fixture(scope="module")
def port(weights, tmp_path_factory):
    base = {"gpt": GPT_KW, "gpt_params": {n: weights[n] for n in (1, 2)},
            "ids": _ids(), "lr": LR}
    return {
        2: ranks.spawn(2, "sp_suite", dict(
            base, lm=LM_CONFIGS[2], lm_cm=LM_CM_CONFIGS,
            dropout={"attention": "ring_flash", "params": weights[2]}),
            tmp_path_factory.mktemp("w2")),
        4: ranks.spawn(4, "sp_suite", dict(
            base, lm=LM_CONFIGS[4], bert=BERT_CONFIGS,
            bert_cm=BERT_CM_CONFIGS,
            bert_cfg=BERT_KW, classes=CLASSES, bert_params=weights["bert"],
            bert_batches=_bert_batches(), bert_lr=BERT_LR),
            tmp_path_factory.mktemp("w4")),
    }


def _close(got, want, **tol):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _jax_lm(config, **kw):
    d, s, k, attention, gr, wire, layers = config
    eng = jsp.CausalLMSequenceParallelEngine(
        _gpt(layers), JSGD(0.9, 1e-2), _jmesh(d, s, k), attention=attention,
        donate=False, grad_reduction=gr, bucket_mb=0.02,
        dcn_compression=wire, **kw)
    ts = eng.init_state(jax.random.PRNGKey(0))
    sums = []
    for ids in _ids():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), jnp.float32(LR))
        sums.append({k: float(v) for k, v in m.items()})
    return sums, _np(ts.params), _np(ts.opt_state.momentum)


@pytest.mark.parametrize("world,config", [
    (w, c) for w in (2, 4) for c in LM_CONFIGS[w]],
    ids=["d{}-s{}-dcn{}-{}-{}-{}-L{}".format(*c) for w in (2, 4)
         for c in LM_CONFIGS[w]])
def test_lm_engine_matches_reference(port, world, config):
    """Metric sums on every rank, the final parameters and the SGD
    momentum after 3 steps against the reference engine on the same
    (data, seq) mesh."""
    want_sums, want_p, want_mom = _jax_lm(config)
    budget = BUDGET[config[5]]
    for res in port[world]:
        got = res["lm", config]
        for g, w in zip(got["sums"], want_sums):
            assert g["count"] == w["count"]
            if budget is None:
                assert g["correct1"] == w["correct1"]
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                       rtol=budget or TOL["rtol"])
        if budget is None:
            _close(got["params"], want_p, **TOL)
            _close(got["momentum"], want_mom, **TOL)
        # monolithic: one all-reduce of the world a step; otherwise the
        # seq all-reduce (one a backward segment) and the Reducer's
        assert got["collectives"] >= 3


def test_lm_monolithic_is_one_all_reduce_a_step(port):
    for world in (2, 4):
        for config in LM_CONFIGS[world]:
            if config[4] == "monolithic" and config[5] == "none":
                assert all(r["lm", config]["collectives"] == 3
                           for r in port[world])


@pytest.mark.parametrize("config", LM_CM_CONFIGS,
                         ids=["d{}-s{}-dcn{}-{}-{}-{}-L{}".format(*c)
                              for c in LM_CM_CONFIGS])
def test_lm_collective_matmul_matches_reference_and_plain(port, config):
    """`collective_matmul=True` (the FFN pair on the rings over the seq
    ranks) at S 2: metric sums, parameters and momentum after 3 steps
    against the reference engine with the same flag, and against the
    port's run of the same config without it (same math, another
    summation order: the f32 bar)."""
    want_sums, want_p, want_mom = _jax_lm(config, collective_matmul=True)
    for res in port[2]:
        got, plain = res["lm_cm", config], res["lm", config]
        for g, w, p in zip(got["sums"], want_sums, plain["sums"]):
            assert g["count"] == w["count"] == p["count"]
            assert g["correct1"] == w["correct1"]
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                       rtol=TOL["rtol"])
            np.testing.assert_allclose(g["loss_sum"], p["loss_sum"],
                                       rtol=TOL["rtol"])
        for want in (want_p, plain["params"]):
            _close(got["params"], want, **TOL)
        for want in (want_mom, plain["momentum"]):
            _close(got["momentum"], want, **TOL)


def _jax_bert(config, **kw):
    d, s, attention = config
    eng = jsp.SequenceParallelEngine(JBertConfig(**BERT_KW), CLASSES,
                                     JSGD(), _jmesh(d, s),
                                     attention=attention, donate=False, **kw)
    ts = eng.init_state(jax.random.PRNGKey(0))
    want = []
    for ids, labels in _bert_batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids, labels),
                               jnp.float32(BERT_LR))
        want.append({k: float(v) for k, v in m.items()})
    return want, _np(ts.params)


@pytest.mark.parametrize("config", BERT_CM_CONFIGS,
                         ids=["d{}-s{}-{}".format(*c)
                              for c in BERT_CM_CONFIGS])
def test_bert_collective_matmul_matches_reference_and_plain(port, config):
    """`SequenceParallelEngine(collective_matmul=True)` at (2, 2): 3 SGD
    steps against the reference engine with the flag and the port's run
    without it."""
    want, want_p = _jax_bert(config, collective_matmul=True)
    for res in port[4]:
        got, plain = res["bert_cm", config], res["bert", config]
        for g, w, p in zip(got["sums"], want, plain["sums"]):
            assert (g["count"], g["correct1"]) == (w["count"], w["correct1"])
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], **TOL)
            np.testing.assert_allclose(g["loss_sum"], p["loss_sum"], **TOL)
        _close(got["params"], want_p, **TOL)
        _close(got["params"], plain["params"], **TOL)


def test_collective_matmul_refuses_an_ffn_width_off_the_ring():
    """The FFN width must split over the seq ranks (the reference's
    message, at construction)."""
    cfg = GPTConfig(**dict(GPT_KW, num_layers=1, ffn_dim=63))
    with pytest.raises(ValueError) as got:
        tsp.CausalLMSequenceParallelEngine(
            cfg, SGD(), device="cpu", mesh=Mesh(1, None, seq=2),
            collective_matmul=True)
    with pytest.raises(ValueError) as want:
        jsp._seq_matmul_policy(True, 63, 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("config", BERT_CONFIGS,
                         ids=["d{}-s{}-{}".format(*c) for c in BERT_CONFIGS])
def test_bert_engine_matches_reference(port, weights, config):
    """`SequenceParallelEngine` (the [CLS] loss on seq shard 0) against
    the reference engine, 3 SGD steps on padded batches."""
    d, s, attention = config
    eng = jsp.SequenceParallelEngine(JBertConfig(**BERT_KW), CLASSES,
                                     JSGD(), _jmesh(d, s),
                                     attention=attention, donate=False)
    ts = eng.init_state(jax.random.PRNGKey(0))
    want = []
    for ids, labels in _bert_batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(ids, labels),
                               jnp.float32(BERT_LR))
        want.append({k: float(v) for k, v in m.items()})
    for res in port[4]:
        got = res["bert", config]
        for g, w in zip(got["sums"], want):
            assert (g["count"], g["correct1"]) == (w["count"], w["correct1"])
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], **TOL)
        _close(got["params"], _np(ts.params), **TOL)


def test_dropout_differs_across_shards_and_is_deterministic(port):
    """Dropout 0.1 at S 2: the two shards draw different masks from the
    key of (step, data index, seq index); two runs from the same weights
    are bit-equal, and a run under remat (the ring hops replayed in the
    backward on both ranks) equals them bit for bit."""
    a, b = (r["mask"] for r in port[2])
    assert a.shape == b.shape and not np.array_equal(a, b)
    assert 0.8 < (a > 0).mean() < 0.98
    for res in port[2]:
        first, again, remat = res["dropout_runs"]
        for other in (again, remat):
            assert other["sums"] == first["sums"]
            for g, w in zip(jax.tree_util.tree_leaves(other["params"]),
                            jax.tree_util.tree_leaves(first["params"])):
                np.testing.assert_array_equal(g, w)
    losses = [s["loss_sum"] for s in port[2][0]["dropout_runs"][0]["sums"]]
    assert np.isfinite(losses).all()


def test_shard_batch_refuses_overlong_sequences_with_the_reference_message():
    cfg = GPTConfig(**dict(GPT_KW, num_layers=1))
    eng = tsp.CausalLMSequenceParallelEngine(cfg, SGD(), device="cpu",
                                             mesh=Mesh(1, None))
    ids = np.ones((2, 32), np.int32)
    with pytest.raises(ValueError) as got:
        eng.shard_batch(ids)
    with pytest.raises(ValueError) as want:
        jsp._check_seq_len(ids, 16, "GPTConfig")
    assert str(got.value) == str(want.value)
    eng.shard_batch(ids[:, :16])  # the boundary passes


def test_mesh_refuses_model_with_seq():
    with pytest.raises(ValueError, match="make_plan_mesh"):
        MeshSpec(model=2, seq=2).resolve(4)
    assert MeshSpec(seq=2).resolve(4) == 2
    assert MeshSpec(seq=2, dcn=2).resolve(4) == 2
    with pytest.raises(ValueError, match=r"seq=3\) must divide the world"):
        MeshSpec(seq=3).resolve(4)


# ----------------------------------------------------------------- CLI

CLI = ["--device", "cpu", "--vocab-size", "64", "--dim", "32", "--layers",
       "2", "--heads", "4", "--seq-len", "32", "-b", "4", "--corpus-tokens",
       "2048", "--steps-per-epoch", "3", "--lr", "3e-3", "--optimizer",
       "sgd", "--attention", "ring_flash"]


def _records(history):
    return [(h["train"]["loss"], h["val"]["loss"], h["train"]["count"])
            for h in history]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """At --seq-shards 2 on 2 gloo ranks: two straight epochs; one epoch
    in the sharded format (resumed at S 1 below); and a resume from the
    JAX CLI's checkpoint written at --seq-shards 2."""
    root = tmp_path_factory.mktemp("cli")
    jdir = root / "jax_ckpt"
    cwd = os.getcwd()
    os.chdir(root)
    try:
        # the format does not depend on the attention: the plain ring
        # compiles fastest
        jlm_cli.main(CLI[2:-1] + ["ring", "--epochs", "1", "--seq-shards",
                                  "2", "--checkpoint-dir", str(jdir)])
    finally:
        os.chdir(cwd)
    shutil.copytree(jdir, root / "jax_ckpt_s1")  # the S 1 resume's copy
    dirs = [[str(root / f"{w}r{r}") for r in range(2)] for w in range(3)]
    for ds in dirs:
        for d in ds:
            os.makedirs(d)
    s2 = CLI + ["--seq-shards", "2"]
    runs = [("lm", s2 + ["--epochs", "2", "--checkpoint-dir",
                         str(root / "a")], 0),
            ("lm", s2 + ["--epochs", "1", "--checkpoint-format", "sharded",
                         "--checkpoint-dir", str(root / "sharded")], 1),
            ("lm", s2 + ["--epochs", "2", "--resume", "--checkpoint-dir",
                         str(jdir)], 2)]
    out = ranks.spawn(2, "cli_suite", {"runs": runs, "dirs": dirs}, root)
    return {"root": root, "ranks": out}


def _s1(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    return lm_cli.main(CLI + extra)["history"]


def test_cli_seq_shards_2_matches_seq_shards_1(cli_runs, tmp_path,
                                               monkeypatch):
    want = _records(_s1(tmp_path, monkeypatch, [
        "--epochs", "2", "--checkpoint-dir", str(tmp_path / "c")]))
    for res in cli_runs["ranks"]:
        got = _records(res[0])
        assert [r[2] for r in got] == [r[2] for r in want]
        np.testing.assert_allclose([r[:2] for r in got],
                                   [r[:2] for r in want], **TOL)


def test_cli_sharded_checkpoint_at_s2_resumes_at_s1(cli_runs, tmp_path,
                                                    monkeypatch):
    """Rank 0 alone writes the replicated state; the manifest records the
    seq axis; a one-rank run resumes it and its second epoch equals the
    straight S 2 run's."""
    sharded = cli_runs["root"] / "sharded"
    manifest = json.loads((sharded / "ckpt.manifest.json").read_text())
    assert manifest["mesh"]["axes"]["seq"] == 2
    assert manifest["mesh"]["axes"]["data"] == 1
    resumed = _s1(tmp_path, monkeypatch, [
        "--epochs", "2", "--resume", "--checkpoint-dir", str(sharded)])
    assert len(resumed) == 1
    straight = _records(cli_runs["ranks"][0][0])
    np.testing.assert_allclose(_records(resumed)[0][:2], straight[1][:2],
                               **TOL)


def test_cli_resumes_a_jax_sequence_parallel_checkpoint(cli_runs, tmp_path,
                                                        monkeypatch):
    """The JAX CLI's checkpoint at --seq-shards 2 resumes in the port at
    S 2 (its one remaining epoch) and at S 1, to the same numbers."""
    got = [_records(r[2]) for r in cli_runs["ranks"]]
    assert len(got[0]) == 1 and got[0] == got[1]
    jdir = cli_runs["root"] / "jax_ckpt_s1"
    s1 = _records(_s1(tmp_path, monkeypatch, [
        "--epochs", "2", "--resume", "--checkpoint-dir", str(jdir)]))
    np.testing.assert_allclose([r[:2] for r in got[0]], [r[:2] for r in s1],
                               **TOL)


def _jax_exit(argv):
    with pytest.raises(SystemExit) as e:
        jlm_cli.main(argv)
    return str(e.value)


@pytest.mark.parametrize("flags", [
    ["--seq-shards", "4", "--seq-len", "30"],
    ["--pipeline-stages", "2", "--seq-shards", "2"],
    ["--collective-matmul"],
])
def test_cli_refusals_match_the_jax_cli(flags):
    base = ["--layers", "2", "-b", "4"]
    want = _jax_exit(base + flags)
    with pytest.raises(SystemExit) as got:
        lm_cli.main(["--device", "cpu"] + base + flags)
    assert str(got.value) == want


def test_cli_refuses_ulysses_heads_with_the_reference_message():
    with pytest.raises(SystemExit) as got:
        lm_cli.main(["--device", "cpu", "--heads", "3", "--dim", "24",
                     "--seq-shards", "2", "--attention", "ulysses"])
    assert str(got.value) == ("ulysses needs heads (3) divisible by 'seq' "
                              "axis size (2)")
    # --collective-matmul at two shards passes the checks the reference's
    # refuses it by (its runs: the engine tests above).
    from distributed_model_parallel_tpu_torch.cli.common import (
        check_seq_shard_args,
    )

    check_seq_shard_args(lm_cli.build_parser().parse_args(
        ["--seq-shards", "2", "--collective-matmul"]))
