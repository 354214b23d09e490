"""The port's causal-LM training slice held against the JAX package.

Pieces: the synthetic corpus and loader (bit-identical), the metrics,
SGD/AdamW and the LR schedule, train-mode dropout, `lm_targets` /
`lm_loss`, the CLI's flag surface, and the engine: the JAX
`CausalLMSequenceParallelEngine` on a one-device (data=1, seq=1) mesh
against the port's engine, with the same `gpt_lm` parameters carried
across by `models/convert.from_jax_params`, dropout 0 and the same
batches.

Tolerances:
* engine, f32: per-step loss and metric sums rtol 1e-5; parameters after
  3 SGD steps rtol 1e-5 atol 1e-6; AdamW losses rtol 1e-5 (the repo's
  f32 parity bar; sums run in another order in the two frameworks).
* engine, bf16 (one step): loss rtol 5e-2 and updated parameters
  rtol/atol 5e-2, the bf16 forward bar of tests/test_pallas_attention.py.
* optimizers on fixed parameters and gradients: rtol 1e-6 (same f32
  operations in the same order; pow/sqrt may differ by an ulp).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.data import lm as jlm
from distributed_model_parallel_tpu.models import gpt as jgpt
from distributed_model_parallel_tpu.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine as JaxEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec, make_mesh
from distributed_model_parallel_tpu.training import metrics as jmetrics
from distributed_model_parallel_tpu.training import optim as joptim
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.cli.common import check_lm_args
from distributed_model_parallel_tpu_torch.data import lm as tlm
from distributed_model_parallel_tpu_torch.models import gpt as tgpt
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training import metrics as tmetrics
from distributed_model_parallel_tpu_torch.training import optim as toptim
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

CFG_KW = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
              max_position=32, dropout_rate=0.0, pad_token_id=0)
BATCH, SEQ, STEPS, LR = 4, 32, 3, 0.05
F32 = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- data


def test_corpus_and_entropy_bit_identical():
    for kw in (dict(seed=3), dict(seed=3, stream_seed=9)):
        np.testing.assert_array_equal(
            tlm.synthetic_corpus(97, 3000, **kw),
            jlm.synthetic_corpus(97, 3000, **kw))
    assert tlm.chain_entropy(97, seed=3) == jlm.chain_entropy(97, seed=3)


def test_loader_batches_identical():
    corpus = jlm.synthetic_corpus(50, 2000, seed=1)
    for shuffle in (True, False):
        a = tlm.LMLoader(corpus, 4, 16, shuffle=shuffle, seed=2)
        b = jlm.LMLoader(corpus, 4, 16, shuffle=shuffle, seed=2)
        assert len(a) == len(b)
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            for (x, y), (u, w) in zip(a, b):
                np.testing.assert_array_equal(x, u)
                np.testing.assert_array_equal(y, w)


# ------------------------------------------------------------- metrics


def test_cross_entropy_and_topk_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 7).astype(np.float32) * 3
    labels = rng.randint(0, 7, size=40).astype(np.int32)
    labels[::5] = -1
    tl, tt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(
        float(tmetrics.cross_entropy(tl, tt)),
        float(jmetrics.cross_entropy(logits, labels)), rtol=1e-6)
    for k in (1, 5, 9):
        assert float(tmetrics.topk_correct(tl, tt, k)) == float(
            jmetrics.topk_correct(jnp.asarray(logits), labels, k))
    assert float(tmetrics.valid_count(tt)) == 32.0


def test_lm_targets_and_loss_match_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 20, size=(3, 12)).astype(np.int32)
    ids[0, 5:] = 0  # padding
    np.testing.assert_array_equal(tgpt.lm_targets(ids, pad_token_id=0),
                                  jgpt.lm_targets(ids, pad_token_id=0))
    np.testing.assert_array_equal(tgpt.lm_targets(ids.astype(np.uint8)),
                                  jgpt.lm_targets(ids.astype(np.uint8)))
    logits = rng.randn(3, 12, 20).astype(np.float32)
    for pad in (None, 0):
        np.testing.assert_allclose(
            float(tgpt.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(ids).long(), pad)),
            float(jgpt.lm_loss(jnp.asarray(logits), jnp.asarray(ids), pad)),
            rtol=1e-6)
    cfg = tgpt.GPTConfig(**CFG_KW)
    assert tgpt.lm_loss_fn(cfg).keywords == {"pad_token_id": 0}


# ---------------------------------------------------------- optimizers


def _tree(rng):
    return {"a": rng.randn(3, 4).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float32)}}


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_updates_match_jax_over_three_steps(name):
    rng = np.random.RandomState(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    if name == "sgd":
        jopt, topt = joptim.SGD(0.9, 1e-2), toptim.SGD(0.9, 1e-2)
    else:
        jopt, topt = joptim.AdamW(weight_decay=0.1), toptim.AdamW(
            weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = toptim.tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        lr = np.float32(0.1 / (step + 1))
        jp, js = jopt.update(jp, js, jax.tree.map(jnp.asarray, g),
                             jnp.float32(lr))
        tp, ts = topt.update(tp, ts, toptim.tree_map(torch.from_numpy, g),
                             float(lr))
        for a, b in zip(toptim.tree_leaves(tp),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if name == "adamw":
        assert int(ts.count) == int(js.count) == 3


def test_cosine_warmup_schedule_matches_jax():
    """f32 on both sides; XLA's cos and the C library's cosf may differ
    by an ulp, a larger relative error where the cosine nears zero, so
    the bar adds atol 1e-8 (1e-7 of the base rates here)."""
    for base, t_max, warm in ((0.1, 10, 3), (3e-4, 4, 1)):
        jf = joptim.cosine_warmup_schedule(base, t_max, warm)
        tf = toptim.cosine_warmup_schedule(base, t_max, warm)
        for epoch in range(14):
            np.testing.assert_allclose(tf(epoch), float(jf(epoch)),
                                       rtol=1e-6, atol=1e-8)


def test_train_mode_dropout_keep_rate_and_scaling():
    """Dropout bits are a hash of (key, child path, flat index): the
    keep rate and scaling of inverted dropout, the same mask for the
    same key whether the key is a host int or a device scalar, other
    masks for another key or another child."""
    x = torch.ones(400, 500)
    key = L.fold_in(L.root_key(0), 3)
    y = L.dropout(x, 0.25, L.Context(train=True, rng=key))
    kept = y != 0
    # 200,000 Bernoulli(0.75) draws: 5 sigma is 0.0048.
    assert abs(float(kept.float().mean()) - 0.75) < 5e-3
    assert bool((y[kept] == 1.0 / 0.75).all())
    y2 = L.dropout(x, 0.25, L.Context(
        train=True, rng=L.fold_in(L.root_key(0), torch.tensor(3))))
    assert torch.equal(y, y2)  # same key (a tensor here), same mask
    for other in (L.Context(train=True, rng=L.fold_in(L.root_key(0), 4)),
                  L.Context(train=True, rng=key).child(1)):
        z = L.dropout(x, 0.25, other)
        assert abs(float(((z != 0) == kept).float().mean()) - 0.625) < 5e-3
    assert L.dropout(x, 0.25, L.Context(train=False)) is x
    assert L.dropout(x, 0.25, L.Context(train=True)) is x  # no key
    assert L.dropout(x, 0.0, L.Context(train=True, rng=key)) is x


# -------------------------------------------------------------- engine


def _batches(n):
    corpus = jlm.synthetic_corpus(CFG_KW["vocab_size"], BATCH * SEQ * n + 1,
                                  seed=5)
    loader = jlm.LMLoader(corpus, BATCH, SEQ, shuffle=False)
    return [ids for ids, _ in loader][:n]


_JAX_ENGINES = {}


def _jax_engine(attention, opt, dtype=None):
    """One compiled JAX engine per (attention, optimizer, dtype), shared
    across tests (interpret-mode compiles dominate this file's time)."""
    key = (attention, opt, dtype)
    if key not in _JAX_ENGINES:
        mesh = make_mesh(MeshSpec(data=1, seq=1), devices=jax.devices()[:1])
        jopt = (joptim.SGD(0.9, 1e-2) if opt == "sgd"
                else joptim.AdamW(weight_decay=1e-2))
        _JAX_ENGINES[key] = JaxEngine(
            jgpt.GPTConfig(**CFG_KW), jopt, mesh, attention=attention,
            donate=False, compute_dtype=dtype)
    return _JAX_ENGINES[key]


def _run_pair(attention, opt, steps, jdtype=None, tdtype=None):
    jeng = _jax_engine(attention, opt, jdtype)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jts.params)
    teng = CausalLMSequenceParallelEngine(
        tgpt.GPTConfig(**CFG_KW),
        toptim.SGD(0.9, 1e-2) if opt == "sgd"
        else toptim.AdamW(weight_decay=1e-2),
        attention=attention, compute_dtype=tdtype, device="cpu")
    tts = teng.state_from_params(from_jax_params(params))
    jm_all, tm_all = [], []
    for ids in _batches(steps):
        jts, jm = jeng.train_step(jts, *jeng.shard_batch(ids),
                                  jnp.float32(LR))
        tts, tm = teng.train_step(tts, *teng.shard_batch(ids),
                                  float(np.float32(LR)))
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: float(v) for k, v in tm.items()})
    return jm_all, tm_all, jax.tree.map(np.asarray, jts.params), \
        to_jax_params(tts.params)


@pytest.mark.parametrize("attention",
                         ["ring", "ring_flash", "ulysses", "ulysses_flash"])
def test_engine_three_sgd_steps_match_jax(attention):
    jm, tm, jp, tp = _run_pair(attention, "sgd", STEPS)
    for step, (a, b) in enumerate(zip(tm, jm)):
        assert a["count"] == b["count"] == BATCH * (SEQ - 1)
        for key in ("loss_sum", "correct1", "correct5"):
            np.testing.assert_allclose(a[key], b[key], err_msg=f"{step} {key}",
                                       **F32)
    assert tm[-1]["loss_sum"] < tm[0]["loss_sum"]
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jp),
            jax.tree_util.tree_leaves(tp)):
        np.testing.assert_allclose(got, want, err_msg=str(path), **PARAMS)


def test_engine_three_adamw_steps_match_jax():
    jm, tm, _, _ = _run_pair("ulysses_flash", "adamw", STEPS)
    np.testing.assert_allclose([m["loss_sum"] for m in tm],
                               [m["loss_sum"] for m in jm], **F32)


def test_engine_bf16_step_matches_jax_at_the_bf16_bar():
    jm, tm, jp, tp = _run_pair("ring_flash", "sgd", 1, jnp.bfloat16,
                               torch.bfloat16)
    np.testing.assert_allclose(tm[0]["loss_sum"], jm[0]["loss_sum"],
                               rtol=5e-2)
    for want, got in zip(jax.tree_util.tree_leaves(jp),
                         jax.tree_util.tree_leaves(tp)):
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("knob,value,slice_", [
    ("collective_matmul", True, "collective-matmul slice"),
    ("grad_reduction", "bucketed", "gradient-reduction slice"),
    ("dcn_compression", "int8", "gradient-reduction slice"),
    ("remat", True, "activation-rematerialization slice"),
])
def test_engine_refuses_later_slices(knob, value, slice_):
    """Knobs of later slices are refused, naming the slice; remat, whose
    slice is ported, builds an engine that checkpoints its blocks
    (tests/test_torch_port_remat.py holds its steps). The reducer's
    knobs are ported too: bucketed builds, a compressed wire needs a
    'dcn' axis (the reference's message). Collective matmul is ported:
    at one seq shard, as in the reference, it builds the FFN policy,
    whose one-rank ring is the plain dot, and a step equals the step
    without it (tests/test_torch_port_sequence_parallel.py holds it at
    two shards)."""
    if knob == "grad_reduction":
        eng = CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**CFG_KW), toptim.SGD(), device="cpu",
            **{knob: value})
        assert eng.grad_reduction == value
    elif knob == "dcn_compression":
        with pytest.raises(ValueError, match="carries no 'dcn' axis"):
            CausalLMSequenceParallelEngine(
                tgpt.GPTConfig(**CFG_KW), toptim.SGD(), device="cpu",
                **{knob: value})
    elif knob == "remat":
        eng = CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**CFG_KW), toptim.SGD(), device="cpu",
            **{knob: value})
        assert eng.remat is True
    else:
        from distributed_model_parallel_tpu_torch.ops.collective_matmul \
            import LocalCollectiveMatmul

        engines = [CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**CFG_KW), toptim.SGD(), device="cpu",
            mesh=Mesh(1, None), **{knob: cm}) for cm in (value, False)]
        assert isinstance(engines[0]._matmul, LocalCollectiveMatmul)
        ids = np.random.RandomState(0).randint(
            1, CFG_KW["vocab_size"], (2, 8)).astype(np.int32)
        sums = [eng.train_step(eng.init_state(0), *eng.shard_batch(ids),
                               0.1)[1] for eng in engines]
        assert float(sums[0]["loss_sum"]) == float(sums[1]["loss_sum"])
    # MoE stacks train under the expert-parallel LM engine; this one
    # refuses them with the reference's message.
    with pytest.raises(NotImplementedError, match="not supported by "
                       "CausalLMSequenceParallelEngine.*ExpertParallel"):
        CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**dict(CFG_KW, num_experts=4)), toptim.SGD(),
            device="cpu")


# ----------------------------------------------------------------- CLI

SMALL = ["--device", "cpu", "--vocab-size", "64", "--dim", "32",
         "--layers", "2", "--heads", "4", "--seq-len", "32", "-b", "4",
         "--corpus-tokens", "4096", "--lr", "3e-3"]


def test_cli_trains_on_cpu_and_the_loss_falls(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = lm_cli.main(SMALL + ["--epochs", "3", "--attention",
                               "ulysses_flash"])
    losses = [h["train"]["loss"] for h in out["history"]]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert out["loss_floor"] == jlm.chain_entropy(64, seed=0)
    # 512 val tokens = 16 windows = 4 batches of 4 x 31 targets
    assert out["history"][-1]["val"]["count"] == 4 * 4 * 31
    assert (tmp_path / "log" / "lm_4.txt").read_text().count("epoch") == 3
    # the best-val-acc model, saved by default, with the model's config
    meta = json.loads((tmp_path / "checkpoint" / "ckpt.json").read_text())
    assert meta["gpt_config"]["dim"] == 32 and meta["epoch"] >= 0
    assert "Saving.." in capsys.readouterr().out


def test_cli_defaults_to_cuda_and_refuses_without_a_gpu():
    assert lm_cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    with pytest.raises(SystemExit, match="--device cpu"):
        lm_cli.main(["--attention", "ring"])


@pytest.mark.parametrize("flags,slice_", [
    (["--plan", "pp2xdp2"], "composed-parallel-plan"),
    (["--auto-tune", "search"], "auto-tuning"),
    (["--seq-shards", "2"], "sequence-parallel"),
    (["--moe-experts", "4"], "expert-parallel"),
    (["--moe-dispatch", "hierarchical"], "expert-parallel"),
    (["--collective-matmul"], "collective-matmul"),
    (["--grad-reduction", "bucketed"], "gradient-reduction"),
    (["--dcn-slices", "2"], "gradient-reduction"),
    (["--dcn-compression", "int8"], "gradient-reduction"),
    (["--remat"], "activation-rematerialization"),
    (["--checkpoint-format", "sharded"], "sharded-checkpoint"),
    (["--async-save"], "sharded-checkpoint"),
    (["--steps-per-dispatch", "2"], "multi-step dispatch"),
    (["--profile-dir", "prof"], "profiler-capture"),
])
def test_cli_refuses_flags_of_later_slices(flags, slice_, monkeypatch,
                                           tmp_path):
    """Flags of later slices exit naming the slice. --remat,
    --steps-per-dispatch and --profile-dir, refused before their slice
    was ported, now reach the engine and the trainer as in the JAX CLI
    (tests/test_torch_port_remat.py, test_torch_port_multistep.py and
    test_torch_port_metrics.py hold what they do). --checkpoint-format
    sharded, refused before the sharded-checkpoint slice, now reaches
    the trainer's configuration, and --async-save alone exits with the
    JAX CLI's message (it needs the sharded format). --seq-shards 2,
    refused before the sequence-parallel slice, builds the (data 1, seq
    2) mesh on two gloo ranks; --collective-matmul, refused before the
    collective-matmul slice, exits with the JAX CLI's message at one
    shard and under --pipeline-stages, and passes the checks at two.
    --plan, refused before the composed-parallel-plan slice, meets the
    JAX CLI's device check. --auto-tune, refused before the auto-tuning
    slice, meets the reference's knob-flag refusals."""
    if flags[0] == "--async-save":
        with pytest.raises(SystemExit,
                           match="requires --checkpoint-format sharded"):
            lm_cli.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--plan":
        # Ported with the composed-parallel-plan slice: the plan needs
        # its four ranks (tests/test_torch_port_plan.py runs them).
        with pytest.raises(SystemExit, match=r"--plan pp2xdp2 needs 4 "
                                             r"device\(s\), 1 present"):
            lm_cli.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--auto-tune":
        # Ported with the auto-tuning slice (tuning/apply.py): the plan
        # owns the knobs, and each knob flag of the reference's list beside
        # --auto-tune exits with the reference's message.
        import ast

        from distributed_model_parallel_tpu.tuning import apply as japply

        tree = ast.parse(Path(japply.__file__).read_text())
        fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
                  and f.name == "auto_tune_lm")
        call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "_reject_explicit")
        knob_argv = {"--grad-reduction": ["--grad-reduction", "bucketed"],
                     "--bucket-mb": ["--bucket-mb", "4"],
                     "--overlap-stages": ["--overlap-stages", "2"],
                     "--dcn-compression": ["--dcn-compression", "int8"],
                     "--collective-matmul": ["--collective-matmul"],
                     "--moe-dispatch": ["--moe-dispatch", "hierarchical"],
                     "--moe-overlap": ["--moe-overlap"],
                     "--plan": ["--plan", "dp2"]}
        for flag in [e.elts[0].value for e in call.args[0].elts]:
            with pytest.raises(SystemExit) as e:
                lm_cli.main(["--device", "cpu", *flags, *knob_argv[flag]])
            with pytest.raises(SystemExit) as want:
                japply._reject_explicit([(flag, True)])
            assert str(e.value.code) == str(want.value.code)
        return
    if flags[0] == "--seq-shards":
        # Ported with the sequence-parallel slice: two gloo ranks build
        # the (data 1, seq 2) mesh, each with its seq index, and the
        # mesh's data x seq group holds both.
        got = ranks.spawn(2, "lm_engine_probe", {"argv": [
            "--device", "cpu", *flags, "--seq-len", "32"]}, tmp_path)
        assert [(r["data"], r["seq"], r["seq_index"], r["data_seq_ranks"])
                for r in got] == [(1, 2, 0, 2), (1, 2, 1, 2)]
        return
    if flags[0] == "--collective-matmul":
        # The JAX CLI's checks (a one-shard ring does nothing; stages
        # compute dense), and with two shards the flag passes them.
        with pytest.raises(SystemExit, match="set --seq-shards >= 2"):
            lm_cli.main(["--device", "cpu", *flags])
        with pytest.raises(SystemExit, match="no effect under "
                                             "--pipeline-stages"):
            lm_cli.main(["--device", "cpu", *flags, "--layers", "2",
                         "--pipeline-stages", "2"])
        check_lm_args(lm_cli.build_parser().parse_args(
            [*flags, "--seq-shards", "2"]))
        return
    if flags[0] == "--moe-dispatch":
        with pytest.raises(SystemExit, match="configures the MoE expert "
                           "exchange; it has no effect without "
                           "--moe-experts > 0"):
            lm_cli.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--moe-experts":
        got = {}

        class Built(Exception):
            pass

        def built(engine, train, val, cfg, **kw):
            got.update(engine=engine, cfg=cfg)
            raise Built

        monkeypatch.setattr(lm_cli, "Trainer", built)
        with pytest.raises(Built):
            lm_cli.main(["--device", "cpu", *flags])
        from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
            import ExpertParallelLMEngine

        assert isinstance(got["engine"], ExpertParallelLMEngine)
        assert got["engine"].dispatch == "gspmd"
        assert got["cfg"].checkpoint_extra["gpt_config"]["num_experts"] == 4
        return
    if flags[0] in ("--dcn-slices", "--dcn-compression"):
        # Ported with the gradient-reduction slice: one rank has no
        # second slice, and a compressed wire needs one.
        with pytest.raises(SystemExit, match=(
                r"dcn=2 must divide the data axis \(1\)"
                if flags[0] == "--dcn-slices" else "--dcn-slices >= 2")):
            lm_cli.main(["--device", "cpu", *flags])
        return
    if slice_ not in ("activation-rematerialization", "multi-step dispatch",
                      "profiler-capture", "gradient-reduction",
                      "sharded-checkpoint"):
        with pytest.raises(SystemExit, match=f"not ported.*{slice_} slice"):
            lm_cli.main(["--device", "cpu", *flags])
        return
    seen = {}

    class Stop(Exception):
        pass

    def trainer(engine, train, val, cfg, **kw):
        seen.update(engine=engine, cfg=cfg)
        raise Stop

    monkeypatch.setattr(lm_cli, "Trainer", trainer)
    with pytest.raises(Stop):
        lm_cli.main(["--device", "cpu", *flags])
    cfg = seen["cfg"]
    assert seen["engine"].remat is (flags[0] == "--remat")
    assert seen["engine"].grad_reduction == (
        flags[1] if flags[0] == "--grad-reduction" else "monolithic")
    assert cfg.steps_per_dispatch == (2 if flags[0] ==
                                      "--steps-per-dispatch" else 1)
    assert cfg.profile_dir == ("prof" if flags[0] == "--profile-dir"
                               else None)
    assert cfg.checkpoint_format == (
        "sharded" if flags[0] == "--checkpoint-format" else "legacy")
