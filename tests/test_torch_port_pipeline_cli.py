"""The port's `LMPipelineEngine`, MobileNetV2 pipeline, pipeline
checkpoints and pipeline CLIs held against the JAX package (helpers and
f32 / bf16 bars: `tests/test_torch_port_pipeline.py`).

* `LMPipelineEngine` at S = 2, M = 2 on a small GPT (dropout 0), gpipe
  and 1f1b: metric sums and every parameter after one step, f32 bar.
* MobileNetV2 at S = 4 with the reference's [3, 9, 15] split: its CIFAR
  head pools a 4x4 map, so 32x32 is its smallest input (the issue's 8x8
  cannot run it); bars in the test.
* Checkpoints: a file the JAX pipeline engine writes restores into the
  port's engine, and the port's into the JAX engine, with the same keys,
  shapes and dtypes, bit for bit.
* `cli.model_parallel` and `cli.lm --pipeline-stages` train on the CPU
  with a falling loss and save the best-val-acc model; every refusal
  names its slice or its reason.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_model_parallel_tpu.models.gpt as j_gpt
import distributed_model_parallel_tpu.models.mobilenetv2 as j_mobilenetv2
import distributed_model_parallel_tpu.models.tinycnn as j_tinycnn
import distributed_model_parallel_tpu.training.checkpoint as jckpt
from distributed_model_parallel_tpu.parallel.pipeline import (
    LMPipelineEngine as JLMPipelineEngine,
)
from distributed_model_parallel_tpu.parallel.pipeline import (
    PipelineEngine as JPipelineEngine,
)
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu.training.optim import AdamW as JAdamW
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.cli import model_parallel as mp_cli
from distributed_model_parallel_tpu_torch.models import gpt, mobilenetv2
from distributed_model_parallel_tpu_torch.models import tinycnn
from distributed_model_parallel_tpu_torch.models.convert import (
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    LMPipelineEngine,
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.training import checkpoint as ckpt
from distributed_model_parallel_tpu_torch.training.optim import SGD, AdamW
from test_torch_port_pipeline import (
    F32,
    LR,
    _batch,
    _jax_mesh,
    _np,
    _port_mesh,
    close_sums,
    close_trees,
    jax_step,
    port_state,
    port_step,
    port_trees,
)

DEEP = dict(rtol=5e-4, atol=5e-4)


def _norm_rel(got, want) -> float:
    d = sum(float(np.sum((np.asarray(g, np.float64) - w) ** 2))
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    n = sum(float(np.sum(np.asarray(w, np.float64) ** 2))
            for w in jax.tree.leaves(want))
    return (d / n) ** 0.5


def test_mobilenetv2_reference_split_matches_jax():
    """MobileNetV2 at S = 4, the reference's [3, 9, 15] split, M = 2,
    1f1b:
    metric sums and the new BN statistics elementwise at 5e-4; the
    parameter update (before - after) as a whole within three times the
    JAX engine's own movement when its input moves by 1e-6 relative, the
    methodology of `tests/test_torch_port_cnn.py` for the train-mode
    gradients of a deep BN net at random init, which are chaotic in
    f32."""
    images, labels = _batch(n=4, size=32)
    # 1f1b: the JAX gpipe program (autodiff through the tick scan) takes
    # twice as long to compile; gpipe == 1f1b is held on tinycnn above.
    kw = dict(num_microbatches=2, schedule="1f1b")
    eng = PipelineEngine(mobilenetv2.split_stages(4, 10,
                                                  boundaries=[3, 9, 15]),
                         SGD(), _port_mesh(4), **kw)
    # The port's seed-0 weights start both (the JAX engine's eager init of
    # 52 BN layers is slow on the CPU).
    start = port_trees(eng, eng.init_state(0))
    jeng = JPipelineEngine(
        j_mobilenetv2.split_stages(4, 10, boundaries=[3, 9, 15]), JSGD(),
        _jax_mesh(1, 4), donate=False, **kw)
    _, want_m, want = jax_step(jeng, images, labels, start)
    noise = np.random.RandomState(1).randn(*images.shape).astype(np.float32)
    _, _, moved = jax_step(jeng, images * (1 + 1e-6 * noise), labels, start)
    got_m, got = port_step(eng, start, images, labels)
    close_sums(got_m, want_m, **DEEP)
    close_trees(got[1], want[1], **DEEP)

    def update(after):
        return jax.tree.map(np.subtract, start[0], after)

    own = _norm_rel(update(moved[0]), update(want[0]))
    err = _norm_rel(update(got[0]), update(want[0]))
    assert err <= max(3 * own, 1e-5), (err, own)


GPT_KW = dict(vocab_size=64, dim=32, num_layers=4, num_heads=4, ffn_dim=64,
              max_position=16, dropout_rate=0.0, pad_token_id=0)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_lm_pipeline_step_matches_jax(schedule):
    """LMPipelineEngine at S = 2, M = 2 on a small GPT: the loss over the
    valid targets (pad and last positions excluded), and every parameter
    after one step."""
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 64, size=(4, 16)).astype(np.int32)
    ids[1, 10:] = 0  # padding
    kw = dict(num_microbatches=2, schedule=schedule, pad_token_id=0)
    jeng = JLMPipelineEngine(
        j_gpt.split_stages(2, j_gpt.GPTConfig(**GPT_KW)), JSGD(),
        _jax_mesh(1, 2), donate=False, **kw)
    start, want_m, want = jax_step(jeng, ids, ids)
    eng = LMPipelineEngine(gpt.split_stages(2, gpt.GPTConfig(**GPT_KW)),
                           SGD(), _port_mesh(2), **kw)
    got_m, got = port_step(eng, start, ids, ids)
    assert got_m["count"] == want_m["count"] == 4 * 15 - 6
    close_sums(got_m, want_m, **F32)
    close_trees(got, want, **F32)


# ------------------------------------------------------------ checkpoints


def _jax_tree(ts):
    """A JAX canonical TrainState as the dict tree the port writes."""
    return {"params": ts.params, "model_state": ts.model_state,
            "opt_state": ts.opt_state._asdict(), "step": ts.step}


@pytest.mark.parametrize("kind", ["tinycnn", "gpt"])
def test_jax_pipeline_file_restores_into_the_port(kind, tmp_path):
    """The JAX pipeline engine trains a step and saves (stage-local
    storage, canonical per-chunk tuples); the port's engine restores the
    file and holds the JAX state bit for bit, and writes the same keys,
    shapes and dtypes."""
    if kind == "gpt":
        jeng = JLMPipelineEngine(
            j_gpt.split_stages(2, j_gpt.GPTConfig(**GPT_KW)), JAdamW(),
            _jax_mesh(1, 2), num_microbatches=2, donate=False,
            stage_local_params=True, pad_token_id=0)
        eng = LMPipelineEngine(gpt.split_stages(2, gpt.GPTConfig(**GPT_KW)),
                               AdamW(), _port_mesh(2), num_microbatches=2,
                               pad_token_id=0)
        batch = (np.arange(64).reshape(4, 16) % 64,) * 2
    else:
        jeng = JPipelineEngine(j_tinycnn.split_stages(2, 10), JSGD(),
                               _jax_mesh(1, 2), num_microbatches=2,
                               donate=False, stage_local_params=True)
        eng = PipelineEngine(tinycnn.split_stages(2, 10), SGD(),
                             _port_mesh(2), num_microbatches=2)
        batch = _batch()
    jts = jeng.init_state(jax.random.PRNGKey(0))
    jts, _ = jeng.train_step(jts, *jeng.shard_batch(*batch),
                             jnp.float32(LR))
    canon = jeng.to_canonical(jts)
    jckpt.save_checkpoint(str(tmp_path / "jax"), canon, acc=7.0, epoch=2)
    fresh = eng.init_state(1)
    tree, acc, epoch = ckpt.restore_checkpoint(str(tmp_path / "jax"),
                                               train_state_spec(fresh))
    assert (acc, epoch) == (7.0, 2)
    ts = eng.from_canonical(tree, fresh)
    want = jax.tree.map(np.asarray, _jax_tree(canon))
    got = eng.to_canonical(ts)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ts.step == 1
    ckpt.save_checkpoint(str(tmp_path / "port"), got, acc=7.0, epoch=2)
    keys = [json.loads((tmp_path / d / "ckpt.json").read_text())["keys"]
            for d in ("port", "jax")]
    assert keys[0] == keys[1]


def test_port_pipeline_file_restores_into_jax(tmp_path):
    """The port's pipeline engine trains a step and saves; the JAX
    pipeline engine (replicated and stage-local storage) restores it and
    holds the port's state bit for bit."""
    eng = PipelineEngine(tinycnn.split_stages(2, 10), SGD(), _port_mesh(2),
                         num_microbatches=2, schedule="1f1b")
    ts, _ = eng.train_step(eng.init_state(0), *eng.shard_batch(*_batch()),
                           LR)
    tree = train_state_to_jax(ts)
    ckpt.save_checkpoint(str(tmp_path), tree, acc=3.5, epoch=1)
    for local in (False, True):
        jeng = JPipelineEngine(j_tinycnn.split_stages(2, 10), JSGD(),
                               _jax_mesh(1, 2), num_microbatches=2,
                               donate=False, stage_local_params=local)
        like = jeng.to_canonical(jeng.init_state(jax.random.PRNGKey(3)))
        restored, acc, epoch = jckpt.restore_checkpoint(str(tmp_path), like)
        assert (acc, epoch) == (3.5, 1)
        back = jeng.to_canonical(jeng.from_canonical(restored))
        got = jax.tree.map(np.asarray, _jax_tree(back))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ CLIs

MP = ["./data", "--device", "cpu", "--model", "tinycnn", "-type",
      "Synthetic", "-b", "64", "--epochs", "2", "--steps-per-epoch", "8",
      "--world-size", "2", "--microbatches", "2"]


@pytest.mark.parametrize("extra", [
    [], ["--pipeline-schedule", "interleaved", "--virtual-stages", "2"]])
def test_model_parallel_cli_trains_and_saves(extra, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    out = mp_cli.main(MP + extra)
    losses = [h["train"]["loss"] for h in out["history"]]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert out["history"][-1]["val"]["count"] > 0
    assert (tmp_path / "log" / "64.txt").read_text().count("epoch") == 2
    printed = capsys.readouterr().out
    assert "==> pipeline" in printed and "Saving.." in printed
    # the best-val-acc model, in the JAX pipeline engine's keys
    meta = json.loads((tmp_path / "checkpoint" / "ckpt.json").read_text())
    V = 2 if extra else 1
    jeng = JPipelineEngine(j_tinycnn.split_stages(2 * V, 10), JSGD(),
                           _jax_mesh(1, 2), num_microbatches=2, donate=False,
                           schedule="interleaved" if extra else "gpipe",
                           virtual_stages=V)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jeng.to_canonical(
        jeng.init_state(jax.random.PRNGKey(0))), acc=0.0, epoch=0)
    assert meta["keys"] == json.loads(
        (tmp_path / "jax" / "ckpt.json").read_text())["keys"]


def test_lm_cli_pipeline_trains(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = lm_cli.main([
        "--device", "cpu", "--dim", "32", "--layers", "4", "--heads", "4",
        "--seq-len", "32", "-b", "4", "--epochs", "2", "--lr", "3e-3",
        "--vocab-size", "64", "--corpus-tokens", "4096",
        "--pipeline-stages", "2", "--microbatches", "2",
        "--pipeline-schedule", "1f1b"])
    losses = [h["train"]["loss"] for h in out["history"]]
    assert losses[1] < losses[0]
    meta = json.loads((tmp_path / "checkpoint" / "ckpt.json").read_text())
    assert any(k.startswith("params/1/") for k in meta["keys"])


def test_model_parallel_cli_defaults_to_cuda_and_refuses_without_a_gpu():
    args = mp_cli.build_parser().parse_args(["./data"])
    assert (args.device, args.dist_backend, args.world_size) == (
        "cuda", "xla", 1)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    with pytest.raises(SystemExit, match="--device cpu"):
        mp_cli.main(["./data", "-type", "Synthetic", "--model", "tinycnn"])


@pytest.mark.parametrize("flags,match", [
    (["--remat"], "not ported.*activation-rematerialization slice"),
    (["--steps-per-dispatch", "2"], "not ported.*multi-step dispatch slice"),
    (["--profile-dir", "p"], "not ported.*profiler-capture slice"),
    (["--model", "bert"], "not ported.*transformer-classifier slice"),
    (["--model", "bert_tiny"], "not ported.*transformer-classifier slice"),
    (["--model", "vit"], "no pipeline stage builder"),
    (["-type", "Imagenet"], "not ported.*image-folder slice"),
    (["-type", "SyntheticText"], "not ported.*transformer-classifier slice"),
    (["--virtual-stages", "2"], "requires --pipeline-schedule interleaved"),
    (["--virtual-stages", "0"], "must be >= 1"),
    (["--pipeline-schedule", "interleaved", "--world-size", "1"],
     "needs >= 2 pipeline stages"),
    (["--pipeline-schedule", "interleaved", "--virtual-stages", "2",
      "--microbatches", "3"], "divisible by the stage count"),
    (["--reference-split"], "needs --world-size 4 and MobileNetV2"),
    (["--reference-split", "--world-size", "4", "--pipeline-schedule",
      "interleaved", "--virtual-stages", "2", "--microbatches", "4"],
     "cannot be combined with --virtual-stages"),
    (["--microbatches", "0"], "must be >= 1"),
    (["--world-size", "0"], "must be >= 1"),
    (["--microbatches", "3"], "not divisible by --microbatches 3"),
    (["--world-size", "5"], "cannot split into 5 chunks"),
])
def test_model_parallel_cli_refusals(flags, match, tmp_path, monkeypatch):
    """Bad pipeline flags exit with the JAX CLI's messages. --remat,
    --steps-per-dispatch, --profile-dir, --model bert / bert_tiny and
    -type SyntheticText, refused before their slice was ported, now
    build what the JAX CLI builds (the engine with remat, the trainer's
    dispatch group and profiler directory, the BERT stages, raw token-id
    loaders)."""
    monkeypatch.chdir(tmp_path)
    base = ["./data", "--device", "cpu", "--model", "tinycnn", "-type",
            "Synthetic", "-b", "64", "--world-size", "2"]
    if "image-folder" in match:
        # Ported: the type reads its tree under the data path.
        with pytest.raises(FileNotFoundError, match="data/train"):
            mp_cli.main(base + flags)
        return
    if "not ported" not in match:
        with pytest.raises(SystemExit, match=match):
            mp_cli.main(base + flags)
        return
    seen = {}

    class Stop(Exception):
        pass

    def trainer(engine, train, val, cfg, **kw):
        seen.update(engine=engine, cfg=cfg, train=train)
        raise Stop

    monkeypatch.setattr(mp_cli, "Trainer", trainer)
    with pytest.raises(Stop):
        mp_cli.main(base + flags)
    eng, cfg = seen["engine"], seen["cfg"]
    assert eng.remat is (flags[0] == "--remat")
    assert cfg.steps_per_dispatch == (2 if flags[0] ==
                                      "--steps-per-dispatch" else 1)
    assert cfg.profile_dir == ("p" if flags[0] == "--profile-dir" else None)
    if flags[0] == "--model":  # embeddings on stage 0, the head last
        p0, p1 = eng.init_state(0).params
        assert "word" in p0["0"] and "classifier" in p1[str(len(p1) - 1)]
    if flags[-1] == "SyntheticText":
        assert seen["train"].raw


@pytest.mark.parametrize("flags,match", [
    (["--pipeline-stages", "2", "--attention", "ulysses"],
     "--attention has no effect under --pipeline-stages"),
    (["--pipeline-stages", "2", "--collective-matmul"],
     "--collective-matmul decomposes the sequence-parallel engine's FFN "
     "collectives; it has no effect under --pipeline-stages"),
    (["--microbatches", "2"], "no effect without --pipeline-stages"),
    (["--pipeline-schedule", "1f1b"], "no effect without --pipeline-stages"),
    (["--virtual-stages", "2"], "no effect without --pipeline-stages"),
    (["--pipeline-stages", "2", "--microbatches", "0"], "must be >= 1"),
    (["--pipeline-stages", "3"], "3 chunks exceeds --layers 2"),
    (["--pipeline-stages", "2", "--virtual-stages", "2"],
     "requires --pipeline-schedule interleaved"),
    (["--pipeline-stages", "2", "--microbatches", "3"],
     "not divisible by --microbatches 3"),
])
def test_lm_cli_pipeline_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        lm_cli.main(["--device", "cpu", "--layers", "2", "-b", "4", *flags])


def test_model_parallel_cli_turns_tf32_off(monkeypatch):
    """After the CLI's prologue the card's f32 arithmetic is the f32
    path the tests hold (`cli/common.set_device_numerics`)."""

    class Prologue(Exception):
        pass

    def stop(*args, **kwargs):
        raise Prologue

    monkeypatch.setattr(mp_cli, "build_loaders", stop)
    flags = ((torch.backends.cuda.matmul, "allow_tf32", True),
             (torch.backends.cudnn, "allow_tf32", True),
             (torch.backends.cudnn, "deterministic", False),
             (torch.backends.cudnn, "benchmark", True))
    for obj, name, value in flags:
        monkeypatch.setattr(obj, name, value)
    with pytest.raises(Prologue):
        mp_cli.main(MP)
    assert [getattr(obj, name) for obj, name, _ in flags] == [
        False, False, True, False]
