"""The port's checkpoint / resume slice held against the JAX package.

The port writes the JAX package's legacy format (`.npz` keyed by tree
path + `.json` sidecar), so a file written by either package resumes in
the other:

* round trips in the port are bit-exact (tinycnn DDP, MobileNetV2 with
  BN state, a 2-layer GPT with AdamW);
* JAX's `restore_checkpoint` reads a port-written file, and the sidecar's
  keys equal those JAX writes for the same model;
* a JAX trainer's checkpoint resumes in the port's trainer, whose next
  epoch follows the JAX resumed trainer's at the repo's bars: rtol 1e-4
  / atol 1e-5 for tinycnn on 8x8 images (`tests/test_torch_port_ddp.py`),
  rtol 1e-5 for the f32 GPT (`tests/test_torch_port_lm.py`);
* one epoch + resume equals two epochs straight, bit for bit, for the
  DP CLI (one rank and two gloo ranks, where rank 1 has no file and
  takes rank 0's by broadcast) and the LM CLI;
* the resume rules (the newer snapshot, missing files and leaves, wrong
  shapes, the epochs warning, an unknown format and --async-save
  without the sharded format refused);
* `serve --checkpoint` gives the JAX serve CLI's greedy tokens on the
  same directory, written by either package, and its guard names the
  mismatched flag.

Every CLI run writes under `tmp_path`.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.cli import serve as jserve_cli
from distributed_model_parallel_tpu.data import datasets as jdatasets
from distributed_model_parallel_tpu.data import lm as jlm
from distributed_model_parallel_tpu.data.loader import Loader as JLoader
from distributed_model_parallel_tpu.models import gpt as jgpt
from distributed_model_parallel_tpu.models import mobilenet_v2 as j_mobilenet_v2
from distributed_model_parallel_tpu.models import tiny_cnn as j_tiny_cnn
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.parallel.data_parallel import (
    TrainState as JTrainState,
)
from distributed_model_parallel_tpu.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine as JLMEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu.training import checkpoint as jckpt
from distributed_model_parallel_tpu.training import optim as joptim
from distributed_model_parallel_tpu.training.trainer import (
    Trainer as JTrainer,
)
from distributed_model_parallel_tpu.training.trainer import (
    TrainerConfig as JTrainerConfig,
)
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.cli import serve as serve_cli
from distributed_model_parallel_tpu_torch.data import datasets as tdatasets
from distributed_model_parallel_tpu_torch.data import lm as tlm
from distributed_model_parallel_tpu_torch.data.loader import Loader
from distributed_model_parallel_tpu_torch.models import gpt as tgpt
from distributed_model_parallel_tpu_torch.models.convert import (
    to_jax_params,
    train_state_from_jax,
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
    mobilenet_v2,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.observability import (
    metrics,
    trace,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training import checkpoint as ckpt
from distributed_model_parallel_tpu_torch.training import optim as toptim
from distributed_model_parallel_tpu_torch.training.optim import tree_leaves
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

GPT_KW = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
              max_position=32, dropout_rate=0.0, pad_token_id=0)
CNN_TOL = dict(rtol=1e-4, atol=1e-5)
GPT_TOL = dict(rtol=1e-5)
ONE_RANK = Mesh(1, None)


def _images(seed, n=16, size=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, 10, n))


def _gpt_ids(seed=3):
    return tlm.synthetic_corpus(64, 4 * 32, seed=seed).reshape(4, 32)


def _trained(kind):
    """(port engine, its state after one train step)."""
    if kind == "gpt":
        eng = CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**GPT_KW), toptim.AdamW(), device="cpu")
        ts, _ = eng.train_step(eng.init_state(0), *eng.shard_batch(
            _gpt_ids()), 1e-3)
        return eng, ts
    if kind == "tinycnn":
        eng = DDPEngine(tiny_cnn(10), toptim.SGD(), mesh=ONE_RANK,
                        device="cpu")
        batch = _images(0)
    else:
        eng = DataParallelEngine(mobilenet_v2(10), toptim.SGD(),
                                 mesh=ONE_RANK, device="cpu")
        batch = _images(0, n=4, size=32)
    ts, _ = eng.train_step(eng.init_state(0), *eng.shard_batch(*batch), 0.1)
    return eng, ts


def _assert_states_equal(a, b):
    assert type(a.opt_state) is type(b.opt_state) and a.step == b.step
    for part in ("params", "model_state"):
        la = ckpt.flatten_tree(getattr(a, part))
        lb = ckpt.flatten_tree(getattr(b, part))
        assert la.keys() == lb.keys()
        for k in la:
            assert torch.equal(la[k], lb[k]), f"{part}/{k}"
            assert la[k].stride() == lb[k].stride(), f"{part}/{k} layout"
    la = ckpt.flatten_tree(a.opt_state._asdict())
    lb = ckpt.flatten_tree(b.opt_state._asdict())
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]) and la[k].dtype == lb[k].dtype, k


# ---------------------------------------------------------- round trips


@pytest.mark.parametrize("kind", ["tinycnn", "mobilenetv2", "gpt"])
def test_port_round_trip_is_bit_exact(kind, tmp_path):
    eng, ts = _trained(kind)
    path = ckpt.save_checkpoint(str(tmp_path), train_state_to_jax(ts),
                                acc=12.5, epoch=3)
    assert path.endswith("ckpt.npz")
    fresh = eng.init_state(1)
    tree, acc, epoch = ckpt.restore_checkpoint(
        str(tmp_path), train_state_spec(fresh))
    assert (acc, epoch) == (12.5, 3)
    back = train_state_from_jax(tree, fresh)
    _assert_states_equal(back, ts)
    assert all(p.requires_grad for p in tree_leaves(back.params))
    assert not list(tmp_path.glob("*.tmp"))


def _jax_state(kind):
    """The JAX TrainState an engine of `kind` holds at init (MobileNetV2's
    as zeros of its shapes: eager init of its 52 BN layers is slow)."""
    key = jax.random.PRNGKey(0)
    if kind == "gpt":
        params, state = jgpt.gpt_lm(jgpt.GPTConfig(**GPT_KW)).init(key)
        opt = joptim.AdamW().init(params)
    elif kind == "tinycnn":
        params, state = j_tiny_cnn(10).init(key)
        opt = joptim.SGD().init(params)
    else:
        params, state = jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype),
            jax.eval_shape(j_mobilenet_v2(10).init, key))
        opt = joptim.SGD().init(params)
    return JTrainState(params, state, opt, jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("kind", ["tinycnn", "mobilenetv2", "gpt"])
def test_port_file_reads_in_jax_with_the_keys_jax_writes(kind, tmp_path):
    eng, ts = _trained(kind)
    ckpt.save_checkpoint(str(tmp_path / "port"), train_state_to_jax(ts),
                         acc=1.0, epoch=0)
    jstate = _jax_state(kind)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, acc=1.0, epoch=0)
    keys = [json.loads((tmp_path / d / "ckpt.json").read_text())["keys"]
            for d in ("port", "jax")]
    assert keys[0] == keys[1]
    with np.load(tmp_path / "port" / "ckpt.npz") as p, \
            np.load(tmp_path / "jax" / "ckpt.npz") as j:
        for k in keys[1]:
            assert (p[k].shape, p[k].dtype) == (j[k].shape, j[k].dtype), k
    restored, acc, epoch = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                                    jstate)
    model = getattr(eng, "model", None)
    if model is None:
        want_p, want_s = to_jax_params(ts.params), {}
    else:
        want_p, want_s = to_jax_params(ts.params, model=model,
                                       state=ts.model_state)
    got = jax.tree.map(np.asarray, restored)
    for a, b in zip(jax.tree.leaves(got.params), jax.tree.leaves(want_p)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got.model_state),
                    jax.tree.leaves(want_s)):
        np.testing.assert_array_equal(a, b)
    assert int(got.step) == 1 and (acc, epoch) == (1.0, 0)


# ------------------------------------------- a JAX checkpoint, resumed


def _cnn_loaders(pkg):
    synthetic = (tdatasets if pkg == "port" else jdatasets).synthetic
    loader = Loader if pkg == "port" else JLoader
    kw = dict(mean=tdatasets.CIFAR10_MEAN, std=tdatasets.CIFAR10_STD,
              use_native=False)
    return (loader(synthetic(256, 8, 10, seed=1), 32, seed=0, **kw),
            loader(synthetic(64, 8, 10, seed=2), 32, shuffle=False,
                   drop_last=False, **kw))


def _lm_loaders(pkg):
    m = tlm if pkg == "port" else jlm
    corpus = m.synthetic_corpus(64, 2048, seed=0)
    val = m.synthetic_corpus(64, 512, seed=0, stream_seed=1)
    return (m.LMLoader(corpus, 4, 32, seed=0),
            m.LMLoader(val, 4, 32, shuffle=False, seed=0))


def _cfg(cls, tmp_path, directory, epochs, resume, lr):
    return cls(epochs=epochs, base_lr=lr, t_max=4, warmup_period=1,
               print_freq=0, log_dir=str(tmp_path / "log"),
               checkpoint_dir=str(directory), resume=resume, save_last=True,
               steps_per_epoch=3)


@pytest.mark.parametrize("kind", ["tinycnn", "gpt"])
def test_jax_checkpoint_resumes_in_the_port(kind, tmp_path):
    """JAX trains epoch 0 and saves; the JAX trainer and the port's
    trainer each resume a copy of that directory for epoch 1."""
    mesh = j_make_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    if kind == "tinycnn":
        jeng = JDDPEngine(j_tiny_cnn(10), joptim.SGD(), mesh, donate=False)
        teng = DDPEngine(tiny_cnn(10), toptim.SGD(), mesh=ONE_RANK,
                         device="cpu")
        loaders, lr, tol = _cnn_loaders, 0.1, CNN_TOL
    else:
        mesh = j_make_mesh(JMeshSpec(data=1, seq=1),
                           devices=jax.devices()[:1])
        jeng = JLMEngine(jgpt.GPTConfig(**GPT_KW), joptim.AdamW(), mesh,
                         attention="ring", donate=False)
        teng = CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**GPT_KW), toptim.AdamW(), device="cpu")
        loaders, lr, tol = _lm_loaders, 3e-3, GPT_TOL
    saved, for_port = tmp_path / "jax", tmp_path / "port"
    key = jax.random.PRNGKey(0)
    JTrainer(jeng, *loaders("jax"),
             _cfg(JTrainerConfig, tmp_path, saved, 1, False, lr),
             rng=key).fit()
    shutil.copytree(saved, for_port)
    jres = JTrainer(jeng, *loaders("jax"),
                    _cfg(JTrainerConfig, tmp_path, saved, 2, True, lr),
                    rng=key)
    tres = Trainer(teng, *loaders("port"),
                   _cfg(TrainerConfig, tmp_path, for_port, 2, True, lr))
    assert tres.start_epoch == jres.start_epoch == 1
    assert tres.best_acc == jres.best_acc
    jout, tout = jres.fit(), tres.fit()
    assert [h["epoch"] for h in tout["history"]] == [1]
    for part in ("train", "val"):
        np.testing.assert_allclose(tout["history"][0][part]["loss"],
                                   jout["history"][0][part]["loss"], **tol)
        assert (tout["history"][0][part]["count"]
                == jout["history"][0][part]["count"])
    want = jax.tree.map(np.asarray, jres.state.params)
    got = (to_jax_params(tres.state.params, model=teng.model)
           if kind == "tinycnn" else to_jax_params(tres.state.params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, **(tol if kind == "tinycnn"
                                            else dict(rtol=1e-5,
                                                      atol=1e-6)))
    assert tres.state.step == int(jres.state.step) == 6


# ------------------------------------------- resume equals a straight run


DP = ["--device", "cpu", "--model", "tinycnn", "--dataset-type",
      "Synthetic", "-b", "64", "--val-batch-size", "256",
      "--steps-per-epoch", "3", "--lr", "0.4", "--engine", "ddp"]
LM = ["--device", "cpu", "--vocab-size", "64", "--dim", "32", "--layers",
      "2", "--heads", "4", "--seq-len", "32", "-b", "4", "--corpus-tokens",
      "2048", "--lr", "3e-3", "--steps-per-epoch", "3", "--attention",
      "ulysses_flash"]


def _numbers(history):
    """An epoch record without its timings."""
    return [{part: {k: v for k, v in h[part].items()
                    if not k.endswith("_time")}
             for part in ("train", "val")} | {"epoch": h["epoch"],
                                              "best_acc": h["best_acc"]}
            for h in history]


@pytest.mark.parametrize("cli,flags", [(dp_cli, DP), (lm_cli, LM)],
                         ids=["data_parallel", "lm"])
def test_resume_equals_a_straight_run(cli, flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    straight = cli.main(flags + ["--epochs", "2", "--checkpoint-dir",
                                 "straight"])["history"]
    first = cli.main(flags + ["--epochs", "1", "--checkpoint-dir",
                              "split"])["history"]
    assert (tmp_path / "split" / "ckpt.npz").exists()
    resumed = cli.main(flags + ["--epochs", "2", "--checkpoint-dir",
                                "split", "--resume"])["history"]
    assert _numbers(first + resumed) == _numbers(straight)


def test_two_ranks_resume_from_rank_zeros_file(tmp_path):
    """Rank 1 has no checkpoint on its disk: rank 0's read reaches it by
    broadcast, and both ranks continue as a straight two-rank run."""
    runs = {}
    for name, extra in (("straight", ["--epochs", "2"]),
                        ("split", ["--epochs", "1"]),
                        ("resumed", ["--epochs", "2", "--resume"])):
        base = tmp_path / ("straight" if name == "straight" else "split")
        dirs = [base / "r0", base / "r1"]
        for d in dirs:
            d.mkdir(parents=True, exist_ok=True)
        runs[name] = ranks.spawn(2, "cli_main", dict(
            dirs=[str(d) for d in dirs], argv=DP + ["--sync-bn"] + extra),
            tmp_path)
    assert (tmp_path / "split" / "r0" / "checkpoint" / "ckpt.npz").exists()
    assert not (tmp_path / "split" / "r1" / "checkpoint").exists()
    for rank in (0, 1):
        assert _numbers(runs["split"][rank]["history"]
                        + runs["resumed"][rank]["history"]) == _numbers(
            runs["straight"][rank]["history"])


# ----------------------------------------------------------- resume rules


def _write(directory, name, epoch, ts):
    ckpt.save_checkpoint(str(directory), train_state_to_jax(ts), acc=0.5,
                         epoch=epoch, name=name)


def test_newest_checkpoint_name_prefers_the_newer_epoch(tmp_path):
    _, ts = _trained("tinycnn")
    assert ckpt.newest_checkpoint_name(str(tmp_path)) == "ckpt"
    _write(tmp_path, "ckpt", 4, ts)
    _write(tmp_path, "last", 2, ts)  # stale: must not roll 'ckpt' back
    assert ckpt.newest_checkpoint_name(str(tmp_path)) == "ckpt"
    _write(tmp_path, "last", 4, ts)  # tie: 'last'
    assert ckpt.newest_checkpoint_name(str(tmp_path)) == "last"
    (tmp_path / "ckpt.json").write_text("not json")
    assert ckpt.checkpoint_epoch(str(tmp_path), "ckpt") is None
    assert ckpt.latest_exists(str(tmp_path), "last")
    assert not ckpt.latest_exists(str(tmp_path / "none"))


def _with_leaf(tree, path, leaf):
    """A copy of `tree` with the leaf at `path` set."""
    if not path:
        return leaf
    return dict(tree, **{path[0]: _with_leaf(tree.get(path[0], {}),
                                             path[1:], leaf)})


def test_restore_refuses_missing_files_leaves_and_shapes(tmp_path):
    eng, ts = _trained("tinycnn")
    spec = train_state_spec(ts)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore_checkpoint(str(tmp_path), spec)
    (tmp_path / "ckpt.manifest.json").write_text("{}")
    # The legacy reader names the unified one for a sharded directory.
    with pytest.raises(FileNotFoundError,
                       match="checkpointing.restore_checkpoint"):
        ckpt.restore_checkpoint(str(tmp_path), spec)
    _write(tmp_path, "ckpt", 0, ts)
    path, leaf = next(iter(ckpt.flatten_tree(spec["params"]).items()))
    wrong = _with_leaf(spec, ["params", *path.split("/")],
                       leaf._replace(shape=(1, 2)))
    with pytest.raises(ValueError, match=f"'params/{path}' has shape"):
        ckpt.restore_checkpoint(str(tmp_path), wrong)
    extra = _with_leaf(spec, ["params", "new_layer"], spec["step"])
    with pytest.raises(KeyError, match="params/new_layer"):
        ckpt.restore_checkpoint(str(tmp_path), extra)


def test_resume_past_the_last_epoch_warns_and_trains_nothing(tmp_path,
                                                            capsys):
    eng, ts = _trained("tinycnn")
    _write(tmp_path, "ckpt", 3, ts)
    train, val = _cnn_loaders("port")
    cfg = TrainerConfig(epochs=3, print_freq=0, log_dir=str(tmp_path),
                        checkpoint_dir=str(tmp_path), resume=True)
    trainer = Trainer(eng, train, val, cfg)
    assert (trainer.start_epoch, trainer.best_acc) == (4, 0.5)
    assert trainer.fit()["history"] == []
    out = capsys.readouterr().out
    assert "Resumed from checkpoint: epoch 3" in out
    assert "fit() will train 0 epochs" in out


@pytest.mark.parametrize("knob", [dict(checkpoint_format="zarr"),
                                  dict(async_save=True)])
def test_trainer_refuses_the_sharded_format(knob):
    """Ported with the sharded-checkpoint slice: the trainer refuses what
    the reference's refuses, an unknown format and --async-save without
    the sharded one, with its messages."""
    eng, _ = _trained("tinycnn")
    with pytest.raises(ValueError, match=(
            "must be 'legacy' or 'sharded'" if "checkpoint_format" in knob
            else "requires checkpoint_format='sharded'")):
        Trainer(eng, [], None, TrainerConfig(**knob))


def test_saves_are_spanned_and_timed(tmp_path):
    """save_best writes 'ckpt' on a better val acc1 and save_last 'last'
    every epoch, each inside a `checkpoint_blocked` span that the
    `train_checkpoint_blocked_s` histogram times."""
    eng = DDPEngine(tiny_cnn(10), toptim.SGD(), mesh=ONE_RANK, device="cpu")
    train, val = _cnn_loaders("port")
    tracer, registry = trace.enable(), metrics.enable()
    try:
        cfg = TrainerConfig(epochs=2, print_freq=0, log_dir=str(tmp_path),
                            checkpoint_dir=str(tmp_path / "ck"),
                            save_last=True, steps_per_epoch=2,
                            checkpoint_extra={"note": "x"})
        out = Trainer(eng, train, val, cfg).fit()
        spans = [e for e in tracer.to_chrome()["traceEvents"]
                 if e["name"] == "checkpoint_blocked"]
        hist = registry.to_json()["histograms"]
    finally:
        trace.set_tracer(None)
        metrics.set_metrics(None)
    n_best = sum(1 for i, h in enumerate(out["history"])
                 if h["best_acc"] > (out["history"][i - 1]["best_acc"]
                                     if i else 0.0))
    assert len(spans) == 2 + n_best
    assert hist["train_checkpoint_blocked_s"]["count"] == 2 + n_best
    meta = json.loads((tmp_path / "ck" / "last.json").read_text())
    assert meta["epoch"] == 1 and meta["note"] == "x"
    assert meta["acc"] == out["best_acc"]


# ------------------------------------------------------ serve --checkpoint


SERVE = ["--vocab-size", "64", "--dim", "32", "--layers", "2", "--heads",
         "4", "--ffn-dim", "128", "--max-len", "32", "--prefill-len", "16",
         "--prompt-len-max", "16", "--num-requests", "4",
         "--max-new-tokens", "6"]
# The LM CLI's model at LM's flags (ffn 4 * dim), as serve sees it.
SERVE_GPT = dict(GPT_KW, ffn_dim=128)


def _tokens(out):
    return [r["tokens"] for r in out["requests"]]


def _written_by(writer, directory):
    if writer == "port":
        lm_cli.main(LM + ["--epochs", "1", "--checkpoint-dir",
                          str(directory)])
        return
    params, _ = jgpt.gpt_lm(jgpt.GPTConfig(**SERVE_GPT)).init(
        jax.random.PRNGKey(5))
    state = JTrainState(params, {}, joptim.AdamW().init(params),
                        jnp.zeros((), jnp.int32))
    recorded = {k: SERVE_GPT[k] for k in (
        "vocab_size", "dim", "num_layers", "num_heads", "ffn_dim",
        "max_position")}
    jckpt.save_checkpoint(str(directory), state, acc=1.0, epoch=0,
                          extra={"gpt_config": dict(recorded,
                                                    num_experts=0)})


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_serve_checkpoint_tokens_equal_the_jax_serve_cli(writer, mode,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "ck"
    _written_by(writer, d)
    flags = SERVE + ["--compute-dtype", mode]
    got = serve_cli.main(["--device", "cpu", "--checkpoint", str(d)]
                         + flags)
    want = jserve_cli.main(["--checkpoint", str(d)] + flags)
    assert got["serving"]["checkpoint"] == str(d)
    assert _tokens(got) == _tokens(want)
    fresh = serve_cli.main(["--device", "cpu"] + flags)
    assert _tokens(fresh) != _tokens(got)  # the checkpoint was served


def test_serve_checkpoint_guard_names_the_flag(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "ck"
    _written_by("port", d)
    base = ["--device", "cpu"] + SERVE + ["--checkpoint", str(d)]
    with pytest.raises(SystemExit, match="dim=32 .* adjust --dim"):
        serve_cli.main(base + ["--dim", "48"])
    with pytest.raises(SystemExit, match="adjust --max-len"):
        serve_cli.main(base + ["--max-len", "64"])
    meta = json.loads((d / "ckpt.json").read_text())
    meta["gpt_config"]["num_experts"] = 4
    (d / "ckpt.json").write_text(json.dumps(meta))
    with pytest.raises(SystemExit, match="Mixture-of-Experts"):
        serve_cli.main(base)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        serve_cli.main(["--device", "cpu"] + SERVE
                       + ["--checkpoint", str(tmp_path / "none")])
