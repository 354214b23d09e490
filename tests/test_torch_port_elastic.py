"""The port's elastic restart (`training/elastic.py`, `--max-restarts`)
held against the JAX package's.

* `backoff_schedule` equals the reference's.
* `elastic_fit` in both packages, on the same scripted trainers: a
  failed attempt is retried from `last` with resume=True, the budget
  is kept (the error re-raised after it), each restart's exception and
  backoff recorded, other exception types and KeyboardInterrupt
  propagate, and a `make_trainer(resume, topology)` receives the
  sharded checkpoint's saved topology.
* The CLI end to end on gloo ranks (`cli.data_parallel --engine fsdp
  --checkpoint-format sharded --async-save --max-restarts 1`, bert_tiny
  on SyntheticText, 4 AdamW steps an epoch of batch 64): a 2-rank launch
  trains epoch 0; a second 2-rank launch with `--resume` fails once at
  the start of epoch 2, restarts from `last` and finishes; a 4-rank
  launch resumes the first launch's file (the reference's resize: the
  manifest reports data 2). Each epoch record equals the reference
  CLI's straight run (its FSDP on the 8-device mesh) at the f32 bar
  (rtol 1e-5, atol 1e-6; the counts exactly). Token ids are not
  augmented, so the N ranks' strided shards of a step make up the one
  process's global batch (augmented images are drawn per rank); both
  packages run bert_tiny without dropout, whose masks are keyed by the
  rank and drawn from different generators; and the port starts from
  the reference CLI's initial weights.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.cli import common as jcommon
from distributed_model_parallel_tpu.cli import data_parallel as jdp_cli
from distributed_model_parallel_tpu.data import datasets as jdatasets
from distributed_model_parallel_tpu.training import elastic as jelastic
from distributed_model_parallel_tpu_torch import checkpointing
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.parallel.fsdp import FSDPEngine
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.training import elastic
from distributed_model_parallel_tpu_torch.training.optim import SGD
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

F32 = dict(rtol=1e-5, atol=1e-6)
VAL = 64
CLI = ["--model", "bert_tiny", "--dataset-type", "SyntheticText", "-b", "64",
       "--val-batch-size", "64", "--steps-per-epoch", "4", "--optimizer",
       "adamw", "--lr", "1e-3", "--engine", "fsdp", "--checkpoint-format",
       "sharded"]


@pytest.mark.parametrize("attempt,backoff,cap", [
    (1, 1.0, 60.0), (2, 1.0, 60.0), (5, 0.5, 60.0), (9, 1.0, 60.0),
    (3, 2.0, 5.0)])
def test_backoff_schedule_equals_the_reference(attempt, backoff, cap):
    assert elastic.backoff_schedule(attempt, backoff, cap) == \
        jelastic.backoff_schedule(attempt, backoff, cap)


def test_backoff_schedule_counts_from_one():
    for mod in (elastic, jelastic):
        with pytest.raises(ValueError, match="attempt counts from 1"):
            mod.backoff_schedule(0, 1.0, 60.0)


class _Dies:
    """A trainer stand-in whose fit() fails `n` times (shared count)."""

    def __init__(self, n, exc=RuntimeError):
        self.left, self.exc = n, exc

    def fit(self):
        if self.left:
            self.left -= 1
            raise self.exc("node lost")
        return {"best_acc": 1.0}


def _both(fn):
    """fn(module) for the port's and the reference's elastic module."""
    return [fn(mod) for mod in (elastic, jelastic)]


def test_elastic_fit_restarts_from_last_and_records_it():
    def run(mod):
        box, calls = _Dies(2), []
        out = mod.elastic_fit(lambda resume: (calls.append(resume), box)[1],
                              max_restarts=3, backoff_seconds=0.0,
                              jitter=lambda k: 0.0)
        return calls, out

    (calls, out), (jcalls, jout) = _both(run)
    assert calls == jcalls == [False, True, True]
    assert out == jout
    assert out["elastic"]["attempts"] == 3
    assert [r["error_type"] for r in out["elastic"]["restarts"]] == \
        ["RuntimeError"] * 2


def test_elastic_fit_gives_up_after_its_budget():
    def run(mod):
        box, calls = _Dies(5), []
        with pytest.raises(RuntimeError, match="node lost"):
            mod.elastic_fit(lambda resume: (calls.append(resume), box)[1],
                            max_restarts=2, backoff_seconds=0.0)
        return calls

    assert _both(run) == [[False, True, True]] * 2


@pytest.mark.parametrize("exc", [TypeError, KeyboardInterrupt])
def test_elastic_fit_lets_other_errors_through(exc):
    def run(mod):
        calls = []
        with pytest.raises(exc):
            mod.elastic_fit(lambda resume: (calls.append(resume),
                                            _Dies(1, exc))[1],
                            max_restarts=3, retry_on=(RuntimeError,),
                            backoff_seconds=0.0)
        return calls

    assert _both(run) == [[False]] * 2


def test_make_trainer_with_a_topology_gets_the_saved_mesh(tmp_path):
    eng = FSDPEngine(tiny_cnn(10), SGD(), device="cpu")
    checkpointing.save_sharded(str(tmp_path),
                               eng.to_canonical_sharded(eng.init_state(0)),
                               acc=0.0, epoch=3, name="last")
    seen, box = [], _Dies(1)
    out = elastic.elastic_fit(
        lambda resume, topology: (seen.append((resume, topology)), box)[1],
        max_restarts=1, backoff_seconds=0.0, checkpoint_dir=str(tmp_path))
    assert seen[0] == (False, None)
    assert seen[1][0] is True
    assert seen[1][1]["mesh_axes"]["data"] == 1
    assert seen[1][1]["epoch"] == 3
    assert out["elastic"]["restarts"][0]["backoff_s"] == 0.0


# ---------------------------------------------------------------- the CLI

def _numbers(record):
    return {part: {k: v for k, v in record[part].items()
                   if k not in ("batch_time", "data_time")}
            for part in ("train", "val")}


def _assert_epoch(got, want):
    g, w = _numbers(got), _numbers(want)
    for part in ("train", "val"):
        assert g[part]["count"] == w[part]["count"]
        for k in ("loss", "acc1", "acc5"):
            np.testing.assert_allclose(g[part][k], w[part][k], **F32,
                                       err_msg=f"{part} {k}")


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    # The reference's straight run: its FSDP on the 8-device mesh.
    mp = pytest.MonkeyPatch()
    init = jdatasets.DatasetCollection.init

    def cut(self):
        train, val = init(self)
        return train, jdatasets.ArrayDataset(
            val.images[:VAL], val.labels[:VAL], val.num_classes, val.kind)

    mp.setattr(jdatasets.DatasetCollection, "init", cut)
    tiny = jcommon._bert_tiny_cfg
    mp.setattr(jcommon, "_bert_tiny_cfg",
               lambda: dataclasses.replace(tiny(), dropout_rate=0.0))
    mp.chdir(root)
    jmodel = jcommon.build_model("bert_tiny", 4)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    start = (jax.tree.map(np.asarray, params),
             jax.tree.map(np.asarray, state))
    try:
        want = jdp_cli.main(CLI + ["--epochs", "3", "--checkpoint-dir",
                                   str(root / "jax_ckpt")])["history"]
    finally:
        mp.undo()
    ckpt = str(root / "ckpt")
    common = {"dir": str(root), "ckpt": ckpt, "val": VAL,
              "no_dropout": True, "init": start}
    flags = CLI + ["--device", "cpu", "--checkpoint-dir", ckpt,
                   "--async-save", "--max-restarts", "1"]
    first = ranks.spawn(2, "elastic_cli", dict(
        common, argv=flags + ["--epochs", "1"]),
        tmp_path_factory.mktemp("first"))
    shutil.copytree(ckpt, str(root / "resize"))
    second = ranks.spawn(2, "elastic_cli", dict(
        common, fail_epoch=2, argv=flags + ["--epochs", "3", "--resume"]),
        tmp_path_factory.mktemp("second"))
    resized = ranks.spawn(4, "elastic_cli", dict(
        common, ckpt=str(root / "resize"),
        argv=CLI + ["--device", "cpu", "--checkpoint-dir",
                    str(root / "resize"), "--epochs", "2", "--resume"]),
        tmp_path_factory.mktemp("resized"))
    return want, first, second, resized


def test_cli_first_launch_matches_the_reference(launches):
    want, first, _, _ = launches
    for rank_out in first:
        assert [h["epoch"] for h in rank_out["history"]] == [0]
        _assert_epoch(rank_out["history"][0], want[0])
        assert rank_out["elastic"] == {"attempts": 1, "restarts": []}


def test_cli_restart_after_a_failure_resumes_from_last(launches):
    want, _, second, _ = launches
    for rank_out in second:
        # The final attempt resumed from 'last' (epoch 1) and trained 2.
        assert [h["epoch"] for h in rank_out["history"]] == [2]
        _assert_epoch(rank_out["history"][0], want[2])
        summary = rank_out["elastic"]
        assert summary["attempts"] == 2
        assert summary["restarts"][0]["error_type"] == "RuntimeError"
        assert "injected failure in epoch 2" in \
            summary["restarts"][0]["error"]


def test_cli_resize_resumes_the_two_rank_file_on_four_ranks(launches):
    want, _, _, resized = launches
    for rank_out in resized:
        assert rank_out["topology"]["mesh_axes"]["data"] == 2
        assert rank_out["topology"]["process_count"] == 2
        assert [h["epoch"] for h in rank_out["history"]] == [1]
        _assert_epoch(rank_out["history"][0], want[1])


@pytest.mark.parametrize("argv", [
    ["--async-save"],
    ["--engine", "gspmd", "--grad-reduction", "bucketed"],
    ["--engine", "tp", "--dcn-compression", "int8"],
])
def test_cli_checkpoint_and_engine_checks_match_the_reference(argv):
    with pytest.raises(SystemExit) as want:
        jdp_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        dp_cli.main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value)
