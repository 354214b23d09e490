"""The LM CLI's MoE surface (`cli/lm.py --moe-experts`, `--moe-every`,
`--moe-dispatch gspmd|hierarchical`, `--moe-overlap`, `--expert-shards`)
held against the JAX package's `cli/lm.py`.

* Every MoE flag guard of the JAX CLI exits with the JAX CLI's message
  (`tests/test_cli.py`'s list), the E % ways one on an 8-rank data axis.
* Resume from the JAX CLI's MoE checkpoint (one epoch of 4 steps, 8
  virtual devices, 8 experts, `--optimizer sgd`, gspmd): the port's
  second epoch equals the JAX CLI's two-epoch run's (train and val loss,
  acc1; rtol 1e-5), under gspmd and hierarchical + overlap on one rank
  in this process and on 2 gloo ranks (`--expert-shards 2`;
  hierarchical); on 4 ranks `tests/test_torch_port_moe_exchange.py`
  holds the CLI against this one-rank resume. The dispatch modes compute
  the same function (the JAX package's tests hold its modes equal), so
  the JAX gspmd run is the reference of every mode.
  The port's own state resumes in the reference engine in
  `tests/test_torch_port_moe.py`.
* The serve CLI refuses a MoE checkpoint the port's LM CLI wrote.
"""

import os
import shutil

import numpy as np
import pytest
import torch.distributed as dist

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.cli import lm as jlm_cli
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.cli import serve as serve_cli
from distributed_model_parallel_tpu_torch.cli.common import (
    check_moe_experts_divide,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

BASE = ["--dim", "32", "--layers", "2", "--heads", "4", "--seq-len", "16",
        "-b", "8", "--vocab-size", "64", "--corpus-tokens", "2048",
        "--moe-experts", "8", "--optimizer", "sgd", "--lr", "0.1",
        "--steps-per-epoch", "4"]
MODES = {"gspmd": [],
         "hier": ["--moe-dispatch", "hierarchical", "--moe-overlap"]}
# the port's flags on 2 ranks (4 ranks: tests/test_torch_port_moe_
# exchange.py, resumed from the port's one-rank file)
RANK_RUNS = {2: [["--expert-shards", "2"],
                 ["--moe-dispatch", "hierarchical"]]}
GUARDS = [
    ["--moe-dispatch", "hierarchical"],
    ["--moe-overlap"],
    ["--expert-shards", "2"],
    ["--moe-every", "1"],
    ["--moe-experts", "-1"],
    ["--moe-experts", "8", "--seq-shards", "2"],
    ["--moe-experts", "8", "--pipeline-stages", "2"],
    ["--moe-experts", "8", "--collective-matmul"],
    ["--moe-experts", "8", "--attention", "ulysses_flash"],
    ["--moe-experts", "8", "--grad-reduction", "bucketed"],
    ["--moe-experts", "8", "--moe-overlap"],
    ["--moe-experts", "8", "--dcn-slices", "2", "--dcn-compression",
     "int8"],
    ["--moe-experts", "8", "--moe-dispatch", "hierarchical",
     "--expert-shards", "2"],
]


@pytest.fixture(scope="module", autouse=True)
def _no_process_group_left():
    """The in-process CLI runs join a one-rank gloo world; it is closed
    when the module ends."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_exit(argv):
    with pytest.raises(SystemExit) as e:
        jlm_cli.main(argv)
    return str(e.value)


@pytest.mark.parametrize("flags", GUARDS, ids=lambda f: "_".join(f))
def test_moe_guards_match_the_jax_cli(flags):
    want = _jax_exit(flags)
    with pytest.raises(SystemExit) as got:
        lm_cli.main(["--device", "cpu"] + flags)
    assert str(got.value) == want


def test_experts_must_divide_the_hierarchical_fabric():
    """6 experts on the reference's 8-device data axis, the port's at 8
    data ranks: the same message."""
    want = _jax_exit(["--moe-experts", "6", "--moe-dispatch",
                      "hierarchical"])
    with pytest.raises(SystemExit) as got:
        check_moe_experts_divide(6, Mesh(8, None))
    assert str(got.value) == want


def _record(history):
    h = history[-1]
    return [h["train"]["loss"], h["train"]["acc1"], h["val"]["loss"],
            h["val"]["acc1"], h["train"]["count"], h["val"]["count"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI's one-epoch checkpoint and two-epoch record, then the
    port's resumed runs on 2 gloo ranks."""
    root = tmp_path_factory.mktemp("moe_cli")
    cwd = os.getcwd()
    out = {"root": root}
    try:
        os.chdir(root)
        jlm_cli.main(BASE + ["--epochs", "1", "--checkpoint-dir",
                             str(root / "jax_ck")])
        (root / "straight").mkdir()
        os.chdir(root / "straight")
        out["jax"] = _record(jlm_cli.main(BASE + ["--epochs", "2"])[
            "history"])
    finally:
        os.chdir(cwd)
    for world, cases in RANK_RUNS.items():
        dirs, runs_ = [], []
        for i, flags in enumerate(cases):
            ck = root / f"w{world}_{i}_ck"
            shutil.copytree(root / "jax_ck", ck)
            dirs.append([str(root / f"w{world}_{i}_r{r}")
                         for r in range(world)])
            for d in dirs[-1]:
                os.makedirs(d)
            runs_.append(("lm", ["--device", "cpu"] + BASE + flags + [
                "--epochs", "2", "--resume", "--checkpoint-dir", str(ck)],
                i))
        (root / f"spawn{world}").mkdir()
        out[world] = ranks.spawn(world, "cli_suite",
                                 {"runs": runs_, "dirs": dirs},
                                 root / f"spawn{world}")
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_from_jax_checkpoint_at_one_rank(runs, mode, tmp_path,
                                                monkeypatch):
    ck = tmp_path / "ck"
    shutil.copytree(runs["root"] / "jax_ck", ck)
    monkeypatch.chdir(tmp_path)
    got = _record(lm_cli.main(["--device", "cpu"] + BASE + MODES[mode] + [
        "--epochs", "2", "--resume", "--checkpoint-dir", str(ck)])[
        "history"])
    np.testing.assert_allclose(got, runs["jax"], rtol=1e-5)


@pytest.mark.parametrize("world,case", [(w, i) for w in RANK_RUNS
                                        for i in range(len(RANK_RUNS[w]))],
                         ids=[f"w{w}-{'_'.join(c)}" for w in RANK_RUNS
                              for c in RANK_RUNS[w]])
def test_resume_from_jax_checkpoint_on_ranks(runs, world, case):
    for rank_out in runs[world]:
        got = rank_out[case]
        assert len(got) == 1  # epoch 1 only: resumed at epoch 0's end
        np.testing.assert_allclose(_record(got), runs["jax"], rtol=1e-5)


def test_serve_refuses_a_moe_checkpoint_of_the_port(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lm_cli.main(["--device", "cpu"] + BASE + ["--epochs", "1",
                                              "--steps-per-epoch", "2"])
    with pytest.raises(SystemExit, match="Mixture-of-Experts LM "
                                         r"\(num_experts=8\)"):
        serve_cli.main(["--device", "cpu", "--dim", "32", "--layers", "2",
                        "--heads", "4", "--vocab-size", "64", "--max-len",
                        "16", "--checkpoint", str(tmp_path / "checkpoint")])
