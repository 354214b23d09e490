"""Composed plans (`parallel/plan.py`) through both checkpoint formats,
and the LM CLI's `--plan` on ranks, held against the JAX package.

One spawn of 4 gloo ranks (`tests/_torch_port_ranks.py`
`plan_ckpt_suite`) runs every case in order. The reference's anchors
are `tests/test_checkpoint_sharded.py`'s cross-plan reshards; the port's
plans fill its world, so the 8-device `pp2xdp4` of the schedule change
is `pp2xdp2` on the 4 ranks. Sizes: the reference's reshard config
(vocab 61, dim 16, 4 layers, 2 heads, FFN 32, T 16), batches of 8.

* A sharded save under `pp2xsp2` (one SGD step in) restores BIT-EXACT
  under `fsdp4` (1/4 leaves) and, saved again from there, back under
  `pp2xsp2`; the save runs no collective; the manifest records the
  ('stage', 'data', 'seq') mesh. The restored states train.
* The same over a schedule change with AdamW: `pp2-1f1bxsp2` ->
  `pp2xdp2` -> `pp2-1f1bxsp2`, and the manifest has no schedule record.
* The reference reads the port's plan files, sharded and legacy,
  bit-exactly into its own `ComposedPlanEngine`'s template, and the
  port's `fsdp4` reads the reference's `pp2xsp2` sharded file.
* `cli.lm --plan pp2xsp2` on the 4 ranks: rank 0 alone writes the log
  and the checkpoint.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu import checkpointing as jckpt
from distributed_model_parallel_tpu.models.gpt import GPTConfig as JGPTConfig
from distributed_model_parallel_tpu.parallel import plan as jplan
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    flatten_tree,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

GPT = dict(vocab_size=61, dim=16, num_layers=4, num_heads=2, ffn_dim=32,
           max_position=16, dropout_rate=0.0)
SGD_ARGS = (0.9, 1e-4)
LR = 0.1
ENGINES = {"pp2xsp2": ("pp2xsp2", "sgd"), "fsdp4": ("fsdp4", "sgd"),
           "1f1b": ("pp2-1f1bxsp2", "adamw"),
           "pp2xdp2": ("pp2xdp2", "adamw")}
CLI = ["--device", "cpu", "--vocab-size", "64", "--dim", "32", "--layers",
       "4", "--heads", "4", "--seq-len", "16", "-b", "4", "--epochs", "1",
       "--corpus-tokens", "2048", "--plan", "pp2xsp2"]


def _jax_tree(jts):
    return jax.tree.map(np.asarray, {
        "params": jts.params, "model_state": jts.model_state,
        "opt_state": jts.opt_state._asdict(), "step": jts.step})


def _equal(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)


def _jax_engine(spec):
    return jplan.build_plan_engine(JGPTConfig(**GPT), JSGD(*SGD_ARGS), spec,
                                   donate=False)


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    root = tmp_path_factory.mktemp("plan_ckpt")
    d = {k: str(root / k) for k in ("a", "b", "c", "d", "leg", "jax")}
    jeng = _jax_engine("pp2xsp2")
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    jckpt.save_sharded(d["jax"], jeng.to_canonical_sharded(jstate),
                       acc=2.0, epoch=0)
    ids = np.random.RandomState(0).randint(
        1, GPT["vocab_size"], size=(8, 16)).astype(np.int32)
    cli_dirs = [str(root / f"cli{r}") for r in range(4)]
    for c in cli_dirs:
        os.makedirs(c)
    got = ranks.spawn(4, "plan_ckpt_suite", dict(
        gpt=GPT, params=jax.tree.map(np.asarray, jstate.params),
        sgd=SGD_ARGS, lr=LR, ids=ids, engines=ENGINES, ops=[
            ("save", "pp2xsp2", d["a"]),
            ("restore", "fsdp4", d["a"], d["b"]),
            ("restore", "pp2xsp2", d["b"]),
            ("save", "1f1b", d["c"]),
            ("restore", "pp2xdp2", d["c"], d["d"]),
            ("restore", "1f1b", d["d"]),
            ("restore", "fsdp4", d["jax"]),
            ("legacy", "pp2xsp2", d["leg"]),
            ("cli", CLI, cli_dirs),
        ]), tmp_path_factory.mktemp("plan_ckpt_ranks"))[0]
    return d, _jax_tree(jax.device_get(jstate)), got


def test_sharded_plan_save_restores_bit_exact_under_fsdp4_and_back(crossed):
    d, _, got = crossed
    saved, to_fsdp, back = got[0], got[1], got[2]
    _equal(to_fsdp["canonical"], saved["canonical"])
    _equal(back["canonical"], saved["canonical"])
    assert to_fsdp["meta"] == back["meta"] == (3.0, 1)
    m = jckpt.load_manifest(d["a"])
    assert (m.mesh_axes["stage"], m.mesh_axes["data"],
            m.mesh_axes["seq"]) == (2, 1, 2)
    assert jckpt.load_manifest(d["b"]).mesh_axes["data"] == 4
    for rec in (to_fsdp, back):
        assert np.isfinite(rec["sums"]["loss_sum"])
        assert rec["sums"]["count"] == 8 * 15


def test_sharded_plan_save_restores_across_a_schedule_change(crossed):
    d, _, got = crossed
    saved, there, back = got[3], got[4], got[5]
    assert "count" in saved["canonical"]["opt_state"]  # AdamW moments
    _equal(there["canonical"], saved["canonical"])
    _equal(back["canonical"], saved["canonical"])
    (mpath,) = glob.glob(os.path.join(d["c"], "*.manifest.json"))
    text = open(mpath).read()
    assert "1f1b" not in text and "schedule" not in text
    json.loads(text)
    assert np.isfinite(back["sums"]["loss_sum"])


def test_reference_reads_the_port_plan_files_bit_exactly(crossed):
    """Sharded and legacy, into the reference `ComposedPlanEngine`'s own
    template."""
    d, _, got = crossed
    for directory, rec in ((d["a"], got[0]), (d["leg"], got[7])):
        template = _jax_engine("pp2xsp2").init_state(jax.random.PRNGKey(1))
        state, acc, epoch = jckpt.restore_checkpoint(directory, template)
        assert (acc, epoch) == (3.0, 1)
        tree = _jax_tree(jax.device_get(state))
        _equal({k: tree[k] for k in ("params", "opt_state", "step")},
               {k: rec["canonical"][k] for k in
                ("params", "opt_state", "step")})


def test_port_reads_the_reference_plan_file_bit_exactly(crossed):
    _, jtree, got = crossed
    rec = got[6]
    assert rec["meta"] == (2.0, 0)
    _equal({k: rec["canonical"][k] for k in ("params", "opt_state", "step")},
           {k: jtree[k] for k in ("params", "opt_state", "step")})


def test_lm_cli_plan_on_ranks_writes_from_rank_zero_alone(crossed):
    _, _, got = crossed
    files = got[8]["files"]
    assert "checkpoint/ckpt.npz" in files[0]
    assert any(f.startswith("log/") for f in files[0])
    assert files[1:] == [[], [], []]

