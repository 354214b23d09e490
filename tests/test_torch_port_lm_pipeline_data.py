"""The LM pipeline's data axis (`cli.lm --pipeline-stages S` under a
launcher with WORLD_SIZE > 1) held against the JAX package.

The reference CLI builds `MeshSpec(data=-1, stage=S)`: the stages' data
axis spans the ranks, each takes its rows of the global batch, the
gradients are averaged over the ranks, and only the primary rank writes.
Here 2 gloo ranks (`tests/_torch_port_ranks.py`) each run the port's
`LMPipelineEngine` at stage 2 on the global batches, against the JAX
engine on `MeshSpec(data=2, stage=2)` of the virtual CPU mesh, from the
same weights: per-step metric sums and every parameter after 3 SGD
steps at the f32 bar (rtol 1e-5, atol 1e-6,
`tests/test_torch_port_pipeline.py`). Then `cli.lm --pipeline-stages 2`
runs on the two ranks, each from its own directory: rank 0 alone writes
the log and the checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_ranks as ranks
import distributed_model_parallel_tpu.models.gpt as j_gpt
from distributed_model_parallel_tpu.parallel.pipeline import (
    LMPipelineEngine as JLMPipelineEngine,
)
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from test_torch_port_pipeline import F32, _jax_mesh, _np, close_sums
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

GPT_KW = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
              max_position=16, dropout_rate=0.0, pad_token_id=0)
LR = 0.1
STEPS = 3
CLI = ["--device", "cpu", "--dim", "32", "--layers", "2", "--heads", "4",
       "--seq-len", "16", "-b", "4", "--epochs", "1", "--vocab-size", "64",
       "--corpus-tokens", "2048", "--pipeline-stages", "2",
       "--microbatches", "2", "--steps-per-epoch", "2"]


def _batches():
    rng = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(1, 64, size=(8, 16)).astype(np.int32)
        ids[3, 12:] = 0  # padding on one rank's rows only
        out.append(ids)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX start, JAX per-step sums, JAX final params, port ranks)."""
    tmp = tmp_path_factory.mktemp("lm_pipeline_data")
    batches = _batches()
    jeng = JLMPipelineEngine(
        j_gpt.split_stages(2, j_gpt.GPTConfig(**GPT_KW)), JSGD(),
        _jax_mesh(2, 2), num_microbatches=2, donate=False, pad_token_id=0)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    start = (_np(jeng.params_tree(jts)),
             _np(jeng.to_canonical(jts).model_state))
    sums = []
    for ids in batches:
        jts, m = jeng.train_step(jts, *jeng.shard_batch(ids, ids),
                                 jnp.float32(LR))
        sums.append({k: float(v) for k, v in m.items()})
    dirs = [tmp / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    got = ranks.spawn(2, "lm_pipeline_suite", dict(
        gpt=GPT_KW, start=start, batches=batches, lr=LR, cli=CLI,
        dirs=[str(d) for d in dirs]), tmp)
    return batches, sums, _np(jeng.params_tree(jts)), got, dirs


def test_two_ranks_take_their_own_rows(runs):
    """Rank r takes rows [rB/2, (r+1)B/2) of each global batch: the two
    ranks see different rows, which together are the batch."""
    batches, _, _, got, _ = runs
    assert [r["data"] for r in got] == [(2, 0), (2, 1)]
    for step, ids in enumerate(batches):
        np.testing.assert_array_equal(got[0]["rows"][step], ids[:4])
        np.testing.assert_array_equal(got[1]["rows"][step], ids[4:])


def test_lm_pipeline_data_axis_matches_jax(runs):
    """Per-step metric sums (over both ranks) and the final parameters
    against the JAX engine on MeshSpec(data=2, stage=2)."""
    _, want_sums, want_params, got, _ = runs
    for r in got:
        for g, w in zip(r["sums"], want_sums):
            assert g["count"] == w["count"]
            close_sums(g, w, **F32)
        for g, w in zip(r["params"], want_params):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a, b, **F32), g, w)
    jax.tree.map(np.testing.assert_array_equal, got[0]["params"],
                 got[1]["params"])


def test_lm_pipeline_cli_primary_alone_writes(runs):
    """`cli.lm --pipeline-stages 2` on two ranks: both see the same
    epoch record (metric sums over the data axis), and only rank 0's
    directory holds the log and the checkpoint."""
    _, _, _, got, dirs = runs
    h0, h1 = got[0]["history"], got[1]["history"]
    assert len(h0) == len(h1) == 1
    for split in ("train", "val"):
        for key in ("loss", "acc1", "acc5", "count"):
            assert h0[0][split][key] == h1[0][split][key], (split, key)
    assert np.isfinite(h0[0]["train"]["loss"])
    assert h0[0]["train"]["count"] == 2 * 4 * 15  # 2 steps of 4 x 15
    assert (dirs[0] / "log" / "lm_4.txt").is_file()
    assert (dirs[0] / "checkpoint" / "ckpt.npz").is_file()
    assert not (dirs[1] / "log").exists()
    assert not (dirs[1] / "checkpoint").exists()
