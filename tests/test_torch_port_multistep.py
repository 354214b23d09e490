"""The port's multi-step dispatch (`training/multistep.py`) and the
Trainer's dispatch groups, held against the JAX package.

On the CPU a k-step dispatch is k engine steps in one call, so it must
equal k single steps bit for bit; against the JAX package's
`compile_multi_step` / `compile_multi_eval` (a `lax.scan` of the same
steps) it is held at the engines' own bars: tinycnn DDP at the BN bar of
tests/test_torch_port_ddp.py (rtol 1e-4, atol 1e-5: random-init BN nets
are chaotic in f32), the 2-layer GPT at rtol 1e-5. The card's captured
graph is held in tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models import gpt as jgpt
from distributed_model_parallel_tpu.models import tiny_cnn as j_tiny_cnn
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine as JLMEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training import multistep as jms
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.data.lm import synthetic_corpus
from distributed_model_parallel_tpu_torch.models import gpt as tgpt
from distributed_model_parallel_tpu_torch.models import tinycnn
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.multistep import (
    compile_multi_eval,
    compile_multi_step,
    group_batches,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    SGD,
    tree_leaves,
)
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

BN = dict(rtol=1e-4, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-6)
LR = 0.1
ONE = Mesh(data=1, group=None)
LM_KW = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
             max_position=32, dropout_rate=0.0, pad_token_id=0)


# ------------------------------------------------------ group_batches


def test_group_batches_full_groups_then_trailing_partial():
    it = iter(range(10))
    assert group_batches(it, 4) == [0, 1, 2, 3]
    assert group_batches(it, 4) == [4, 5, 6, 7]
    assert group_batches(it, 4) == [8, 9]
    assert group_batches(it, 4) == []


def test_group_batches_exact_multiple_has_no_phantom_group():
    it = iter(range(8))
    assert group_batches(it, 4) == [0, 1, 2, 3]
    assert group_batches(it, 4) == [4, 5, 6, 7]
    assert group_batches(it, 4) == []


def test_group_batches_k_larger_than_stream():
    it = iter(range(3))
    assert group_batches(it, 5) == [0, 1, 2]
    assert group_batches(it, 5) == []
    for a, b in ((range(10), 3), (range(0), 2), (range(5), 1)):
        assert group_batches(iter(a), b) == jms.group_batches(iter(a), b)


@pytest.mark.parametrize("fn", [compile_multi_step, compile_multi_eval])
def test_k_below_one_is_refused(fn):
    eng = DDPEngine(tiny_cnn(10), SGD(), mesh=ONE, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1, got 0"):
        fn(eng, 0)


def test_pipeline_over_two_devices_is_refused():
    stages = tinycnn.split_stages(2, 10)
    two = Mesh(1, None, 2, (torch.device("cpu"), torch.device("meta")))
    eng = PipelineEngine(stages, SGD(), two)
    for fn in (compile_multi_step, compile_multi_eval):
        with pytest.raises(ValueError, match="span 2 devices.*§A.7"):
            fn(eng, 2)
    assert compile_multi_step(eng, 1) is not None  # k = 1 runs anywhere
    one = Mesh(1, None, 2, (torch.device("cpu"),))
    compile_multi_step(PipelineEngine(stages, SGD(), one), 4)


# ------------------------------------------------------ tinycnn DDP


def _cnn_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 8, 8, 3).astype(np.float32),
             rng.randint(0, 10, size=8).astype(np.int32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def cnn_weights():
    p, s = j_tiny_cnn(10).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)


def _port_cnn(weights):
    eng = DDPEngine(tiny_cnn(10), SGD(), mesh=ONE, device="cpu")
    p, s = from_jax_params(weights[0], model=eng.model, state=weights[1])
    return eng, eng.state_from_params(p, s)


def _floats(m):
    return {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("k", [1, 2])
def test_ddp_k_steps_equal_single_steps_and_jax(k, cnn_weights):
    """Four tinycnn DDP steps as 4/k dispatches: bit-equal to four
    `train_step` calls, and at the BN bar of the JAX package's
    `compile_multi_step` over the same batches (its summed metrics
    too)."""
    batches = _cnn_batches(4)
    eng, ts = _port_cnn(cnn_weights)
    ref, ref_ts = _port_cnn(cnn_weights)
    multi = compile_multi_step(eng, k)
    got, want = [], []
    for g in range(0, 4, k):
        group = [eng.shard_batch(*b) for b in batches[g:g + k]]
        ts, m = multi(ts, group, LR)
        got.append(_floats(m))
        sums = None  # f32 sums in step order, as a dispatch adds them
        for b in batches[g:g + k]:
            ref_ts, mi = ref.train_step(ref_ts, *ref.shard_batch(*b), LR)
            sums = mi if sums is None else {
                key: sums[key] + mi[key] for key in sums}
        want.append(_floats(sums))
    assert ts.step == ref_ts.step == 4
    assert got == want
    for a, b in zip(tree_leaves((ts.params, ts.model_state)),
                    tree_leaves((ref_ts.params, ref_ts.model_state))):
        assert torch.equal(a, b)

    jmesh = j_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    jeng = JDDPEngine(j_tiny_cnn(10), JSGD(), jmesh, donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    jmulti = jms.compile_multi_step(jeng, k)
    jgot = []
    for g in range(0, 4, k):
        jts, jm = jmulti(jts, tuple(jeng.shard_batch(*b)
                                    for b in batches[g:g + k]), LR)
        jgot.append(_floats(jm))
    for a, b in zip(got, jgot):
        np.testing.assert_allclose(a["loss_sum"], b["loss_sum"], **BN)
        assert (a["correct1"], a["count"]) == (b["correct1"], b["count"])
    port = to_jax_params(ts.params, model=eng.model)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jts.params)),
            jax.tree_util.tree_leaves(port)):
        np.testing.assert_allclose(g, w, err_msg=str(path), **BN)


def test_multi_eval_equals_eval_steps_and_jax(cnn_weights):
    batches = _cnn_batches(4, seed=1)
    eng, ts = _port_cnn(cnn_weights)
    got = _floats(compile_multi_eval(eng, 4)(
        ts, [eng.shard_batch(*b) for b in batches]))
    want = None
    for b in batches:
        m = eng.eval_step(ts, *eng.shard_batch(*b))
        want = m if want is None else {k: want[k] + m[k] for k in want}
    assert got == _floats(want)
    jmesh = j_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    jeng = JDDPEngine(j_tiny_cnn(10), JSGD(), jmesh, donate=False)
    jm = _floats(jms.compile_multi_eval(jeng, 4)(
        jeng.init_state(jax.random.PRNGKey(0)),
        tuple(jeng.shard_batch(*b) for b in batches)))
    np.testing.assert_allclose(got["loss_sum"], jm["loss_sum"], **BN)
    assert (got["correct1"], got["count"]) == (jm["correct1"], jm["count"])


# --------------------------------------------------------------- LM


def test_lm_two_step_dispatch_matches_jax():
    """The 2-layer GPT: one 2-step dispatch against two port steps (bit
    for bit) and against the JAX package's compile_multi_step (1e-5)."""
    corpus = synthetic_corpus(64, 4 * 32 * 2 + 1, seed=5)
    batches = [corpus[i * 128:(i + 1) * 128].reshape(4, 32)
               for i in range(2)]
    jmesh = j_mesh(JMeshSpec(data=1, seq=1), devices=jax.devices()[:1])
    jeng = JLMEngine(jgpt.GPTConfig(**LM_KW), JSGD(0.9, 1e-2), jmesh,
                     attention="ring", donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jts.params)
    runs = []
    for k in (2, 1):
        eng = CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**LM_KW), SGD(0.9, 1e-2), attention="ring",
            device="cpu")
        ts = eng.state_from_params(from_jax_params(params))
        multi = compile_multi_step(eng, k)
        sums = None
        for g in range(0, 2, k):
            ts, m = multi(ts, [eng.shard_batch(b) for b in batches[g:g + k]],
                          LR)
            sums = m if sums is None else {key: sums[key] + m[key]
                                           for key in sums}
        runs.append((_floats(sums), ts))
    (got, ts), (ref, ref_ts) = runs
    assert got == ref
    for a, b in zip(tree_leaves(ts.params), tree_leaves(ref_ts.params)):
        assert torch.equal(a, b)
    jts, jm = jms.compile_multi_step(jeng, 2)(
        jts, tuple(jeng.shard_batch(b) for b in batches), np.float32(LR))
    np.testing.assert_allclose(got["loss_sum"], float(jm["loss_sum"]), **F32)
    assert got["count"] == float(jm["count"])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jts.params)),
            jax.tree_util.tree_leaves(to_jax_params(ts.params))):
        np.testing.assert_allclose(g, w, err_msg=str(path), **F32)


# ----------------------------------------------------------- Trainer


class _Batches:
    """A loader of fixed host batches with a length."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _fit(weights, k, tmp_path, batches, val):
    eng, _ = _port_cnn(weights)
    cfg = TrainerConfig(epochs=2, print_freq=0, log_dir=str(tmp_path),
                        checkpoint_dir=str(tmp_path / f"ck{k}"),
                        save_best=False, steps_per_dispatch=k)
    trainer = Trainer(eng, _Batches(batches), _Batches(val), cfg)
    p, s = from_jax_params(weights[0], model=eng.model, state=weights[1])
    trainer.state = eng.state_from_params(p, s)
    return trainer.fit(), trainer


@pytest.mark.parametrize("k", [3, 8])
def test_trainer_groups_equal_single_steps(k, cnn_weights, tmp_path,
                                           capsys):
    """Seven batches an epoch: k = 3 runs groups of 3, 3 and a tail of
    1; k = 8 exceeds the epoch and is clamped to 7, with the reference's
    message. Both give the k = 1 run's parameters bit for bit and its
    epoch records (train and grouped validation, timings aside); the
    epoch's f32 metric sums add group by group, another order, so the
    mean losses are held at 1e-6."""
    batches, val = _cnn_batches(7), _cnn_batches(5, seed=3)
    out_k, tr_k = _fit(cnn_weights, k, tmp_path, batches, val)
    printed = capsys.readouterr().out
    out_1, tr_1 = _fit(cnn_weights, 1, tmp_path, batches, val)
    clamp = "steps_per_dispatch 8 exceeds the 7-batch epoch; clamping to 7"
    assert (clamp in printed) == (k == 8)
    assert printed.count("clamping") == (k == 8)  # warned once

    for a, b in zip(out_k["history"], out_1["history"], strict=True):
        for part in ("train", "val"):
            for key in ("acc1", "acc5", "count"):
                assert a[part][key] == b[part][key]
            np.testing.assert_allclose(a[part]["loss"], b[part]["loss"],
                                       rtol=1e-6)
    assert tr_k.state.step == tr_1.state.step == 14
    for a, b in zip(tree_leaves(tr_k.state.params),
                    tree_leaves(tr_1.state.params)):
        assert torch.equal(a, b)
