"""The port's rematerialization (`models/layers.remat`, `remat=True` on
the model constructors and the engines) held against no remat and against
the JAX package's remat step.

A recompute under `torch.utils.checkpoint` re-runs the same operations
on the same tensors, so on the CPU a remat step must equal the step
without remat bit for bit, parameters, BN statistics and metric sums;
with dropout > 0 too, because the dropout bits are a hash of (key,
child path, index) and the recompute draws them again
(`models/layers.dropout`). Against the JAX package's remat engines
(`jax.checkpoint`), with dropout 0: one step at the bars of the engines'
own parity files, rtol 1e-5 (atol 1e-6) for the pipeline and the LM
(tests/test_torch_port_pipeline.py, test_torch_port_lm.py), the BN bar
rtol 1e-4 / atol 1e-5 of tests/test_torch_port_ddp.py for the tinycnn
DDP engines, rtol 1e-5 for the ViT DDP step (no BN).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_model_parallel_tpu.models.tinycnn as j_tinycnn
from distributed_model_parallel_tpu.models import gpt as jgpt
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DataParallelEngine as JDataParallelEngine,
)
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.parallel.pipeline import (
    PipelineEngine as JPipelineEngine,
)
from distributed_model_parallel_tpu.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine as JLMEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.data.lm import synthetic_corpus
from distributed_model_parallel_tpu_torch.models import bert, tinycnn
from distributed_model_parallel_tpu_torch.models import gpt as tgpt
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import (
    SGD,
    tree_leaves,
)
from test_torch_port_pipeline import (
    _jax_mesh,
    _port_mesh,
    close_sums,
    close_trees,
    jax_step,
    port_step,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

vit = importlib.import_module(

    "distributed_model_parallel_tpu_torch.models.vit")

# The JAX package's models/__init__ binds the name `vit` to the constructor.
jvit = importlib.import_module("distributed_model_parallel_tpu.models.vit")
F32 = dict(rtol=1e-5, atol=1e-6)
BN = dict(rtol=1e-4, atol=1e-5)
LR = 0.1
ONE = Mesh(data=1, group=None)
LM_KW = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
             max_position=32, pad_token_id=0)
VIT = dict(image_size=8, patch_size=4, dim=32, num_layers=2, num_heads=4,
           mlp_dim=64)


def _images(n=8, size=8, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, classes, size=n).astype(np.int32))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _steps(eng, ts, batches):
    sums = []
    for b in batches:
        ts, m = eng.train_step(ts, *eng.shard_batch(*b), LR)
        sums.append({k: float(v) for k, v in m.items()})
    return ts, sums


def _bit_equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ------------------------------------------------------- DP engines


@pytest.mark.parametrize("engine", ["gspmd", "ddp"])
def test_dp_engines_remat_equals_no_remat_and_jax(engine):
    """tinycnn, two steps: remat bit-equal to no remat; one step at the
    BN bar of the JAX engine built with tiny_cnn(remat=True)."""
    batches = [_images(seed=s) for s in range(2)]
    p, s = j_tinycnn.tiny_cnn(10).init(jax.random.PRNGKey(0))
    p, s = _np(p), _np(s)
    cls = DataParallelEngine if engine == "gspmd" else DDPEngine
    runs = []
    for remat in (True, False):
        eng = cls(tinycnn.tiny_cnn(10, remat=remat), SGD(), mesh=ONE,
                  device="cpu")
        tp, tstate = from_jax_params(p, model=eng.model, state=s)
        runs.append((eng,) + _steps(eng, eng.state_from_params(tp, tstate),
                                    batches))
    (eng, ts, sums), (_, ts0, sums0) = runs
    assert sums == sums0
    _bit_equal((ts.params, ts.model_state), (ts0.params, ts0.model_state))

    jcls = JDataParallelEngine if engine == "gspmd" else JDDPEngine
    jeng = jcls(j_tinycnn.tiny_cnn(10, remat=True), JSGD(),
                j_mesh(JMeshSpec(data=1), devices=jax.devices()[:1]),
                donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    jts, jm = jeng.train_step(jts, *jeng.shard_batch(*batches[0]), LR)
    one = cls(tinycnn.tiny_cnn(10, remat=True), SGD(), mesh=ONE,
              device="cpu")
    tp, tstate = from_jax_params(p, model=one.model, state=s)
    ts1, m1 = _steps(one, one.state_from_params(tp, tstate), batches[:1])
    np.testing.assert_allclose(m1[0]["loss_sum"], float(jm["loss_sum"]),
                               **BN)
    got = to_jax_params(ts1.params, model=one.model,
                        state=ts1.model_state)
    close_trees(got, (_np(jts.params), _np(jts.model_state)), **BN)


def test_vit_ddp_remat_step_matches_jax():
    """A 2-layer ViT (no BN): the remat DDP step at rtol 1e-5 of the JAX
    DDPEngine over vit(remat=True), and bit-equal to no remat."""
    batch = _images(classes=10)
    jcfg = jvit.ViTConfig(**VIT)
    jeng = JDDPEngine(jvit.vit(10, jcfg, remat=True), JSGD(),
                      j_mesh(JMeshSpec(data=1), devices=jax.devices()[:1]),
                      donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    start = _np(jts.params)
    jts, jm = jeng.train_step(jts, *jeng.shard_batch(*batch), LR)
    runs = []
    for remat in (True, False):
        eng = DDPEngine(vit.vit(10, vit.ViTConfig(**VIT), remat=remat),
                        SGD(), mesh=ONE, device="cpu")
        ts = eng.state_from_params(from_jax_params(start, model=eng.model),
                                   eng.model.init(torch.Generator())[1])
        runs.append((eng,) + _steps(eng, ts, [batch]))
    (eng, ts, sums), (_, ts0, sums0) = runs
    assert sums == sums0
    _bit_equal(ts.params, ts0.params)
    np.testing.assert_allclose(sums[0]["loss_sum"], float(jm["loss_sum"]),
                               **F32)
    close_trees(to_jax_params(ts.params, model=eng.model), _np(jts.params),
                **F32)


# --------------------------------------------------------- pipeline


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_remat_equals_no_remat(schedule):
    images, labels = _images(16)
    runs = []
    for remat in (True, False):
        eng = PipelineEngine(tinycnn.split_stages(2, 10), SGD(),
                             _port_mesh(2), num_microbatches=2,
                             schedule=schedule, remat=remat)
        ts = eng.init_state(0)
        runs.append(_steps(eng, ts, [(images, labels)] * 2))
    (ts, sums), (ts0, sums0) = runs
    assert sums == sums0
    _bit_equal((ts.params, ts.model_state), (ts0.params, ts0.model_state))


def test_pipeline_remat_step_matches_jax():
    """1F1B at S 2, M 2 with remat against the JAX engine's remat step
    (the JAX gpipe compile would double this file's time)."""
    images, labels = _images(16)
    kw = dict(num_microbatches=2, schedule="1f1b", remat=True)
    start, want_m, want = jax_step(
        JPipelineEngine(j_tinycnn.split_stages(2, 10), JSGD(),
                        _jax_mesh(1, 2), donate=False, **kw),
        images, labels)
    got_m, got = port_step(
        PipelineEngine(tinycnn.split_stages(2, 10), SGD(), _port_mesh(2),
                       **kw), start, images, labels)
    close_sums(got_m, want_m, **F32)
    close_trees(got, want, **F32)


# --------------------------------------------------------------- LM


def _lm_batches(n):
    corpus = synthetic_corpus(64, 4 * 32 * n + 1, seed=5)
    return [(corpus[i * 128:(i + 1) * 128].reshape(4, 32),)
            for i in range(n)]


def test_lm_remat_equals_no_remat_and_jax():
    """The 2-layer GPT, dropout 0: two remat steps bit-equal to no remat
    (flash attention's plain version inside the recompute), and one
    step at rtol 1e-5 of the JAX engine with remat=True."""
    jeng = JLMEngine(jgpt.GPTConfig(**LM_KW, dropout_rate=0.0), JSGD(),
                     j_mesh(JMeshSpec(data=1, seq=1),
                            devices=jax.devices()[:1]),
                     attention="ring", remat=True, donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jts.params)
    batches = _lm_batches(2)
    jts, jm = jeng.train_step(jts, *jeng.shard_batch(batches[0][0]),
                              jnp.float32(LR))
    runs = {}
    for attention in ("ring", "ulysses_flash"):
        for remat in (True, False):
            eng = CausalLMSequenceParallelEngine(
                tgpt.GPTConfig(**LM_KW, dropout_rate=0.0), SGD(),
                attention=attention, remat=remat, device="cpu")
            runs[attention, remat] = _steps(
                eng, eng.state_from_params(from_jax_params(start)), batches)
    for attention in ("ring", "ulysses_flash"):
        (ts, sums), (ts0, sums0) = runs[attention, True], \
            runs[attention, False]
        assert sums == sums0
        _bit_equal(ts.params, ts0.params)
    eng = CausalLMSequenceParallelEngine(
        tgpt.GPTConfig(**LM_KW, dropout_rate=0.0), SGD(), attention="ring",
        remat=True, device="cpu")
    ts, sums = _steps(eng, eng.state_from_params(from_jax_params(start)),
                      batches[:1])
    np.testing.assert_allclose(sums[0]["loss_sum"], float(jm["loss_sum"]),
                               **F32)
    close_trees(to_jax_params(ts.params), _np(jts.params), **F32)


# ---------------------------------------------------- dropout > 0


def test_remat_with_dropout_is_bit_equal_to_no_remat():
    """Dropout 0.3: the recompute draws the forward's masks again, so a
    remat step equals the step without remat bit for bit, for the BERT
    classifier under DDP, the GPT under the LM engine (flash attention's
    plain version), and BERT stages under the 1F1B pipeline (whose
    backward ticks re-run each chunk). The masks are live: the loss
    differs from the dropout-0 step's."""
    cfg = bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, intermediate_size=64, max_position=16,
                          dropout_rate=0.3)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 64, size=(8, 16)).astype(np.int32)
    ids[0, 10:] = 0  # a padded row
    batch = (ids, rng.randint(0, 3, size=8).astype(np.int32))
    runs = {}
    for rate in (0.3, 0.0):
        c = bert.BertConfig(**{**cfg.__dict__, "dropout_rate": rate})
        for remat in (True, False):
            eng = DDPEngine(bert.bert_for_classification(3, c, remat=remat),
                            SGD(), mesh=ONE, device="cpu")
            runs["bert", rate, remat] = _steps(eng, eng.init_state(0),
                                               [batch] * 2)
            stages = bert.split_stages(2, 3, c)
            pipe = PipelineEngine(stages, SGD(), _port_mesh(2),
                                  num_microbatches=2, schedule="1f1b",
                                  remat=remat)
            runs["pipe", rate, remat] = _steps(pipe, pipe.init_state(0),
                                               [batch] * 2)
        for remat in (True, False):
            eng = CausalLMSequenceParallelEngine(
                tgpt.GPTConfig(**LM_KW, dropout_rate=rate), SGD(),
                attention="ulysses_flash", remat=remat, device="cpu")
            runs["lm", rate, remat] = _steps(eng, eng.init_state(0),
                                             _lm_batches(2))
    for name in ("bert", "pipe", "lm"):
        (ts, sums), (ts0, sums0) = runs[name, 0.3, True], \
            runs[name, 0.3, False]
        assert sums == sums0, name
        _bit_equal((ts.params, ts.model_state),
                   (ts0.params, ts0.model_state))
        assert sums[0]["loss_sum"] != runs[name, 0.0, False][1][0][
            "loss_sum"], name


def test_remat_layer_keeps_bn_statistics_of_one_forward():
    """The BN running statistics a checkpointed block returns are those
    of its forward, updated once: equal to the plain block's."""
    block = L.sequential(L.conv2d(3, 4, 3, padding=1), L.batchnorm2d(4))
    p, s = block.init(torch.Generator().manual_seed(0))
    p = {k: {n: t.requires_grad_(True) for n, t in v.items()}
         for k, v in p.items()}
    x = torch.randn(4, 3, 6, 6, generator=torch.Generator().manual_seed(1))
    ctx = L.Context(train=True)
    y, new = L.remat(block).apply(p, s, x, ctx)
    y0, new0 = block.apply(p, s, x, ctx)
    assert torch.equal(y, y0)
    _bit_equal(new, new0)
    g = torch.autograd.grad(y.square().sum(), list(tree_leaves(p)))
    g0 = torch.autograd.grad(y0.square().sum(), list(tree_leaves(p)))
    for a, b in zip(g, g0):
        assert torch.equal(a, b)
