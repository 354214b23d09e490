"""The port's `PipelineEngine` held against the JAX engine on the
8-virtual-device CPU mesh (the LM engine, MobileNetV2, checkpoints and
the CLIs: `tests/test_torch_port_pipeline_cli.py`, which shares the
helpers below).

The JAX engine runs on `make_mesh(MeshSpec(data=D, stage=S))`; the port
runs its S stages in one process on the CPU (D gloo ranks in D
processes for data x stage, `tests/_torch_port_ranks.py`), from the JAX
engine's initial weights carried over chunk by chunk with
`models/convert.from_jax_params`. One SGD step (momentum 0.9, wd 1e-4)
on one batch; compared: the metric sums (loss sum, top-1 / top-5
counts, count), the eval logits, and every parameter and BN buffer after
the step.

Tolerances:
* f32: rtol 1e-5, atol 1e-6, the bar of the JAX package's own schedule
  parity (`tests/test_pipeline_schedule.py`); the counts are integers
  and must be equal. The batches are 8x8 images (tinycnn takes any
  size; `tests/test_torch_port_ddp.py` says why small images).
* bf16 compute (the wire in bf16): rtol / atol 5e-2, the bar of
  `tests/test_torch_port_lm.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
import distributed_model_parallel_tpu.models.tinycnn as j_tinycnn
from distributed_model_parallel_tpu.models import layers as JL
from distributed_model_parallel_tpu.parallel.data_parallel import (
    TrainState as JTrainState,
)
from distributed_model_parallel_tpu.parallel.pipeline import (
    PipelineEngine as JPipelineEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import tinycnn
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    Mesh,
    MeshSpec,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.training.optim import SGD

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=5e-2, atol=5e-2)
LR = 0.1


def _batch(n=16, size=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, 10, size=n).astype(np.int32))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_mesh(data, stage):
    return j_make_mesh(JMeshSpec(data=data, stage=stage),
                       devices=jax.devices()[:data * stage])


def _port_mesh(stage):
    return Mesh(data=1, group=None, stage=stage)


def jax_step(engine, images, labels, start=None):
    """(initial per-chunk params and state, metric sums after one step,
    per-chunk params and state after it) of a JAX engine from
    PRNGKey(0), or from `start` (per-chunk params and state, numpy)."""
    if start is None:
        ts = engine.init_state(jax.random.PRNGKey(0))
    else:
        params = jax.tree.map(jnp.asarray, start[0])
        ts = engine.from_canonical(JTrainState(
            params, jax.tree.map(jnp.asarray, start[1]),
            engine.optimizer.init(params), jnp.zeros((), jnp.int32)))
    start = (_np(engine.params_tree(ts)),
             _np(engine.to_canonical(ts).model_state))
    ts, m = engine.train_step(ts, *engine.shard_batch(images, labels),
                              jnp.float32(LR))
    canon = engine.to_canonical(ts)
    return (start, {k: float(v) for k, v in m.items()},
            (_np(engine.params_tree(ts)), _np(canon.model_state)))


def port_state(engine, start):
    """The port engine's state from the JAX engine's per-chunk params
    and state (numpy, JAX layout)."""
    params, state = zip(*(
        from_jax_params(p, model=stage, state=s)
        for stage, p, s in zip(engine.stages, *start)))
    return engine.state_from_params(params, state)


def port_trees(engine, ts):
    """The port state's per-chunk params and state in the JAX layout."""
    out = [to_jax_params(p, model=stage, state=s)
           for stage, p, s in zip(engine.stages, ts.params, ts.model_state)]
    return tuple(p for p, _ in out), tuple(s for _, s in out)


def port_step(engine, start, images, labels):
    ts = port_state(engine, start)
    ts, m = engine.train_step(ts, *engine.shard_batch(images, labels), LR)
    return {k: float(v) for k, v in m.items()}, port_trees(engine, ts)


def close_sums(got, want, **tol):
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], **tol)
    for k in ("correct1", "correct5", "count"):
        assert got[k] == want[k], (k, got, want)


def close_trees(got, want, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _virtual(schedule, S, M):
    """V for a tinycnn run: 2 where the interleaved schedule admits it
    (2S chunks <= 4 blocks, M % S == 0), else 1."""
    return 2 if schedule == "interleaved" and S == 2 and M % S == 0 else 1


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("S,M", [(2, 1), (2, 2), (2, 4), (4, 1), (4, 2),
                                 (4, 4)])
def test_tinycnn_step_matches_jax(S, M, schedule):
    V = _virtual(schedule, S, M)
    images, labels = _batch()
    kw = dict(num_microbatches=M, schedule=schedule, virtual_stages=V)
    start, want_m, want = jax_step(
        JPipelineEngine(j_tinycnn.split_stages(S * V, 10), JSGD(),
                        _jax_mesh(1, S), donate=False, **kw),
        images, labels)
    got_m, got = port_step(
        PipelineEngine(tinycnn.split_stages(S * V, 10), SGD(),
                       _port_mesh(S), **kw), start, images, labels)
    close_sums(got_m, want_m, **F32)
    close_trees(got, want, **F32)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bf16_wire_matches_jax(schedule):
    """bf16 compute: activations, and so the wire, in bf16; parameters
    f32."""
    images, labels = _batch()
    kw = dict(num_microbatches=2, schedule=schedule)
    start, want_m, want = jax_step(
        JPipelineEngine(j_tinycnn.split_stages(2, 10), JSGD(),
                        _jax_mesh(1, 2), donate=False,
                        compute_dtype=jnp.bfloat16, **kw),
        images, labels)
    eng = PipelineEngine(tinycnn.split_stages(2, 10), SGD(), _port_mesh(2),
                         compute_dtype=torch.bfloat16, **kw)
    got_m, got = port_step(eng, start, images, labels)
    io = next(iter(eng._io_cache.values()))
    assert io.wire == torch.bfloat16
    close_sums(got_m, want_m, **BF16)
    close_trees(got, want, **BF16)


@pytest.mark.parametrize("sync_bn", [False, True])
def test_data_by_stage_over_gloo_matches_jax(sync_bn, tmp_path):
    """data = 2 gloo ranks x stage = 2 against the JAX engine on
    MeshSpec(data=2, stage=2): rank r takes rows [rB/2, (r+1)B/2) of the
    global batch; gradients (and without SyncBN the BN statistics) are
    averaged over the ranks."""
    images, labels = _batch()
    start, want_m, want = jax_step(
        JPipelineEngine(j_tinycnn.split_stages(2, 10), JSGD(),
                        _jax_mesh(2, 2), num_microbatches=2, sync_bn=sync_bn,
                        donate=False),
        images, labels)
    got = ranks.spawn(2, "pipeline_steps", dict(
        start=start, images=images, labels=labels, lr=LR, sync_bn=sync_bn,
        num_microbatches=2), tmp_path)
    for r in got:
        assert r["backend"] == "gloo" and r["grad_reductions"] == 1
        close_sums(r["sums"], want_m, **F32)
        close_trees(r["trees"], want, **F32)
    for name in ("params", "state"):
        i = ("params", "state").index(name)
        jax.tree.map(np.testing.assert_array_equal, got[0]["trees"][i],
                     got[1]["trees"][i])


def test_eval_step_and_logits_match_jax():
    """eval_step's metric sums against the JAX engine's, and the port's
    eval logits against the JAX stages composed on one device."""
    S, M = 2, 2
    images, labels = _batch(seed=3)
    j_stages = j_tinycnn.split_stages(S, 10)
    jeng = JPipelineEngine(j_stages, JSGD(), _jax_mesh(1, S),
                           num_microbatches=M, donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in jeng.eval_step(
        jts, *jeng.shard_batch(images, labels)).items()}
    start = (_np(jeng.params_tree(jts)), _np(jts.model_state))
    full = JL.sequential(*j_stages)
    want_logits, _ = full.apply({str(i): p for i, p in enumerate(start[0])},
                                {str(i): s for i, s in enumerate(start[1])},
                                jnp.asarray(images), JL.Context(train=False))
    for schedule in ("gpipe", "1f1b", "interleaved"):
        eng = PipelineEngine(tinycnn.split_stages(S, 10), SGD(),
                             _port_mesh(S), num_microbatches=M,
                             schedule=schedule)
        ts = port_state(eng, start)
        placed = eng.shard_batch(images, labels)
        got = {k: float(v) for k, v in eng.eval_step(ts, *placed).items()}
        close_sums(got, want, **F32)
        mbs = eng._microbatches(placed[0])
        with torch.no_grad():
            logits, _, _ = eng._run(
                eng._eval_rows, ts, mbs, None,
                eng._stage_io(ts, mbs[0], train=False), train=False,
                ticks=False)
        np.testing.assert_allclose(torch.cat(logits).numpy(),
                                   np.asarray(want_logits), **F32)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_stage_local_params_equal_the_default(schedule):
    """`stage_local_params` changes nothing in the port: its step equals
    the default's bit for bit, and both follow the JAX engine's
    stage-local run."""
    S, M = 2, 2
    images, labels = _batch(seed=4)
    kw = dict(num_microbatches=M, schedule=schedule)
    start, want_m, want = jax_step(
        JPipelineEngine(j_tinycnn.split_stages(S, 10), JSGD(),
                        _jax_mesh(1, S), donate=False,
                        stage_local_params=True, **kw),
        images, labels)
    runs = [port_step(PipelineEngine(tinycnn.split_stages(S, 10), SGD(),
                                     _port_mesh(S), stage_local_params=local,
                                     **kw), start, images, labels)
            for local in (False, True)]
    assert runs[0][0] == runs[1][0]
    jax.tree.map(np.testing.assert_array_equal, runs[0][1], runs[1][1])
    close_sums(runs[1][0], want_m, **F32)
    close_trees(runs[1][1], want, **F32)


# -------------------------------------------------------------- refusals


def test_engine_refusals():
    stages = tinycnn.split_stages(2, 10)
    mesh = _port_mesh(2)
    for kw, match in (
        (dict(schedule="zigzag"), "schedule must be"),
        (dict(virtual_stages=2), "requires schedule='interleaved'"),
        (dict(virtual_stages=0), "must be >= 1"),
        (dict(schedule="interleaved", virtual_stages=2), "needs 4"),
    ):
        with pytest.raises(ValueError, match=match):
            PipelineEngine(stages, SGD(), mesh, **kw)
    # remat, refused before its slice, now checkpoints every chunk
    # (tests/test_torch_port_remat.py holds its steps).
    eng = PipelineEngine(stages, SGD(), mesh, remat=True)
    assert [e.init for e in eng._exec] == [st.init for st in stages]
    assert all(e.apply is not st.apply for e, st in zip(eng._exec, stages))
    with pytest.raises(ValueError, match="divisible by num_microbatches"):
        eng = PipelineEngine(stages, SGD(), mesh, num_microbatches=3)
        eng.train_step(eng.init_state(0), *eng.shard_batch(*_batch()), LR)
    moe = ({"0": {"moe_aux": torch.zeros(())}}, {})
    eng = PipelineEngine(stages, SGD(), mesh)
    with pytest.raises(NotImplementedError, match="MoE layers are not "
                       "supported inside PipelineEngine stages.*"
                       "ExpertParallel engines"):
        eng.state_from_params(({}, {}), moe)
    with pytest.raises(ValueError, match=r"\(rows, classes\) logits"):
        bad = PipelineEngine([stages[0], L.sequential(L.relu())], SGD(),
                             mesh)
        bad.train_step(bad.init_state(0), *bad.shard_batch(*_batch()), LR)


def test_mesh_admits_the_stage_axis():
    # The mesh of a process with no process group: one that an earlier
    # in-process CLI test left in this worker is closed first.
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    mesh = make_mesh(MeshSpec(data=-1, stage=3), devices=["cpu"])
    assert (mesh.data, mesh.stage, mesh.group) == (1, 3, None)
    assert [mesh.stage_device(s).type for s in range(3)] == ["cpu"] * 3
    two = Mesh(1, None, 4, (torch.device("cpu"), torch.device("meta")))
    assert [d.type for d in map(two.stage_device, range(4))] == [
        "cpu", "meta", "cpu", "meta"]
    with pytest.raises(ValueError, match="must be >= 1"):
        MeshSpec(stage=0).resolve(1)
    for axis, slice_ in (("model", "tensor-parallel"),
                         ("seq", "sequence-parallel"),
                         ("expert", "expert-parallel")):
        # the model, seq and expert axes are ported (tensor-, sequence-
        # and expert-parallel slices); they must divide the world
        match = "must divide the world"
        with pytest.raises(ValueError, match=match):
            MeshSpec(stage=2, **{axis: 2}).resolve(1)
    assert MeshSpec(stage=2, model=2).resolve(4) == 2
    # the dcn factor is ported (gradient-reduction slice); it must divide
    # the data axis
    with pytest.raises(ValueError, match="must divide the data axis"):
        MeshSpec(stage=2, dcn=2).resolve(1)
    assert MeshSpec(stage=2, dcn=2).resolve(2) == 2
