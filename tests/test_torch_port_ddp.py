"""The port's data-parallel engines, ranks and CLI held against the JAX
package.

The JAX `DDPEngine` runs on `make_mesh(MeshSpec(data=S))` over S of the
8 virtual CPU devices; the port runs S gloo ranks in S processes
(`tests/_torch_port_ranks.py`), rank r given rows [rB/S, (r+1)B/S) of
the same global batch and the same tinycnn weights
(`models/convert.from_jax_params`). Three SGD steps, per-replica BN and
SyncBN, S = 2 and 4: the per-step metric sums (loss, top-1/top-5
counts, count), and the final params and BN state, on every rank.

Tolerances:
* f32 engines: rtol 1e-4, atol 1e-5, the bar the JAX package holds its
  own tinycnn engine parities to (`tests/test_data_parallel.py`); the
  port's convolutions and all-reduces sum in another order. The
  top-1/top-5 counts and the count are integers and must be equal.
  Reached: parameters and state within 1.2e-7 after three steps. The
  batches are 8x8 images (tinycnn takes any size): a ReLU input that
  lies within the rounding difference of zero takes the other branch in
  one package, which moves that step's gradient by about 1/(B*H*W) of
  its norm, past the bar; at 32x32, with 16x as many activations, half
  of the three-step runs met one.
* the port's SyncBN DDP over 2 ranks against its own one-process
  DataParallelEngine on the whole batch: the same bar.
* bf16, one step: rtol/atol 5e-2, the bar of
  `tests/test_torch_port_lm.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.models import tiny_cnn as j_tiny_cnn
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DataParallelEngine as JDataParallelEngine,
)
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.cli.common import (
    check_batch_divisibility,
)
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    Mesh,
    MeshSpec,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.training.optim import SGD

BATCH, STEPS, LR = 16, 3, 0.1
ENGINE = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
ONE_PROCESS = Mesh(data=1, group=None)


def _batches(seed=0, n=STEPS, size=8):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, size, size, 3).astype(np.float32),
             rng.randint(0, 10, size=BATCH).astype(np.int32))
            for _ in range(n)]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_run(engine, batches):
    """(per-step metric sums, final params, final state) of a JAX
    engine from PRNGKey(0)."""
    ts = engine.init_state(jax.random.PRNGKey(0))
    sums = []
    for images, labels in batches:
        ts, m = engine.train_step(ts, *engine.shard_batch(images, labels),
                                  LR)
        sums.append({k: float(v) for k, v in m.items()})
    return sums, _np(ts.params), _np(ts.model_state)


@pytest.fixture(scope="module")
def weights():
    """tinycnn's reference weights from PRNGKey(0), as the JAX engines
    start."""
    p, s = j_tiny_cnn(10).init(jax.random.PRNGKey(0))
    return _np(p), _np(s)


def _close_sums(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], **tol)
        for k in ("correct1", "correct5", "count"):
            assert g[k] == w[k], (k, g, w)


def _close_trees(got, want, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **tol)


@pytest.mark.parametrize("world", [2, 4])
def test_ddp_ranks_follow_jax_ddp(world, weights, tmp_path):
    """S gloo ranks against the JAX DDPEngine on S devices, per-replica
    BN and SyncBN, three steps; every rank ends with the same state."""
    batches = _batches()
    mesh = j_make_mesh(JMeshSpec(data=world), devices=jax.devices()[:world])
    want = {
        name: _jax_run(JDDPEngine(j_tiny_cnn(10), JSGD(), mesh,
                                  sync_bn=name == "ddp_sync", donate=False),
                       batches)
        for name in ("ddp", "ddp_sync")
    }
    got = ranks.spawn(world, "ddp_steps", dict(
        engines=("ddp", "ddp_sync"), params=weights[0], state=weights[1],
        batches=batches, lr=LR), tmp_path)
    for name, (sums, params, state) in want.items():
        for r in got:
            assert r[name]["backend"] == "gloo"
            assert r[name]["grad_reductions"] == STEPS
            _close_sums(r[name]["sums"], sums, **ENGINE)
            _close_trees(r[name]["params"], params, **ENGINE)
            _close_trees(r[name]["state"], state, **ENGINE)
        for r in got[1:]:  # identical on every rank
            jax.tree.map(np.testing.assert_array_equal, r[name]["params"],
                         got[0][name]["params"])
            jax.tree.map(np.testing.assert_array_equal, r[name]["state"],
                         got[0][name]["state"])


def _port_run(engine, weights, batches):
    model = engine.model
    ts = engine.state_from_params(*from_jax_params(
        weights[0], model=model, state=weights[1]))
    sums = []
    for images, labels in batches:
        ts, m = engine.train_step(ts, *engine.shard_batch(images, labels),
                                  LR)
        sums.append({k: float(v) for k, v in m.items()})
    params, state = to_jax_params(ts.params, model=model,
                                  state=ts.model_state)
    return sums, params, state


def test_syncbn_ranks_equal_one_process_on_the_whole_batch(weights,
                                                           tmp_path):
    """The port's SyncBN DDP and DataParallelEngine over 2 ranks against
    its own one-process DataParallelEngine on the whole batch."""
    batches = _batches(seed=1)
    want = _port_run(DataParallelEngine(tiny_cnn(10), SGD(),
                                        mesh=ONE_PROCESS, device="cpu"),
                     weights, batches)
    got = ranks.spawn(2, "ddp_steps", dict(
        engines=("ddp_sync", "gspmd"), params=weights[0], state=weights[1],
        batches=batches, lr=LR), tmp_path)
    for r in got:
        for name in ("ddp_sync", "gspmd"):
            _close_sums(r[name]["sums"], want[0], **ENGINE)
            _close_trees(r[name]["params"], want[1], **ENGINE)
            _close_trees(r[name]["state"], want[2], **ENGINE)


@pytest.mark.parametrize("engine", ["gspmd", "ddp"])
def test_one_process_engines_follow_jax(engine, weights):
    """One process, no process group: the port's engine against the JAX
    engine on one device (gspmd: DataParallelEngine; ddp: per-replica BN
    on one replica is the whole batch too)."""
    batches = _batches(seed=2)
    mesh = j_make_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    if engine == "gspmd":
        jeng = JDataParallelEngine(j_tiny_cnn(10), JSGD(), mesh, donate=False)
        teng = DataParallelEngine(tiny_cnn(10), SGD(), mesh=ONE_PROCESS,
                                  device="cpu")
    else:
        jeng = JDDPEngine(j_tiny_cnn(10), JSGD(), mesh, donate=False)
        teng = DDPEngine(tiny_cnn(10), SGD(), mesh=ONE_PROCESS, device="cpu")
    want = _jax_run(jeng, batches)
    got = _port_run(teng, weights, batches)
    _close_sums(got[0], want[0], **ENGINE)
    _close_trees(got[1], want[1], **ENGINE)
    _close_trees(got[2], want[2], **ENGINE)
    assert teng.grad_reductions == 0  # no process group, no collective


def test_bf16_step_follows_jax_at_the_bf16_bar(weights):
    batches = _batches(seed=3, n=1)
    mesh = j_make_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    want = _jax_run(JDataParallelEngine(j_tiny_cnn(10), JSGD(), mesh,
                                        donate=False,
                                        compute_dtype=jnp.bfloat16), batches)
    got = _port_run(DataParallelEngine(tiny_cnn(10), SGD(), mesh=ONE_PROCESS,
                                       compute_dtype=torch.bfloat16,
                                       device="cpu"), weights, batches)
    np.testing.assert_allclose(got[0][0]["loss_sum"], want[0][0]["loss_sum"],
                               **BF16)
    _close_trees(got[1], want[1], **BF16)
    _close_trees(got[2], want[2], **BF16)


def test_eval_step_masks_padding_rows(weights):
    """Label -1 rows (the Loader's padding) count nowhere; the sums equal
    the JAX engine's."""
    images, labels = _batches(seed=4, n=1)[0]
    labels[-5:] = -1
    mesh = j_make_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    jeng = JDataParallelEngine(j_tiny_cnn(10), JSGD(), mesh, donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in
            jeng.eval_step(jts, *jeng.shard_batch(images, labels)).items()}
    teng = DataParallelEngine(tiny_cnn(10), SGD(), mesh=ONE_PROCESS,
                              device="cpu")
    ts = teng.state_from_params(*from_jax_params(
        weights[0], model=teng.model, state=weights[1]))
    got = {k: float(v) for k, v in
           teng.eval_step(ts, *teng.shard_batch(images, labels)).items()}
    assert got["count"] == want["count"] == BATCH - 5
    _close_sums([got], [want], **ENGINE)


def test_device_normalize_transform_matches_host_normalize(weights):
    """`input_transform=device_normalizer` on uint8 batches gives the
    step a host-normalized batch gives."""
    from distributed_model_parallel_tpu_torch.data.datasets import (
        CIFAR10_MEAN,
        CIFAR10_STD,
    )
    from distributed_model_parallel_tpu_torch.data.loader import (
        device_normalizer,
        normalize,
    )

    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, BATCH)
    host = _port_run(DataParallelEngine(tiny_cnn(10), SGD(),
                                        mesh=ONE_PROCESS, device="cpu"),
                     weights,
                     [(normalize(images, CIFAR10_MEAN, CIFAR10_STD), labels)])
    dev = _port_run(DataParallelEngine(
        tiny_cnn(10), SGD(), mesh=ONE_PROCESS, device="cpu",
        input_transform=device_normalizer(CIFAR10_MEAN, CIFAR10_STD)),
        weights, [(images, labels)])
    assert host[0] == dev[0]
    jax.tree.map(np.testing.assert_array_equal, dev[1], host[1])


@pytest.mark.parametrize("knob,value,slice_", [
    ("grad_reduction", "bucketed", "gradient-reduction"),
    ("dcn_compression", "int8", "gradient-reduction"),
    ("expert_dispatch", "hierarchical", "expert-parallel"),
])
def test_ddp_engine_refuses_later_slices(knob, value, slice_):
    """Knobs of later slices are refused, naming the slice. The
    reducer's knobs, refused before the gradient-reduction slice was
    ported, now behave as the reference's: a bucketed engine builds on
    any mesh, a compressed wire needs a 'dcn' axis (its message). The
    expert dispatch, refused before the expert-parallel slice, builds
    the hierarchical exchange's policy (tests/test_torch_port_moe_
    exchange.py holds its steps); an unknown dispatch or the overlap
    without it is refused with the reference's message."""
    kw = dict(mesh=ONE_PROCESS, device="cpu")
    if slice_ == "expert-parallel":
        from distributed_model_parallel_tpu_torch.ops.expert_dispatch \
            import LocalExpertDispatch

        eng = DDPEngine(tiny_cnn(10), SGD(), **kw, **{knob: value},
                        expert_overlap=True)
        assert isinstance(eng._expert_dispatch, LocalExpertDispatch)
        assert eng._expert_dispatch.overlap
        with pytest.raises(ValueError, match="must be None or "
                                             "'hierarchical'"):
            DDPEngine(tiny_cnn(10), SGD(), **kw, **{knob: "flat"})
        with pytest.raises(ValueError, match="set expert_dispatch="
                                             "'hierarchical'"):
            DDPEngine(tiny_cnn(10), SGD(), **kw, expert_overlap=True)
    elif knob == "grad_reduction":
        eng = DDPEngine(tiny_cnn(10), SGD(), **kw, **{knob: value})
        assert eng.grad_reduction == value and eng._reducer is not None
    else:
        with pytest.raises(ValueError, match="carries no 'dcn' axis"):
            DDPEngine(tiny_cnn(10), SGD(), **kw, **{knob: value})


@pytest.mark.parametrize("spec,match", [
    (MeshSpec(model=2), "tensor-parallel slice"),
    (MeshSpec(seq=2), "sequence-parallel slice"),
    (MeshSpec(expert=2), "expert-parallel slice"),
    (MeshSpec(dcn=2), "gradient-reduction slice"),
    (MeshSpec(data=2), "needs 2 ranks"),
])
def test_mesh_spec_refuses_other_axes(spec, match):
    """Axes of later slices are refused by name; the dcn factor, ported
    with the gradient-reduction slice, must divide the data axis (the
    reference's check), and the model, seq and expert axes, ported with
    the tensor-, sequence- and expert-parallel slices, must divide the
    world."""
    if match in ("tensor-parallel slice", "sequence-parallel slice",
                 "expert-parallel slice"):
        axis = next(a for a in ("model", "seq", "expert")
                    if getattr(spec, a) > 1)
        with pytest.raises(ValueError,
                           match=rf"{axis}=2\) must divide the world"):
            spec.resolve(1)
        assert spec.resolve(4) == 2
    elif match == "gradient-reduction slice":
        with pytest.raises(ValueError,
                           match=r"dcn=2 must divide the data axis \(1\)"):
            spec.resolve(1)
        assert spec.resolve(4) == 4
    else:
        with pytest.raises(ValueError, match=match):
            spec.resolve(1)
    assert MeshSpec(data=-1).resolve(4) == 4


# ----------------------------------------------------------------- CLI

CLI = ["--device", "cpu", "--model", "tinycnn", "--dataset-type",
       "Synthetic", "-b", "64", "--val-batch-size", "128", "--epochs", "2",
       "--steps-per-epoch", "8", "--lr", "0.4"]


def test_cli_trains_with_a_falling_loss(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = dp_cli.main(CLI + ["--engine", "ddp"])
    losses = [h["train"]["loss"] for h in out["history"]]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert out["history"][-1]["val"]["count"] == 512
    log = (tmp_path / "log" / "data_para_64.txt").read_text()
    assert log.count("epoch") == 2
    # the best-val-acc model is saved by default
    assert (tmp_path / "checkpoint" / "ckpt.npz").exists()
    assert "checkpoints in ./checkpoint" in capsys.readouterr().out


def test_cli_two_gloo_ranks_log_on_rank_zero_only(tmp_path):
    """`torchrun --nproc-per-node 2` on the CPU: each rank trains on its
    shard, the metric sums are global, only rank 0 writes the log."""
    dirs = [tmp_path / "r0", tmp_path / "r1"]
    for d in dirs:
        d.mkdir()
    got = ranks.spawn(2, "cli_main", dict(
        dirs=[str(d) for d in dirs], argv=CLI + ["--engine", "ddp",
                                                 "--sync-bn"]), tmp_path)
    def sums(history):  # the epoch's numbers without its timings
        return [{part: {k: v for k, v in h[part].items()
                        if not k.endswith("_time")}
                 for part in ("train", "val")} for h in history]

    assert sums(got[0]["history"]) == sums(got[1]["history"])
    hist = got[0]["history"]
    assert hist[-1]["train"]["count"] == 8 * 64  # both ranks' rows
    assert hist[-1]["val"]["count"] == 512
    assert hist[1]["train"]["loss"] < hist[0]["train"]["loss"]
    assert (dirs[0] / "log" / "data_para_64.txt").exists()
    assert not (dirs[1] / "log").exists()


def test_cli_checks_batch_and_sync_bn_before_training():
    with pytest.raises(SystemExit, match="--sync-bn"):
        dp_cli.main(["--device", "cpu", "--sync-bn"])
    with pytest.raises(SystemExit, match="divisible"):
        check_batch_divisibility(5, Mesh(data=2, group=None))
    assert make_mesh(MeshSpec(data=-1)).data == 1
