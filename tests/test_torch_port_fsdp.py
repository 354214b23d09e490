"""The port's FSDP (`parallel/fsdp.py`, `--engine fsdp`) held against the
JAX package's `FSDPEngine` on the 8-virtual-device CPU mesh, on tinycnn
(the BERT classifier is `tests/test_torch_port_fsdp_bert.py`).

The port's ranks are gloo processes (`tests/_torch_port_ranks.py`): 2
and 4 ranks against `MeshSpec(data=2|4)`, each rank given its rows of
the same global batches, from the JAX engine's initial weights;
monolithic, bucketed (0.002 MB buckets) and overlapped x SGD (lr 0.05) /
AdamW (lr 1e-3), three steps, `min_shard_elems` 64 so that every conv
and the head shard.

Bars: the CNN engines' (`tests/test_torch_port_ddp.py`): rtol 1e-4,
atol 1e-5 on 8x8 images; the metric counts are integers and equal.

* `fsdp_specs` against the reference's on the cases of
  `tests/test_fsdp.py` (policy, no divisible dimension, the inclusive
  1024 boundary, the largest divisible dimension first, hybrid axes);
  the moments' specs follow the parameters', the count replicates.
* The engines: per-step metric sums, gathered parameters, BN state and
  optimizer state after 3 steps; each rank's parameter leaves have the
  reference's shard shapes (canonical layout).
* At N = 1, FSDP is bit-equal to the port's DDP in every mode.
* The construction refusals carry the reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.models import tiny_cnn as j_tiny_cnn
from distributed_model_parallel_tpu.parallel import fsdp as jfsdp
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu.training.optim import AdamW as JAdamW
from distributed_model_parallel_tpu_torch.models.convert import (
    ShapeDtype,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.parallel import fsdp
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    flatten_tree,
)
from distributed_model_parallel_tpu_torch.training.optim import SGD, AdamW

CNN = dict(rtol=1e-4, atol=1e-5)
LR = {"sgd": 0.05, "adamw": 1e-3}
MODES = ("monolithic", "bucketed", "overlapped")
CASES = [(n, gr, opt) for n in (2, 4) for gr in MODES
         for opt in ("sgd", "adamw")]
BATCH, STEPS, MIN_ELEMS, BUCKET_MB = 16, 3, 64, 0.002


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.rand(BATCH, 8, 8, 3).astype(np.float32),
             rng.randint(0, 10, BATCH).astype(np.int32))
            for _ in range(STEPS)]


def jax_tree(jts):
    """A JAX host TrainState as the canonical dict tree."""
    return jax.tree.map(np.asarray, {
        "params": jts.params, "model_state": jts.model_state,
        "opt_state": jts.opt_state._asdict(), "step": jts.step})


def jax_engine(model, n, gr, opt, wire="none", dcn=1, **kw):
    mesh = j_make_mesh(JMeshSpec(data=n, dcn=dcn),
                       devices=jax.devices()[:n])
    return jfsdp.FSDPEngine(model, JAdamW() if opt == "adamw" else JSGD(),
                            mesh, donate=False, grad_reduction=gr,
                            bucket_mb=BUCKET_MB, dcn_compression=wire, **kw)


def jax_run(eng, batches, lr):
    """(start params, start BN state, per-step sums, final canonical
    tree, the per-device shard shapes of every parameter)."""
    ts = eng.init_state(jax.random.PRNGKey(0))
    start = (jax.tree.map(np.asarray, ts.params),
             jax.tree.map(np.asarray, ts.model_state))
    sums = []
    for x, y in batches:
        ts, m = eng.train_step(ts, *eng.shard_batch(x, y), jnp.float32(lr))
        sums.append({k: float(v) for k, v in m.items()})
    shapes = [{k: next(tuple(s.data.shape) for s in a.addressable_shards
                       if s.device == dev)
               for k, a in flatten_tree(ts.params).items()}
              for dev in eng.mesh.devices.flat]
    return start, sums, jax_tree(eng.to_canonical(ts)), shapes


def assert_sums(got, want):
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("correct1", "correct5", "count")} == \
            {k: w[k] for k in ("correct1", "correct5", "count")}
        np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], **CNN)


def assert_trees(got, want, **bar):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   err_msg=k, **bar)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's runs for every case, and the port's: one spawn
    a world size, every case of that size in it."""
    batches = _batches()
    ref = {case: jax_run(jax_engine(j_tiny_cnn(10), *case,
                                    min_shard_elems=MIN_ELEMS),
                         batches, LR[case[2]])
           for case in CASES}
    params, state = ref[CASES[0]][0]
    port = {}
    for n in (2, 4):
        payload = {"model": "tinycnn", "params": params, "state": state,
                   "batches": batches, "min_shard_elems": MIN_ELEMS,
                   "runs": [{"name": (gr, opt), "gr": gr, "opt": opt,
                             "lr": LR[opt], "bucket_mb": BUCKET_MB}
                            for m, gr, opt in CASES if m == n]}
        got = ranks.spawn(n, "fsdp_suite", payload,
                          tmp_path_factory.mktemp(f"fsdp{n}"))
        for case in CASES:
            if case[0] == n:
                port[case] = [g[case[1:]] for g in got]
    return ref, port


# ------------------------------------------------------------------ specs

SPEC_CASES = {
    "policy": ({"big": (64, 33), "odd": (33, 35), "tiny": (16,)}, 8, {}),
    "no_divisible_dim": ({"prime3d": (31, 37, 41),
                          "small_div": (8, 35, 33)}, 8, {}),
    "inclusive_boundary": ({"at": (32, 32), "under": (32, 31),
                            "scalar": ()}, 8, {"min_shard_elems": 1024}),
    "largest_divisible_first": ({"w": (16, 64)}, 8,
                                {"min_shard_elems": 64}),
    "hybrid_axes": ({"w": (64, 3)}, 8, {"min_shard_elems": 64,
                                        "axes": ("dcn", "ici")}),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_fsdp_specs_match_the_reference(case):
    shapes, n, kw = SPEC_CASES[case]
    got = fsdp.fsdp_specs({k: ShapeDtype(s, np.float32)
                           for k, s in shapes.items()}, n, **kw)
    want = jfsdp.fsdp_specs({k: jax.ShapeDtypeStruct(s, jnp.float32)
                             for k, s in shapes.items()}, n, **kw)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_moment_specs_follow_the_parameters():
    """AdamW's mu / nu shard exactly like their parameters and the count
    replicates, as the reference's `state_shardings`; the momentum of
    SGD too."""
    for opt, fields in ((AdamW(), ("mu", "nu")), (SGD(), ("momentum",))):
        eng = fsdp.FSDPEngine(tiny_cnn(10), opt, device="cpu",
                              min_shard_elems=MIN_ELEMS)
        ts = eng.init_state(0)
        specs = eng.state_partition_specs(ts)
        sharded = [s for s in flatten_tree(specs.params).values() if s]
        assert sharded
        for f in fields:
            assert getattr(specs.opt_state, f) == specs.params
        if "count" in specs.opt_state._fields:
            assert specs.opt_state.count is None
        assert all(s is None
                   for s in flatten_tree(specs.model_state).values())


# ---------------------------------------------------------------- engines

@pytest.mark.parametrize("case", CASES, ids=[f"n{n}-{gr}-{opt}"
                                             for n, gr, opt in CASES])
def test_fsdp_matches_the_reference_engine(runs, case):
    ref, port = runs
    _, sums, canonical, _ = ref[case]
    for rank_out in port[case]:
        assert_sums(rank_out["sums"], sums)
    # Every rank gathers the same canonical tree.
    assert_trees(port[case][0]["canonical"], canonical, **CNN)
    for other in port[case][1:]:
        assert_trees(other["canonical"], port[case][0]["canonical"],
                     rtol=0, atol=0)


@pytest.mark.parametrize("n", (2, 4))
def test_rank_leaves_are_the_reference_shard_shapes(runs, n):
    """Rank r holds the shape of the reference's shard on device r, for
    every parameter: 1/N of each sharded leaf, the whole of the rest."""
    ref, port = runs
    case = (n, "monolithic", "sgd")
    want = ref[case][3]
    for r, rank_out in enumerate(port[case]):
        assert rank_out["shapes"] == want[r]
    full = {k: v.shape for k, v in flatten_tree(ref[case][2]["params"])
            .items()}
    sharded = [k for k, s in port[case][0]["shapes"].items()
               if s != full[k]]
    assert len(sharded) >= 3


@pytest.mark.parametrize("gr", MODES)
def test_fsdp_at_one_rank_is_bit_equal_to_ddp(gr):
    """At N = 1 the gathers and slices are identities: three AdamW steps
    of FSDP equal DDP's bit for bit, losses and the whole state."""
    rng = np.random.RandomState(1)
    x = rng.rand(BATCH, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, BATCH).astype(np.int32)
    out = []
    for cls in (DDPEngine, fsdp.FSDPEngine):
        eng = cls(tiny_cnn(10), AdamW(), device="cpu", grad_reduction=gr,
                  bucket_mb=BUCKET_MB)
        ts = eng.init_state(0)
        losses = []
        for _ in range(STEPS):
            ts, m = eng.train_step(ts, *eng.shard_batch(x, y), 1e-3)
            losses.append(float(m["loss_sum"]))
        tree = (eng.to_canonical(ts) if cls is fsdp.FSDPEngine
                else train_state_to_jax(ts))
        out.append((losses, tree))
    assert out[0][0] == out[1][0]
    assert_trees(out[1][1], out[0][1], rtol=0, atol=0)


def _message(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    {"rules": ((r"w$", None),)},
    {"grad_reduction": "ring"},
    {"dcn_compression": "fp8"},
    {"dcn_compression": "int8"},
    {"grad_reduction": "bucketed", "collective_matmul": True},
], ids=["rules", "grad_reduction", "wire_name", "wire_without_dcn",
        "collective_matmul"])
def test_construction_refusals_carry_the_reference_messages(kw):
    port = _message(lambda: fsdp.FSDPEngine(tiny_cnn(10), SGD(),
                                            device="cpu", **kw))
    mesh = j_make_mesh(JMeshSpec(data=2), devices=jax.devices()[:2])
    ref = _message(lambda: jfsdp.FSDPEngine(j_tiny_cnn(10), JSGD(), mesh,
                                            **kw))
    assert port == ref


def test_cli_finetune_places_the_torch_weights_in_the_fsdp_layout(
        tmp_path, monkeypatch):
    """`--engine fsdp --finetune` transplants a reference-layout torch
    checkpoint through full trees and re-slices it into the engine's
    layout (the JAX CLI's `_state_sh` placement): the state the trainer
    starts from gathers back to the checkpoint's weights."""
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.training.trainer import Trainer
    from test_torch_import import make_state_dict

    sd = make_state_dict(num_classes=1000)
    np.savez(tmp_path / "pre.npz", **sd)
    monkeypatch.chdir(tmp_path)
    started = {}
    fit = Trainer.fit

    def recording(self):
        started["canonical"] = self.engine.to_canonical(self.state)
        return fit(self)

    monkeypatch.setattr(Trainer, "fit", recording)
    out = data_parallel.main([
        "--device", "cpu", "--model", "mobilenetv2", "--dataset-type",
        "Synthetic", "-b", "16", "--val-batch-size", "256", "--epochs", "1",
        "--steps-per-epoch", "1", "--lr", "0.001", "--engine", "fsdp",
        "--finetune", str(tmp_path / "pre.npz"), "--checkpoint-dir", "ck"])
    assert len(out["history"]) == 1
    stem = started["canonical"]["params"]["stem"]["conv1"]["w"]
    np.testing.assert_array_equal(
        stem, np.transpose(sd["conv1.weight"], (2, 3, 1, 0)))
    assert started["canonical"]["step"] == 0
