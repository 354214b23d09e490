"""The port's gradient-reduction slice held against the JAX package:
`ops/grad_reduction.py` (bucket plans, the two halves, the bucketed
mean), the stagewise backward of `models/staging.py`, `DDPEngine` and
the LM engine with `grad_reduction` / `dcn_compression` over a
`MeshSpec(dcn=K)` mesh, and the CLIs' reducer checks.

Multi-rank cases run on gloo ranks (`tests/_torch_port_ranks.py`), one
spawn for each world size, shared by every case that reads it; the
reference runs on as many of the 8 virtual CPU devices, from the same
weights and batches (rank r takes rows [rB/S, (r+1)B/S), the reference's
dcn-major data sharding).

Tolerances:
* bucket plans, block counts, leaf order, messages: equal;
* the stagewise backward against one `torch.autograd.grad`: bit for bit
  in f32 (the reference holds its own chain to `jax.grad` the same way);
* the two halves and the f32 bucketed mean: rtol 1e-5 / atol 1e-7 (the
  sums run in another order: NCCL-style rings against the reference's
  bidirectional ppermute chains); bf16 leaves and compressed wires at
  the reference's own bars for them (rtol 5e-2, atol 2e-2,
  `tests/test_grad_reduction.py`, `tests/test_wire_codec.py`);
* engines with an f32 wire: rtol 1e-4 / atol 1e-5 for tinycnn's BN
  steps, ROADMAP's bar for the CNN engines (`tests/test_torch_port_ddp.
  py`), rtol 1e-5 / atol 1e-6 for the LM; with a compressed wire the
  reference's trajectory budgets (bf16 1e-2, int8 5e-2). Top-1/top-5
  counts and counts are integers and must be equal.
"""

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.cli import common as jcommon
from distributed_model_parallel_tpu.cli import data_parallel as jdp_cli
from distributed_model_parallel_tpu.cli import lm as jlm_cli
from distributed_model_parallel_tpu.models import gpt as jgpt
from distributed_model_parallel_tpu.models import staging as jstaging
from distributed_model_parallel_tpu.models.tinycnn import tiny_cnn as j_tiny
from distributed_model_parallel_tpu.ops import grad_reduction as jgr
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine as JLMEngine,
)
from distributed_model_parallel_tpu.runtime.compat import shard_map
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.cli import common as tcommon
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.cli import lm as lm_cli
from distributed_model_parallel_tpu_torch.models import bert as tbert
from distributed_model_parallel_tpu_torch.models import gpt as tgpt
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import mobilenetv2 as tmbv2
from distributed_model_parallel_tpu_torch.models import resnet as tresnet
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models import tinycnn as ttiny
from distributed_model_parallel_tpu_torch.models import vit as tvit
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
)
from distributed_model_parallel_tpu_torch.ops import grad_reduction as tgr
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    Mesh,
    data_axis_names,
    data_axis_size,
    data_hierarchy_axes,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    SGD,
    tree_leaves,
)

F32 = dict(rtol=1e-5, atol=1e-7)
LOOSE = dict(rtol=5e-2, atol=2e-2)  # bf16 leaves, compressed wires
ENGINE = dict(rtol=1e-4, atol=1e-5)
LM_TOL = dict(rtol=1e-5, atol=1e-6)
BUDGET = {"none": None, "bf16": 1e-2, "int8": 5e-2}
BATCH, STEPS, LR = 16, 3, 0.1
GPT_KW = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
              max_position=16, dropout_rate=0.0, pad_token_id=0)
ONE = Mesh(1, None)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _key_paths(tree, prefix=()):
    """The port tree's leaf paths in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], prefix + (k,))]
    return [prefix]


def _jax_paths(tree):
    return [tuple(str(k.key) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------ bucket plans

def _trees(name):
    """(reference params, port params) of one model at init."""
    if name == "gpt":
        jp = jgpt.gpt_lm(jgpt.GPTConfig(**GPT_KW)).init(
            jax.random.PRNGKey(0))[0]
        return jp, tgpt.init_params(tgpt.GPTConfig(**GPT_KW))
    from distributed_model_parallel_tpu.models import mobilenetv2 as jm

    jmodel = j_tiny(10) if name == "tinycnn" else jm.mobilenet_v2(10)
    tmodel = ttiny.tiny_cnn(10) if name == "tinycnn" else \
        tmbv2.mobilenet_v2(10)
    jp = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[0]
    return jp, tmodel.init(torch.Generator().manual_seed(0))[0]


@pytest.mark.parametrize("name", ["tinycnn", "mobilenetv2", "gpt"])
def test_plan_buckets_matches_reference(name):
    """Slot for slot on the same leaf list, at 25, 1, 0.01 MiB and one
    bucket (inf); the leaf order is the reference's `tree_flatten`."""
    jp, tp = _trees(name)
    assert _key_paths(tp) == _jax_paths(jp)
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = list(tree_leaves(tp))
    for mb in (25.0, 1.0, 0.01, math.inf):
        want = jgr.plan_buckets(jleaves, mb)
        got = tgr.plan_buckets(tleaves, mb)
        assert len(got) == len(want), mb
        for g, w in zip(got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            assert g.size == w.size
            assert [(s.index, s.offset, s.size) for s in g.slots] == [
                (s.index, s.offset, s.size) for s in w.slots]
            for s, t in zip(g.slots, w.slots):
                assert math.prod(s.shape) == math.prod(t.shape)
    if name == "mobilenetv2":
        # 9.2 MB of f32 gradients: one bucket at the default 25 MB
        assert len(tgr.plan_buckets(tleaves)) == 1
    # mixed dtypes group, the order of first appearance kept
    mixed = tleaves[:3] + [tleaves[3].to(torch.bfloat16)] + tleaves[4:6]
    jmixed = jleaves[:3] + [jnp.zeros(jleaves[3].shape, jnp.bfloat16)] + \
        jleaves[4:6]
    got = [(str(b.dtype).split(".")[-1], [s.index for s in b.slots])
           for b in tgr.plan_buckets(mixed, 1e-3)]
    assert got == [(str(b.dtype), [s.index for s in b.slots])
                   for b in jgr.plan_buckets(jmixed, 1e-3)]


def test_plan_buckets_refusals_match_reference():
    for args in (([jnp.zeros(3, jnp.int32)], 25.0),
                 ([jnp.zeros(3)], 0.0), ([jnp.zeros(3)], -1.0)):
        leaves = [torch.zeros(3, dtype=torch.int32 if x.dtype == jnp.int32
                              else torch.float32) for x in args[0]]
        with pytest.raises((TypeError, ValueError)) as want:
            jgr.plan_buckets(*args)
        with pytest.raises(want.type) as got:
            tgr.plan_buckets(leaves, args[1])
        assert str(got.value).replace("torch.", "") == str(want.value)


def test_stage_trees_flatten_in_reference_order():
    """A stage tree keyed '0'..'18' (MobileNetV2 as one stage) flattens
    in the reference's order: keys sort as strings in both."""
    jp, tp = _trees("mobilenetv2")
    cuts = staging.split_points(1, None, 17)
    t_stage = staging.partition_tree(tp, cuts)[0]
    j_stage = jstaging.partition_tree(jp, cuts)[0]
    assert sorted(t_stage) == sorted(j_stage) and "10" in t_stage
    assert _key_paths(t_stage) == _jax_paths(j_stage)


@pytest.mark.parametrize("family", ["tinycnn", "mobilenetv2", "resnet18",
                                    "vit", "bert_tiny"])
def test_model_anatomy_matches_reference(family):
    """Each family's `.parts` has the reference's block count, so the
    --overlap-stages limits agree."""
    from distributed_model_parallel_tpu.cli.common import MODELS as JMODELS

    assert len(tcommon.MODELS[family](10).parts.blocks) == len(
        JMODELS[family](10).parts.blocks)


# ------------------------------------------------- the stagewise backward

def _vit_small(remat):
    cfg = tvit.ViTConfig(image_size=16, patch_size=4, dim=32, num_layers=3,
                         num_heads=4, mlp_dim=64, dropout_rate=0.3)
    return tvit.vit(10, cfg, remat=remat)


MODELS = {
    "tinycnn": (lambda remat: ttiny.tiny_cnn(10, remat=remat), (4, 8, 8)),
    "mobilenetv2": (lambda remat: tmbv2.mobilenet_v2(10, remat=remat),
                    (1, 32, 32)),
    "vit_dropout": (_vit_small, (4, 16, 16)),
}


def _stagewise(model, cuts, params, state, x, ctx, on_stage_grads=None):
    def loss_head(y):
        return (y.float() ** 2).sum(), None

    loss, _, grads, new_states = staging.stagewise_value_and_grad(
        staging.stage_apply_fns(model.parts, cuts, ctx), loss_head,
        staging.partition_tree(params, cuts),
        staging.partition_tree(state, cuts), x,
        on_stage_grads=on_stage_grads)
    return (loss, staging.unpartition_tree(grads, cuts),
            staging.unpartition_tree(new_states, cuts))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_stagewise_grads_bit_equal_to_one_backward(name, remat):
    """The chain of per-stage `torch.autograd.grad` calls equals one
    `torch.autograd.grad` over the whole model bit for bit, BN state and
    remat recomputes included; ViT with dropout 0.3 draws the same masks
    (the stage closures keep the model's `Context.child` chain)."""
    build, (b, h, w) = MODELS[name]
    model = build(remat)
    params, state = model.init(torch.Generator().manual_seed(0))
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(np.random.RandomState(3).rand(b, h, w, 3)
                         .astype(np.float32))
    ctx = L.Context(train=True, rng=L.fold_in(L.root_key(0), 7))
    cuts = staging.split_points(3, None, len(model.parts.blocks))
    loss_s, grads_s, state_s = _stagewise(model, cuts, params, state, x, ctx)
    y, state_m = model.apply(params, state, x, ctx)
    loss_m = (y.float() ** 2).sum()
    grads_m = torch.autograd.grad(loss_m, leaves)
    assert torch.equal(loss_s, loss_m.detach())
    for a, g in zip(tree_leaves(grads_s), grads_m):
        assert torch.equal(a, g)
    for a, g in zip(tree_leaves(state_s), tree_leaves(state_m)):
        assert torch.equal(a, g)
    if name == "vit_dropout":  # the masks are live: dropout 0 differs
        y0, _ = model.apply(params, state, x, L.Context(train=True))
        assert not torch.equal(y0, y)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_segments_bit_equal_to_one_backward(remat):
    """The LM engine's overlapped segments (stem, blocks cut at the split
    points, head) give monolithic's losses and parameters bit for bit,
    with dropout 0.1 live and under remat, no process group."""
    cfg = tgpt.GPTConfig(**dict(GPT_KW, num_layers=3, dropout_rate=0.1))
    out = {}
    for gr, rm in (("monolithic", False), ("overlapped", remat)):
        eng = CausalLMSequenceParallelEngine(
            cfg, SGD(), attention="ulysses_flash", device="cpu", mesh=ONE,
            grad_reduction=gr, remat=rm)
        ts = eng.init_state(0)
        sums = []
        for _ in range(2):
            ts, m = eng.train_step(ts, *eng.shard_batch(_ids()), 0.05)
            sums.append(float(m["loss_sum"]))
        out[gr] = sums, list(tree_leaves(ts.params))
    assert out["overlapped"][0] == out["monolithic"][0]
    for a, b in zip(out["overlapped"][1], out["monolithic"][1]):
        assert torch.equal(a, b)


def test_stagewise_hook_sees_stages_in_reverse_and_trees_roundtrip():
    model = ttiny.tiny_cnn(10)
    params, state = model.init(torch.Generator().manual_seed(0))
    for t in tree_leaves(params):
        t.requires_grad_(True)
    x = torch.rand(2, 8, 8, 3)
    cuts = staging.split_points(4, None, len(model.parts.blocks))
    seen = []

    def hook(k, g):
        seen.append(k)
        return g

    _stagewise(model, cuts, params, state, x, L.Context(train=True), hook)
    assert seen == [3, 2, 1, 0]
    for n in (1, 2, 4):
        c = staging.split_points(n, None, 4)
        back = staging.unpartition_tree(staging.partition_tree(params, c), c)
        assert _key_paths(back) == _key_paths(params)
        assert all(a is b for a, b in zip(tree_leaves(back),
                                          tree_leaves(params)))


def test_resolve_guards_match_reference():
    for args in ((4, 0, "E"), (6, 0, "E"), (4, 3, "E"), (4, 4, "E")):
        assert staging.resolve_overlap_segments(*args) == \
            jstaging.resolve_overlap_segments(*args)
    for args, kw in (((1, 0, "E"), {}), ((4, 1, "E"), {}),
                     ((4, 9, "E"), {"noun": "decoder blocks"})):
        with pytest.raises(ValueError) as want:
            jstaging.resolve_overlap_segments(*args, **kw)
        with pytest.raises(ValueError) as got:
            staging.resolve_overlap_segments(*args, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jstaging.resolve_overlap_stages(None, 0, "DDPEngine")
    with pytest.raises(ValueError) as got:
        staging.resolve_overlap_stages(None, 0, "DDPEngine")
    assert str(got.value) == str(want.value)


def test_engine_construction_guards():
    """A model without anatomy, a 1-segment cut, more segments than
    blocks, a 1-layer LM and an unknown mode fail at construction."""
    partless = L.sequential(L.flatten(), L.linear(192, 10))
    kw = dict(mesh=ONE, device="cpu")
    with pytest.raises(ValueError, match="parts"):
        DDPEngine(partless, SGD(), grad_reduction="overlapped", **kw)
    for n in (1, 9):
        with pytest.raises(ValueError, match="overlap_stages"):
            DDPEngine(ttiny.tiny_cnn(10), SGD(), grad_reduction="overlapped",
                      overlap_stages=n, **kw)
    with pytest.raises(ValueError, match="grad_reduction"):
        DDPEngine(ttiny.tiny_cnn(10), SGD(), grad_reduction="fused", **kw)
    with pytest.raises(ValueError, match="num_layers"):
        CausalLMSequenceParallelEngine(
            tgpt.GPTConfig(**dict(GPT_KW, num_layers=1)), SGD(),
            grad_reduction="overlapped", **kw)
    assert (data_axis_names(ONE), data_axis_size(ONE),
            data_hierarchy_axes(ONE)) == (("data",), 1, (None, None, None))


# ------------------------------------------------------- multi-rank runs

def _tree_inputs(world):
    """One mixed-dtype tree a rank, awkward (prime) sizes so that every
    bucket has an uneven tail; f32 arrays, the 'w2' leaf cast to bf16 on
    both sides."""
    shapes = {"w1": (13, 7), "b1": (7,), "w2": (31, 3), "scalar": (),
              "w3": (97,)}
    rngs = [np.random.RandomState(i) for i in range(world)]
    return {k: np.stack([np.asarray(r.randn(*s), np.float32) for r in rngs])
            for k, s in shapes.items()}


TREE_CASES = [(1, "none"), (2, "none"), (2, "bf16"), (2, "int8")]
DDP_CONFIGS = [(gr, 1, "none") for gr in ("bucketed", "overlapped")] + [
    (gr, 2, w) for gr in ("bucketed", "overlapped")
    for w in ("none", "bf16", "int8")] + [("monolithic", 2, "int8")]
LM_CONFIGS = {2: [("monolithic", 1, "none"), ("bucketed", 1, "none"),
                  ("overlapped", 1, "none")],
              4: [("monolithic", 2, "none"), ("bucketed", 2, "none"),
                  ("overlapped", 2, "none"), ("bucketed", 2, "int8")]}


def _batches(n=STEPS):
    rng = np.random.RandomState(0)
    return [(rng.randn(BATCH, 8, 8, 3).astype(np.float32),
             rng.randint(0, 10, size=BATCH).astype(np.int32))
            for _ in range(n)]


def _ids():
    return np.random.RandomState(5).randint(1, 64, size=(8, 16)).astype(
        np.int32)


@pytest.fixture(scope="module")
def weights():
    p, s = j_tiny(10).init(jax.random.PRNGKey(0))
    gp = JLMEngine(jgpt.GPTConfig(**GPT_KW), JSGD(0.9, 1e-2), _jmesh(1, 1),
                   donate=False).init_state(jax.random.PRNGKey(0)).params
    return _np(p), _np(s), _np(gp)


def _jmesh(world, dcn):
    """The reference mesh over `world` virtual devices; it names every
    axis, 'seq' (of size 1) included, as the LM engine needs."""
    return j_mesh(JMeshSpec(data=world, dcn=dcn),
                  devices=jax.devices()[:world])


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """Every multi-rank case of the file: one spawn of 2 gloo ranks and
    one of 4."""
    out = {}
    for world in (2, 4):
        flat = np.random.RandomState(world).randn(world, 6 * world).astype(
            np.float32)
        shard = np.random.RandomState(world + 10).randn(world, 5).astype(
            np.float32)
        engines = {"lm": LM_CONFIGS[world], "gpt": GPT_KW,
                   "gpt_params": weights[2], "ids": _ids(), "lm_steps": 3,
                   "lm_lr": 0.05}
        if world == 4:
            engines.update(ddp=DDP_CONFIGS, params=weights[0],
                           state=weights[1], batches=_batches(), lr=LR)
        out[world] = ranks.spawn(world, "reducer_suite", {
            "ops": {"meshes": [1, 2], "flat": flat, "shard": shard,
                    "tree": _tree_inputs(world), "bf16": ["w2"],
                    "tree_cases": TREE_CASES if world == 4 else []},
            "engines": engines,
        }, tmp_path_factory.mktemp(f"w{world}"))
        out[world, "inputs"] = flat, shard
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_groups_and_replica_index(port_runs, world):
    """Slice-major groups: rank = dcn_index * ici + ici_index."""
    for r, res in enumerate(port_runs[world]):
        assert res["groups", 1] == (list(range(world)), None)
        ici = world // 2
        assert res["groups", 2] == (
            [r // ici * ici + j for j in range(ici)],
            [d * ici + r % ici for d in range(2)])
        assert res["replica"] == {1: r, 2: r}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_halves_match_reference(port_runs, world):
    flat, shard = port_runs[world, "inputs"]
    mesh = JMesh(np.array(jax.devices()[:world]), ("d",))

    def run(fn, x, out_spec):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(P("d"),), out_specs=out_spec,
            check_vma=False))(jnp.asarray(x.reshape(-1))))

    rs = run(lambda v: jgr.ring_reduce_scatter(v, "d"), flat, P("d"))
    ag = run(lambda v: jgr.ring_all_gather(v, "d"), shard, P(None))
    for r, res in enumerate(port_runs[world]):
        np.testing.assert_allclose(res["rs"], rs.reshape(world, -1)[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res["ag"], ag)


def _jax_pmean(world, dcn, wire):
    trees = _tree_inputs(world)
    shape = (world,) if dcn == 1 else (dcn, world // dcn)
    axes = ("data",) if dcn == 1 else ("dcn", "ici")
    mesh = JMesh(np.array(jax.devices()[:world]).reshape(shape), axes)
    stacked = {k: jnp.asarray(v.reshape(shape + v.shape[1:]),
                              jnp.bfloat16 if k == "w2" else jnp.float32)
               for k, v in trees.items()}
    spec = {k: P(*axes) for k in stacked}

    def body(t):
        sq = {k: v.reshape(v.shape[len(shape):]) for k, v in t.items()}
        out = jgr.bucketed_pmean(sq, axes[-1], axes[0] if dcn > 1 else None,
                                 bucket_mb=0.0005, dcn_compression=wire)
        return {k: v.reshape((1,) * len(shape) + v.shape)
                for k, v in out.items()}

    got = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                            out_specs=spec, check_vma=False))(stacked)
    return {k: np.asarray(v, np.float32).reshape((world,) + v.shape[
        len(shape):]) for k, v in got.items()}


@pytest.mark.parametrize("dcn,wire", TREE_CASES)
def test_bucketed_pmean_matches_reference(port_runs, dcn, wire):
    """A mixed-dtype, uneven-tail tree at 4 ranks, one bucket a few
    leaves (0.0005 MiB), on one fabric and on 2 slices x 2, each wire."""
    want = _jax_pmean(4, dcn, wire)
    for r, res in enumerate(port_runs[4]):
        got = res["tree", dcn, wire]
        assert sorted(got) == sorted(want)
        for k in got:
            tol = F32 if wire == "none" and k != "w2" else LOOSE
            np.testing.assert_allclose(got[k], want[k][r], err_msg=k, **tol)


def _jax_ddp(config, weights):
    gr, dcn, wire = config
    eng = JDDPEngine(j_tiny(10), JSGD(), _jmesh(4, dcn), donate=False,
                     grad_reduction=gr, bucket_mb=0.002,
                     dcn_compression=wire)
    ts = eng.init_state(jax.random.PRNGKey(0))
    sums = []
    for images, labels in _batches():
        ts, m = eng.train_step(ts, *eng.shard_batch(images, labels),
                               jnp.float32(LR))
        sums.append({k: float(v) for k, v in m.items()})
    return sums, _np(ts.params), _np(ts.model_state)


def _close(got, want, **tol):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **tol)


@pytest.mark.parametrize("config", DDP_CONFIGS,
                         ids=["-".join(map(str, c)) for c in DDP_CONFIGS])
def test_ddp_engine_matches_reference(port_runs, weights, config):
    """DDPEngine on tinycnn at 4 ranks, 3 SGD steps: the metric sums on
    every rank and the final parameters and BN state against the
    reference engine on the same (dcn x ici) mesh; compressed wires at
    the reference's trajectory budget."""
    want_sums, want_p, want_s = _jax_ddp(config, weights)
    budget = BUDGET[config[2]]
    for res in port_runs[4]:
        got = res[("ddp",) + config]
        for g, w in zip(got["sums"], want_sums):
            for k in ("correct1", "correct5", "count"):
                if budget is None:
                    assert g[k] == w[k], (k, g, w)
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                       rtol=budget or ENGINE["rtol"])
        if budget is None:
            _close(got["params"], want_p, **ENGINE)
            _close(got["state"], want_s, **ENGINE)
        assert got["collectives"] > 0
    losses = [s["loss_sum"] for s in port_runs[4][0][("ddp",) + config]
              ["sums"]]
    assert losses[-1] < losses[0]


def _jax_lm(world, config, weights):
    gr, dcn, wire = config
    eng = JLMEngine(jgpt.GPTConfig(**GPT_KW), JSGD(0.9, 1e-2),
                    _jmesh(world, dcn), donate=False,
                    grad_reduction=gr, bucket_mb=0.02, dcn_compression=wire)
    ts = eng.init_state(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(_np(ts.params)["head"]["w"],
                                  weights[2]["head"]["w"])
    a, b = eng.shard_batch(_ids())
    sums = []
    for _ in range(3):
        ts, m = eng.train_step(ts, a, b, jnp.float32(0.05))
        sums.append({k: float(v) for k, v in m.items()})
    return sums, _np(ts.params)


@pytest.mark.parametrize("world,config", [
    (w, c) for w in (2, 4) for c in LM_CONFIGS[w]],
    ids=[f"{w}-" + "-".join(map(str, c)) for w in (2, 4)
         for c in LM_CONFIGS[w]])
def test_lm_engine_matches_reference(port_runs, weights, world, config):
    """The LM engine over 2 and 4 data ranks (and 2 slices x 2): metric
    sums on every rank and the final parameters against the reference's
    `CausalLMSequenceParallelEngine` at seq 1, 3 SGD steps."""
    want_sums, want_p = _jax_lm(world, config, weights)
    budget = BUDGET[config[2]]
    for res in port_runs[world]:
        got = res[("lm",) + config]
        for g, w in zip(got["sums"], want_sums):
            assert g["count"] == w["count"]
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                       rtol=budget or LM_TOL["rtol"])
        if budget is None:
            _close(got["params"], want_p, **LM_TOL)
        n = {"monolithic": 3}.get(config[0])
        if n is not None:
            assert got["collectives"] == n


def test_one_rank_with_a_group_is_bit_equal_to_no_group(weights, tmp_path):
    """At one rank every reduction is the identity: each mode through a
    gloo world of one (collectives issued) equals the engine with no
    process group bit for bit, DDP and LM."""
    ddp = [(gr, 1, "none") for gr in ("monolithic", "bucketed",
                                      "overlapped")]
    lm = ddp
    got = ranks.spawn(1, "reducer_engines", {
        "ddp": ddp, "params": weights[0], "state": weights[1],
        "batches": _batches(2), "lr": LR, "lm": lm, "gpt": GPT_KW,
        "gpt_params": weights[2], "ids": _ids(), "lm_steps": 2,
        "lm_lr": 0.05}, tmp_path)[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks run one thread each
    try:
        model = ttiny.tiny_cnn(10)
        for gr, _, _ in ddp:
            eng = DDPEngine(model, SGD(), mesh=ONE, device="cpu",
                            grad_reduction=gr, bucket_mb=0.002)
            ts = eng.state_from_params(*from_jax_params(
                weights[0], model=model, state=weights[1]))
            for (images, labels), want in zip(
                    _batches(2), got["ddp", gr, 1, "none"]["sums"]):
                ts, m = eng.train_step(ts, *eng.shard_batch(images, labels),
                                       LR)
                assert {k: float(v) for k, v in m.items()} == want
            # 1 all-reduce a step, or 2 a bucket (per stage tree when
            # overlapped)
            trees = [ts.params]
            if gr == "overlapped":
                trees = staging.partition_tree(ts.params, eng._cuts)
            buckets = sum(len(tgr.plan_buckets(list(tree_leaves(t)), 0.002))
                          for t in trees)
            assert got["ddp", gr, 1, "none"]["collectives"] == 2 * (
                1 if gr == "monolithic" else 2 * buckets)
        for gr, _, _ in lm:
            eng = CausalLMSequenceParallelEngine(
                tgpt.GPTConfig(**GPT_KW), SGD(0.9, 1e-2), device="cpu",
                mesh=ONE, grad_reduction=gr, bucket_mb=0.02)
            ts = eng.state_from_params(from_jax_params(weights[2]))
            for want in got["lm", gr, 1, "none"]["sums"]:
                ts, m = eng.train_step(ts, *eng.shard_batch(_ids()), 0.05)
                assert {k: float(v) for k, v in m.items()} == want
            assert eng.grad_reductions == 0  # no group, no collective
    finally:
        torch.set_num_threads(threads)


# -------------------------------------------------------------- the CLIs

DP_ARGVS = [
    ["--grad-reduction", "bucketed"],
    ["--bucket-mb", "4"],
    ["--engine", "ddp", "--grad-reduction", "bucketed", "--bucket-mb", "0"],
    ["--overlap-stages", "2"],
    ["--engine", "ddp", "--grad-reduction", "overlapped",
     "--overlap-stages", "1"],
    ["--dcn-slices", "0"],
    ["--dcn-compression", "int8"],
    ["--dcn-compression", "int8", "--dcn-slices", "2"],
    ["--engine", "ddp", "--grad-reduction", "overlapped", "--model",
     "tinycnn", "--overlap-stages", "5"],
]
LM_ARGVS = [
    ["--pipeline-stages", "2", "--grad-reduction", "bucketed"],
    ["--pipeline-stages", "2", "--dcn-slices", "2"],
    ["--grad-reduction", "overlapped", "--layers", "1"],
    ["--grad-reduction", "overlapped", "--overlap-stages", "5",
     "--layers", "4"],
    ["--bucket-mb", "-1", "--grad-reduction", "bucketed"],
]


@pytest.mark.parametrize("cli,argv", [("dp", a) for a in DP_ARGVS] + [
    ("lm", a) for a in LM_ARGVS])
def test_cli_reducer_checks_match_reference(cli, argv):
    """Each reducer misconfiguration exits with the reference CLI's own
    message, before any dataset or process group is built."""
    jmain, tmain = ((jdp_cli.main, dp_cli.main) if cli == "dp"
                    else (jlm_cli.main, lm_cli.main))
    with pytest.raises(SystemExit) as want:
        jmain(argv)
    with pytest.raises(SystemExit) as got:
        tmain(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value)


def test_grad_reduction_args_resolve_like_reference():
    for argv in ([], ["--grad-reduction", "bucketed", "--bucket-mb", "1"],
                 ["--grad-reduction", "overlapped", "--overlap-stages", "3"]):
        ns = []
        for add in (jcommon.add_grad_reduction_flags,
                    tcommon.add_grad_reduction_flags):
            p = argparse.ArgumentParser()
            add(p)
            ns.append(p.parse_args(argv))
        jcommon.check_grad_reduction_args(ns[0])
        tcommon.check_grad_reduction_args(ns[1])
        assert vars(ns[0]) == vars(ns[1])
    for name, stages in (("tinycnn", 5), ("mobilenetv2", 18)):
        with pytest.raises(SystemExit) as want:
            jcommon.check_overlapped_model(name, stages)
        with pytest.raises(SystemExit) as got:
            tcommon.check_overlapped_model(name, stages)
        assert str(got.value) == str(want.value)
    tcommon.check_overlapped_model("bert_tiny", 4)
    assert tbert.bert_for_classification(2).parts is not None
    assert tresnet.resnet18(10).parts is not None
