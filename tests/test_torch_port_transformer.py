"""The port's transformer classifiers (`models/transformer.py`,
`models/vit.py`, `models/bert.py`) and `SyntheticText` held against the
JAX package: the same weights (carried by `models/convert.py`), the same
numpy-seeded inputs, dropout 0 (jax.random's bits cannot be matched).

Tolerances: logits and one DDP step at rtol 1e-5 (atol 1e-6), the f32
bar of the port's parity files (tests/test_torch_port_lm.py); the
pipeline's BERT step against the whole model's at the same bar (the
microbatch sums run in another order); datasets, parameter counts and
checkpoints exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.data import datasets as jds
from distributed_model_parallel_tpu.parallel.data_parallel import (
    DDPEngine as JDDPEngine,
)
from distributed_model_parallel_tpu.parallel.data_parallel import (
    TrainState as JTrainState,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training import checkpoint as jckpt
from distributed_model_parallel_tpu.training import optim as joptim
from distributed_model_parallel_tpu_torch.cli.common import MODELS
from distributed_model_parallel_tpu_torch.data import datasets as tds
from distributed_model_parallel_tpu_torch.models import bert, staging, vit
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
    train_state_from_jax,
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training import checkpoint as ckpt
from distributed_model_parallel_tpu_torch.training.optim import (
    SGD,
    AdamW,
    tree_leaves,
)

# The JAX package's models/__init__ binds `vit` and `bert`-family names
# to constructors; the modules come from importlib.
jvit = importlib.import_module("distributed_model_parallel_tpu.models.vit")
jbert = importlib.import_module("distributed_model_parallel_tpu.models.bert")

F32 = dict(rtol=1e-5, atol=1e-6)
ONE = Mesh(data=1, group=None)
LR = 0.05
VIT = dict(image_size=8, patch_size=4, dim=32, num_layers=2, num_heads=4,
           mlp_dim=64)
# The CLI's bert_tiny widths (cli/common.py), dropout 0.
BERT = dict(vocab_size=512, hidden_size=128, num_layers=4, num_heads=4,
            intermediate_size=256, max_position=128, dropout_rate=0.0)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _images(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8, 8, 3).astype(np.float32),
            rng.randint(0, 10, size=n).astype(np.int32))


def _ids(n=6, t=16, seed=0):
    """Token ids with a padded tail in row 0 and a row of pads but the
    first token in row 1; SyntheticText itself has no pads."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, BERT["vocab_size"], size=(n, t)).astype(np.int32)
    ids[0, 9:] = 0
    ids[1, 1:] = 0
    return ids, rng.randint(0, 4, size=n).astype(np.int32)


def _models(kind):
    if kind == "vit":
        return (jvit.vit(10, jvit.ViTConfig(**VIT)),
                vit.vit(10, vit.ViTConfig(**VIT)), _images())
    return (jbert.bert_for_classification(4, jbert.BertConfig(**BERT)),
            bert.bert_for_classification(4, bert.BertConfig(**BERT)), _ids())


def _port_params(jmodel, model):
    p, s = jmodel.init(jax.random.PRNGKey(0))
    return _np(p), from_jax_params(_np(p), model=model, state=_np(s))


def test_vit_b16_has_torchvisions_parameter_count():
    p, s = vit.vit_b16(1000).init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(p)) == 86_567_656
    assert list(tree_leaves(s)) == []
    assert vit.VIT_CIFAR.num_patches == 64


@pytest.mark.parametrize("kind", ["vit", "bert"])
def test_logits_match_jax(kind):
    """Eval-mode logits on the same weights; BERT's batch has padded
    rows (the key mask `ids != 0`), and a padded row's logits differ
    from the unpadded row's."""
    jmodel, model, (x, _) = _models(kind)
    jp, (tp, ts) = _port_params(jmodel, model)
    want, _ = jmodel.apply(jax.tree.map(jnp.asarray, jp),
                           jmodel.init(jax.random.PRNGKey(0))[1],
                           jnp.asarray(x), JL_CTX)
    with torch.no_grad():
        got, _ = model.apply(tp, ts, torch.from_numpy(x), L.Context())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert got.shape == (x.shape[0], 10 if kind == "vit" else 4)
    if kind == "bert":
        full = x.copy()
        full[0, 9:] = 7
        with torch.no_grad():
            other, _ = model.apply(tp, ts, torch.from_numpy(full),
                                   L.Context())
        assert not torch.allclose(other[0], got[0])
        assert torch.equal(other[2:], got[2:])


def _jax_ctx():
    from distributed_model_parallel_tpu.models.layers import Context

    return Context()


JL_CTX = _jax_ctx()


@pytest.mark.parametrize("kind", ["vit", "bert"])
def test_ddp_step_matches_jax(kind):
    """Two SGD DDP steps on the same weights and batches: metric sums
    and every parameter at rtol 1e-5 of the JAX DDPEngine's. (AdamW
    divides each update by its own gradient's scale, so a bias whose
    gradient is rounding noise moves by +-lr in either package; the
    AdamW path is held by the checkpoint test and the card runs.)"""
    jmodel, model, _ = _models(kind)
    batches = [_images(8, s) if kind == "vit" else _ids(8, seed=s)
               for s in range(2)]
    jeng = JDDPEngine(jmodel, joptim.SGD(), j_mesh(
        JMeshSpec(data=1), devices=jax.devices()[:1]), donate=False)
    jts = jeng.init_state(jax.random.PRNGKey(0))
    eng = DDPEngine(model, SGD(), mesh=ONE, device="cpu")
    ts = eng.state_from_params(*from_jax_params(
        _np(jts.params), model=model, state=_np(jts.model_state)))
    for b in batches:
        jts, jm = jeng.train_step(jts, *jeng.shard_batch(*b),
                                  jnp.float32(LR))
        ts, m = eng.train_step(ts, *eng.shard_batch(*b), LR)
        np.testing.assert_allclose(float(m["loss_sum"]),
                                   float(jm["loss_sum"]), **F32)
        assert float(m["correct1"]) == float(jm["correct1"])
    _close(to_jax_params(ts.params, model=model), _np(jts.params), **F32)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bert_stages_step_equals_the_whole_model(schedule):
    """`split_stages` + `partition_pytree`: the whole model's params cut
    into two stages, one pipeline step at M 2 against the whole model's
    DataParallelEngine step; `staging.unpartition_tree` gives the whole
    tree back."""
    cfg = bert.BertConfig(**BERT)
    model = bert.bert_for_classification(4, cfg)
    whole, state = model.init(torch.Generator().manual_seed(0))
    parts = bert.partition_pytree(whole, 2, cfg)
    cuts = staging.split_points(2, None, cfg.num_layers)
    assert staging.unpartition_tree(parts, cuts).keys() == whole.keys()
    ids, labels = _ids(8)
    dp = DataParallelEngine(model, SGD(), mesh=ONE, device="cpu")
    ts, m = dp.train_step(dp.state_from_params(whole, state),
                          *dp.shard_batch(ids, labels), LR)
    stages = bert.split_stages(2, 4, cfg)
    pipe = PipelineEngine(stages, SGD(), Mesh(data=1, group=None, stage=2),
                          num_microbatches=2, schedule=schedule)
    pts = pipe.state_from_params(parts, tuple(
        st.init(torch.Generator())[1] for st in stages))
    pts, pm = pipe.train_step(pts, *pipe.shard_batch(ids, labels), LR)
    for key in ("loss_sum", "correct1", "count"):
        np.testing.assert_allclose(float(pm[key]), float(m[key]), **F32)
    got = staging.unpartition_tree(pts.params, cuts)
    for a, b in zip(tree_leaves(got), tree_leaves(ts.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **F32)


def test_bert_refuses_moe_and_vit_names_the_image_size():
    # MoE encoder layers are built since the expert-parallel slice: every
    # moe_every-th layer routes its FFN (tests/test_torch_port_moe.py
    # holds the stack against the reference), and moe_every 0 is refused
    # with the reference's message.
    moe_bert = bert.bert_for_classification(
        2, bert.BertConfig(num_layers=2, num_experts=4, hidden_size=32,
                           num_heads=4, intermediate_size=64))
    _, state = moe_bert.init(torch.Generator())
    assert state["blocks"]["0"] == {}
    assert set(state["blocks"]["1"]["moe"]) == {"moe_aux"}
    with pytest.raises(ValueError, match="moe_every must be >= 1"):
        bert.bert_for_classification(2, bert.BertConfig(num_experts=4,
                                                        moe_every=0))
    model = vit.vit(10, vit.ViTConfig(**VIT))
    p, s = model.init(torch.Generator())
    with pytest.raises(ValueError, match="configured for 8x8"):
        model.apply(p, s, torch.zeros(2, 16, 16, 3), L.Context())
    assert {"vit", "bert", "bert_tiny"} <= set(MODELS)


@pytest.mark.parametrize("seed,n,t,c,v", [(0, 64, 16, 4, 512),
                                          (3, 33, 8, 3, 97)])
def test_synthetic_text_equals_jax(seed, n, t, c, v):
    got = tds.synthetic_text(n, t, c, v, seed=seed)
    want = jds.synthetic_text(n, t, c, v, seed=seed)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == want.images.dtype
    assert (got.kind, got.num_classes) == ("text", c)
    assert got.images.min() >= 1  # 0 stays the pad id


def test_raw_loader_ships_token_ids_untouched():
    from distributed_model_parallel_tpu.data.loader import Loader as JLoader
    from distributed_model_parallel_tpu_torch.data.loader import Loader

    ds = tds.synthetic_text(50, 8, 4, 64, seed=1)
    jd = jds.synthetic_text(50, 8, 4, 64, seed=1)
    a = Loader(ds, 16, shuffle=True, raw=True, drop_last=False, seed=2)
    b = JLoader(jd, 16, shuffle=True, raw=True, drop_last=False, seed=2)
    for (x, y), (u, w) in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, w)
        assert x.dtype == np.int32
    assert (y == -1).sum() == 14 and (x[-14:] == 0).all()  # padded tail


@pytest.mark.parametrize("kind", ["vit", "bert"])
def test_checkpoint_round_trip_across_packages(kind, tmp_path):
    """A port AdamW state after one step, written in the legacy format,
    reads in the JAX package with the keys JAX writes; a JAX state
    written by JAX resumes in the port, leaf for leaf."""
    jmodel, model, _ = _models(kind)
    eng = DDPEngine(model, AdamW(), mesh=ONE, device="cpu")
    batch = _images(4) if kind == "vit" else _ids(4)
    ts, _ = eng.train_step(eng.init_state(0), *eng.shard_batch(*batch), LR)
    ckpt.save_checkpoint(str(tmp_path / "port"), train_state_to_jax(ts),
                         acc=1.0, epoch=0)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    jstate = JTrainState(params, state, joptim.AdamW().init(params),
                         jnp.zeros((), jnp.int32))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, acc=2.0, epoch=1)
    restored, _, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    want = train_state_to_jax(ts)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, restored)),
                    jax.tree.leaves(JTrainState(
                        want["params"], want["model_state"],
                        joptim.AdamWState(**want["opt_state"]),
                        want["step"]))):
        np.testing.assert_array_equal(a, b)
    fresh = eng.init_state(1)
    tree, acc, epoch = ckpt.restore_checkpoint(str(tmp_path / "jax"),
                                               train_state_spec(fresh))
    back = train_state_from_jax(tree, fresh)
    assert (acc, epoch, back.step) == (2.0, 1, 0)
    _close(to_jax_params(back.params, model=model), _np(params), rtol=0,
           atol=0)
