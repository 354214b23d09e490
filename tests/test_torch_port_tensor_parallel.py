"""The port's tensor parallelism (`parallel/tensor_parallel.py`, `--engine
tp --model-shards M`) held against the JAX package's
`TensorParallelEngine` on the 8-virtual-device CPU mesh.

The port's ranks are gloo processes (`tests/_torch_port_ranks.py`): a
world of 2 for the (data 1, model 2) mesh, a world of 4 for (2, 2) and
(1, 4). The model is the JAX test's TINY BERT (`tests/
test_tensor_parallel.py`: hidden 32, one layer, 4 heads, FFN 64), from
the JAX engine's initial weights, 3 steps on 3 seeded batches of 16
sequences of 12 tokens (3 pad positions each), SGD at lr 0.05 and AdamW
at lr 1e-3.

Bars: rtol 1e-5 / atol 1e-6, the port's f32 bar (the row-parallel sums
add the model ranks' partial products in another order than the JAX
partitioner's, which this bar covers); counts are integers and equal.

* TP against JAX TP: per-step metric sums, and the gathered canonical
  parameters and optimizer state, on (1, 2), (2, 2) and (1, 4) with SGD
  and AdamW.
* The shard layout: each rank's QKV shard is the head-aligned slice of
  the full array ([q | k | v] columns of its heads), of the JAX shard
  shape (D, 3D/M); its momentum mirrors it. The replicated leaves are
  bit-equal across the model ranks after 3 steps.
* Dropout 0.1: TP at (2, 2) against `DDPEngine` at data 2 (the keys fold
  the data index, so the two draw the same masks; the reference's
  jax.random bits cannot be matched).
* Checkpoints: a TP run at M 2 saved after 2 steps resumes under the
  port's DDP engine and under JAX's TP engine, and checkpoints of those
  two resume under the port's TP; each resumed third step equals the
  straight run's.
* The CLI: `cli.data_parallel --engine tp --model-shards 2 --model
  bert_tiny` on 2 gloo ranks against `--engine gspmd` on one, its
  `--resume` bit-equal to the straight run, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.models.bert import (
    BertConfig as JBertConfig,
)
from distributed_model_parallel_tpu.models.bert import (
    bert_for_classification as j_bert,
)
from distributed_model_parallel_tpu.parallel.tensor_parallel import (
    TensorParallelEngine as JTensorParallelEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu.training import checkpoint as jckpt
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu.training.optim import AdamW as JAdamW
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.data import datasets as tdatasets
from distributed_model_parallel_tpu_torch.models.bert import (
    BertConfig,
    bert_for_classification,
)
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    train_state_from_jax,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
    MEGATRON_RULES,
    Split,
    shard_leaf,
    shard_specs,
    unshard_leaf,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh, MeshSpec
from distributed_model_parallel_tpu_torch.training import checkpoint as ckpt
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

F32 = dict(rtol=1e-5, atol=1e-6)
# ViT at CIFAR's 65 tokens (64 patches and the class token), cut narrow.
VIT_PROBE = dict(image_size=32, patch_size=4, dim=16, num_layers=1,
                 num_heads=2, mlp_dim=32)
TINY = dict(vocab_size=97, hidden_size=32, num_layers=1, num_heads=4,
            intermediate_size=64, max_position=16, dropout_rate=0.0)
BATCH, SEQ, CLASSES, STEPS = 16, 12, 4, 3
LR = {"sgd": 0.05, "adamw": 1e-3}
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
CASES = [(d, m, opt) for w in MESHES for d, m in MESHES[w]
         for opt in ("sgd", "adamw")]


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(1, 97, size=(BATCH, SEQ)).astype(np.int32)
        ids[:, -3:] = 0  # pad tail: the attention mask
        out.append((ids, rng.randint(0, CLASSES, BATCH).astype(np.int32)))
    return out


def _optim(name, jax_side=False):
    if jax_side:
        return JAdamW() if name == "adamw" else JSGD()
    return ranks._tp_optimizer(name)


def _tree(jts):
    """A JAX host TrainState as the canonical dict tree."""
    return jax.tree.map(np.asarray, {
        "params": jts.params, "model_state": jts.model_state,
        "opt_state": jts.opt_state._asdict(), "step": jts.step})


def _jax_engine(d, m, opt, **kw):
    mesh = j_make_mesh(JMeshSpec(data=d, model=m),
                       devices=jax.devices()[:d * m])
    return JTensorParallelEngine(j_bert(CLASSES, JBertConfig(**TINY)),
                                 _optim(opt, True), mesh, donate=False, **kw)


def _jax_run(eng, opt, ts, batches):
    """(per-step metric sums, the canonical tree after each step)."""
    sums, trees = [], []
    for ids, labels in batches:
        ts, m = eng.train_step(ts, *eng.shard_batch(ids, labels),
                               jnp.float32(LR[opt]))
        sums.append({k: float(v) for k, v in m.items()})
        trees.append(_tree(eng.to_canonical(ts)))
    return sums, trees


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's start, per-step sums and canonical trees for every
    case, its qkv shard shape at each M, and the (1, 2) SGD engine."""
    batches = _batches()
    out = {"batches": batches}
    for d, m, opt in CASES:
        eng = _jax_engine(d, m, opt)
        ts = eng.init_state(jax.random.PRNGKey(0))
        if "params" not in out:
            out["params"] = _tree(eng.to_canonical(ts))["params"]
            out["engine"] = eng
        qkv = ts.params["blocks"]["0"]["attn"]["qkv"]["w"]
        out["shard_shape", m] = qkv.addressable_shards[0].data.shape
        out[d, m, opt] = _jax_run(eng, opt, ts, batches)
    eng = _jax_engine(1, 2, "sgd", collective_matmul=True)
    out["cm"] = _jax_run(eng, "sgd", eng.init_state(jax.random.PRNGKey(0)),
                         batches)
    return out


def _port_ddp(opt):
    """The port's DDPEngine on one process (no group), the TINY BERT."""
    model = bert_for_classification(CLASSES, BertConfig(**TINY))
    return DDPEngine(model, _optim(opt), mesh=Mesh(1, None), device="cpu")


def _port_steps(eng, ts, batches, lr):
    for ids, labels in batches:
        ts, _ = eng.train_step(ts, *eng.shard_batch(ids, labels), lr)
    return ts


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """The gloo ranks' results: world 2 and world 4 (module docstring)."""
    tmp = tmp_path_factory.mktemp("tp")
    batches = reference["batches"]
    # Checkpoints of the reference engine and of the port's DDP after 2
    # steps, for the TP resume runs.
    jax_saved = reference[1, 2, "sgd"][1][1]
    ddp = _port_ddp("sgd")
    dts = ddp.state_from_params(from_jax_params(reference["params"],
                                                model=ddp.model),
                                ddp.model.init(torch.Generator())[1])
    dts = _port_steps(ddp, dts, batches[:2], LR["sgd"])
    common = dict(bert=TINY, classes=CLASSES, params=reference["params"],
                  batches=batches, dir=str(tmp))
    out = {}  # run name -> the ranks' results
    for world, meshes in MESHES.items():
        runs = [dict(name=(d, m, opt), model=m, opt=opt, steps=STEPS,
                     lr=LR[opt]) for d, m in meshes
                for opt in ("sgd", "adamw")]
        if world == 2:
            runs[0]["save_after"] = 2
            runs += [dict(name="from_jax", model=2, opt="sgd", steps=1,
                          first=2, lr=LR["sgd"],
                          resume=jax_saved),
                     dict(name="from_ddp", model=2, opt="sgd", steps=1,
                          first=2, lr=LR["sgd"],
                          resume=train_state_to_jax(dts))]
            cm = dict(model=2, opt="sgd", steps=STEPS, lr=LR["sgd"])
            runs += [dict(cm, name=("cm", 0.0), cm=True),
                     dict(cm, name=("cm", 0.1), cm=True, dropout=0.1),
                     dict(cm, name=("tp", 0.1, 2), dropout=0.1)]
        else:
            runs += [dict(name=(name, 0.1), model=2, opt="sgd", steps=STEPS,
                          lr=LR["sgd"], dropout=0.1, ddp=name == "ddp")
                     for name in ("tp", "ddp")]
        (tmp / f"w{world}").mkdir()
        extra = {"vit_probe": VIT_PROBE} if world == 2 else {}
        got = ranks.spawn(world, "tp_suite", dict(common, runs=runs,
                                                  **extra),
                          tmp / f"w{world}")
        out.update({run["name"]: [r[run["name"]] for r in got]
                    for run in runs})
        if extra:
            out["vit_refusal"] = [r["vit_refusal"] for r in got]
    return out


def close_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **F32)


def close_sums(got, want):
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], **F32)
    for k in ("correct1", "correct5", "count"):
        assert got[k] == want[k], (k, got, want)


@pytest.mark.parametrize("d,m,opt", CASES,
                         ids=[f"d{d}m{m}-{o}" for d, m, o in CASES])
def test_tp_matches_jax_tp(d, m, opt, reference, port):
    """Per-step metric sums and the gathered canonical state (params,
    momentum or AdamW moments and count, step) against the JAX engine on
    the same (data, model) mesh."""
    want_sums, want_trees = reference[d, m, opt]
    got = port[d, m, opt]
    assert sorted(r["index"] for r in got) == [
        (i, j) for i in range(d) for j in range(m)]
    for r in got:
        assert r["backend"] == "gloo"
        for g, w in zip(r["sums"], want_sums):
            close_sums(g, w)
        close_tree(r["canonical"], want_trees[-1])


def _head_aligned(full, m, shards):
    """Model rank m's [q | k | v] columns of its heads, from the full
    (D, 3D) array, in numpy."""
    d = full.shape[1] // 3
    w = d // shards
    return np.concatenate([full[:, p * d + m * w:p * d + (m + 1) * w]
                           for p in range(3)], axis=1)


@pytest.mark.parametrize("d,m", [(1, 2), (2, 2), (1, 4)])
def test_qkv_shard_is_the_head_aligned_slice(d, m, reference, port):
    """Each rank's QKV shard (and its momentum) is the head-aligned slice
    of the gathered array, of the JAX engine's shard shape (D, 3D/M)."""
    got = port[d, m, "sgd"]
    want_shape = reference["shard_shape", m]
    assert want_shape == (32, 96 // m)
    for r in got:
        canon = r["canonical"]
        full = canon["params"]["blocks"]["0"]["attn"]["qkv"]["w"]
        mom = canon["opt_state"]["momentum"]["blocks"]["0"]["attn"]["qkv"][
            "w"]
        j = r["index"][1]
        assert r["qkv"].shape == want_shape
        np.testing.assert_array_equal(r["qkv"], _head_aligned(full, j, m))
        np.testing.assert_array_equal(r["qkv_moment"],
                                      _head_aligned(mom, j, m))


@pytest.mark.parametrize("d,m", [(1, 2), (2, 2), (1, 4)])
def test_replicated_leaves_bit_equal_across_model_ranks(d, m, port):
    """After 3 steps the replicated leaves (embeddings, LayerNorms, the
    pooler and classifier, the row projections' biases) are bit-equal on
    the ranks of a model group: f and g leave their gradients identical,
    so no model all-reduce of them is needed."""
    got = port[d, m, "adamw"]
    for di in range(d):
        group = [r["replicated"] for r in got if r["index"][0] == di]
        assert len(group) == m and len(group[0]) > 10
        for other in group[1:]:
            for k, v in group[0].items():
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_shard_layout_round_trips():
    """shard_leaf / unshard_leaf: every rule's leaf splits and rejoins
    exactly; the fused qkv keeps each third's columns together."""
    model = bert_for_classification(CLASSES, BertConfig(**TINY))
    params, _ = model.init(torch.Generator().manual_seed(0))
    specs = shard_specs(params, MEGATRON_RULES)
    blk = specs["blocks"]["0"]
    assert blk["attn"]["qkv"]["w"] == Split(1, 3)
    assert blk["attn"]["out"]["w"] == Split(0) and blk["attn"]["out"]["b"] \
        is None
    assert blk["ffn"]["in"]["b"] == Split(0)
    assert specs["stem"]["word"] is None and blk["ln1"]["scale"] is None
    qkv = params["blocks"]["0"]["attn"]["qkv"]["w"]
    for shards in (1, 2, 4):
        pieces = [shard_leaf(qkv, Split(1, 3), m, shards)
                  for m in range(shards)]
        assert pieces[0].shape == (32, 96 // shards)
        assert torch.equal(unshard_leaf(pieces, Split(1, 3)), qkv)
        np.testing.assert_array_equal(pieces[-1].numpy(), _head_aligned(
            qkv.numpy(), shards - 1, shards))


def test_dropout_tp_matches_ddp(port):
    """Dropout 0.1: TP at (data 2, model 2) against the port's DDPEngine
    at data 2 over the same data groups: per-step sums and the final
    state (the masks fold the step and the data index)."""
    tp, ddp = port["tp", 0.1], port["ddp", 0.1]
    for a, b in zip(tp, ddp):
        for g, w in zip(a["sums"], b["sums"]):
            close_sums(g, w)
        close_tree(a["canonical"], b["canonical"])
    # Dropout did act: the run differs from the dropout-0 run.
    assert tp[0]["sums"][1]["loss_sum"] != port[2, 2, "sgd"][0]["sums"][1][
        "loss_sum"]


def test_collective_matmul_matches_jax_cm_and_plain_tp(reference, port):
    """`collective_matmul=True` at (data 1, model 2), Megatron-SP with
    the rings: per-step sums and the gathered state against the JAX
    engine with the same flag, and against the port's TP without it
    (same math, the sums in another order: the f32 bar)."""
    want_sums, want_trees = reference["cm"]
    for r, plain in zip(port["cm", 0.0], port[1, 2, "sgd"]):
        assert r["backend"] == "gloo"
        for g, w, p in zip(r["sums"], want_sums, plain["sums"]):
            close_sums(g, w)
            close_sums(g, p)
        close_tree(r["canonical"], want_trees[-1])
        close_tree(r["canonical"], plain["canonical"])


def test_collective_matmul_dropout_matches_plain_tp(port):
    """Dropout 0.1 at (1, 2): the sequence-sharded blocks draw each
    element's bit from its index in the whole sequence, so the rings'
    run draws the masks of the run without them and stays within the f32
    bar of it; the replicated leaves stay bit-equal across the model
    ranks (their gradients summed over the model group)."""
    cm, plain = port["cm", 0.1], port["tp", 0.1, 2]
    for a, b in zip(cm, plain):
        for g, w in zip(a["sums"], b["sums"]):
            close_sums(g, w)
        close_tree(a["canonical"], b["canonical"])
    assert cm[0]["sums"][1]["loss_sum"] != port["cm", 0.0][0]["sums"][1][
        "loss_sum"]
    for k, v in cm[0]["replicated"].items():
        np.testing.assert_array_equal(cm[1]["replicated"][k], v, err_msg=k)


def test_collective_matmul_refuses_vits_65_tokens_as_jax(port):
    """ViT's 65 tokens do not split over 2 model ranks: the reference's
    message, at the first step, on every rank."""
    from distributed_model_parallel_tpu.ops.collective_matmul import (
        _check_div,
    )

    with pytest.raises(ValueError) as want:
        _check_div("column", 65, 2, "sequence length")
    assert port["vit_refusal"] == [str(want.value)] * 2


def _resume_third_step(tree, engine_kind, reference, tmp_path):
    """Save `tree` (the canonical state after 2 steps) as a checkpoint,
    restore it under the port's DDP engine or JAX's TP engine at (1, 2),
    run the third batch and return the canonical state."""
    batches = reference["batches"]
    ckpt.save_checkpoint(str(tmp_path), tree, acc=1.0, epoch=0)
    if engine_kind == "ddp":
        eng = _port_ddp("sgd")
        like = eng.init_state(1)
        restored, _, _ = ckpt.restore_checkpoint(
            str(tmp_path), jax.tree.map(np.asarray, train_state_to_jax(like)))
        ts = _port_steps(eng, train_state_from_jax(restored, like),
                         batches[2:], LR["sgd"])
        return train_state_to_jax(ts)
    jeng = reference["engine"]
    like = jeng.to_canonical(jeng.init_state(jax.random.PRNGKey(3)))
    restored, _, _ = jckpt.restore_checkpoint(str(tmp_path), like)
    _, trees = _jax_run(jeng, "sgd", jeng.from_canonical(restored),
                        batches[2:])
    return trees[-1]


@pytest.mark.parametrize("engine_kind", ["ddp", "jax_tp"])
def test_tp_checkpoint_resumes_elsewhere(engine_kind, reference, port,
                                         tmp_path):
    """A TP (1, 2) checkpoint after 2 steps, in the reference layout,
    resumes under the port's DDP and under JAX's TP; the third step
    equals the straight TP run's."""
    r0 = port[1, 2, "sgd"][0]
    saved = r0["saved"]
    assert int(saved["step"]) == 2
    got = _resume_third_step(saved, engine_kind, reference, tmp_path)
    close_tree(got, r0["canonical"])


@pytest.mark.parametrize("source", ["from_jax", "from_ddp"])
def test_checkpoints_resume_under_tp(source, port):
    """Checkpoints of JAX's TP engine and of the port's DDP engine after 2
    steps resume under the port's TP at M 2 (rank 0 writes the file,
    both ranks restore it and re-slice); the third step equals the
    straight TP run's."""
    for r, straight in zip(port[source], port[1, 2, "sgd"]):
        close_tree(r["canonical"], straight["canonical"])


# ------------------------------------------------------------------ CLI

CLI = ["--device", "cpu", "--model", "bert_tiny", "-type", "SyntheticText",
       "-b", "16", "--val-batch-size", "64", "--steps-per-epoch", "2",
       "--optimizer", "adamw", "--lr", "1e-2"]
VAL = 64  # val rows (the CLI runs cut the split)


def test_cli_tp_on_two_ranks(tmp_path, monkeypatch):
    """`--engine tp --model-shards 2` on 2 gloo ranks, one epoch and then
    `--resume` to two: each epoch record equals `--engine gspmd`'s two
    straight epochs on one rank (the same batches, one data rank each)
    within the f32 bar, the losses are finite, and rank 0 alone writes.
    (bert_tiny's loss leaves chance only after ~16 steps of batch 512,
    beyond this test's size: the records are held to the gspmd run's.)"""
    tp = CLI + ["--engine", "tp", "--model-shards", "2"]
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    got = ranks.spawn(2, "cli_suite", dict(
        runs=[("data_parallel", tp + ["--epochs", "1"], 0),
              ("data_parallel", tp + ["--epochs", "2", "--resume"], 0)],
        dirs=[[str(d) for d in dirs]], val=VAL), tmp_path)
    (tmp_path / "gspmd").mkdir()
    monkeypatch.chdir(tmp_path / "gspmd")
    monkeypatch.setattr(tdatasets.DatasetCollection, "init", ranks.val_cut(
        tdatasets.DatasetCollection.init, VAL))
    want = dp_cli.main(CLI + ["--epochs", "2"])["history"]
    for rank in got:
        (first,), (resumed,) = rank
        for g, w in ((first, want[0]), (resumed, want[1])):
            for split in ("train", "val"):
                assert g[split]["count"] == w[split]["count"]
                assert np.isfinite(g[split]["loss"])
                np.testing.assert_allclose(g[split]["loss"],
                                           w[split]["loss"], rtol=1e-5)
    assert (dirs[0] / "checkpoint" / "ckpt.npz").is_file()
    assert (dirs[0] / "log").is_dir()
    assert not (dirs[1] / "checkpoint").exists()
    assert not (dirs[1] / "log").exists()


@pytest.mark.parametrize("flags,match", [
    (["--engine", "tp", "--model", "tinycnn"],
     "--model tinycnn has none"),
    (["--model-shards", "2"], "only applies under --engine tp"),
    (["--engine", "tp", "--model", "vit", "--model-shards", "4"],
     "must divide the model's 6 attention heads"),
    (["--engine", "tp", "--model", "bert_tiny", "--model-shards", "3"],
     "must divide the model's 4 attention heads"),
    (["--engine", "tp", "--model", "vit", "--dcn-slices", "2"],
     "not tp"),
    (["--engine", "tp", "--model", "vit", "--model-shards", "0"],
     "must be >= 1"),
    (["--engine", "tp", "--model", "vit", "--model-shards", "2"],
     r"model=2\) must divide the world \(1 ranks\)"),
    (["--engine", "tp", "--model", "bert_tiny", "--collective-matmul"],
     "a size-1 ring is a plain dot"),
    (["--engine", "ddp", "--collective-matmul"],
     "it only applies under --engine tp"),
])
def test_cli_tp_refusals(flags, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        dp_cli.main(["--device", "cpu", "-b", "64", *flags])


def test_mesh_model_axis_resolves():
    assert MeshSpec(data=-1, model=2).resolve(4) == 2
    assert MeshSpec(data=2, model=2).resolve(4) == 2
    with pytest.raises(ValueError, match="does not combine with model"):
        MeshSpec(model=2, dcn=2).resolve(8)
    with pytest.raises(ValueError, match="needs 6 ranks"):
        MeshSpec(data=3, model=2).resolve(4)


def test_partition_specs_and_capture_refusal():
    """`state_partition_specs` gives each parameter and moment its Split
    (AdamW's count and the step replicate); a step on the card whose
    groups run on gloo cannot be captured in a CUDA graph and is refused
    by name (`training/multistep.check_capturable`)."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel \
        import TensorParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.dist import (
        initialize_backend,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import make_mesh
    from distributed_model_parallel_tpu_torch.training.multistep import (
        check_capturable,
    )
    from distributed_model_parallel_tpu_torch.training.optim import AdamW

    model = bert_for_classification(CLASSES, BertConfig(**TINY))
    eng = TensorParallelEngine(model, AdamW(), Mesh(1, None), device="cpu")
    specs = eng.state_partition_specs(eng.init_state(0))
    qkv = specs.params["blocks"]["0"]["attn"]["qkv"]["w"]
    assert qkv == Split(1, 3) == specs.opt_state.mu["blocks"]["0"]["attn"][
        "qkv"]["w"]
    assert specs.opt_state.count is None and specs.step is None
    initialize_backend("cpu")
    assert dist.get_backend() == "gloo"
    on_card = TensorParallelEngine(model, AdamW(), make_mesh(),
                                   device="cuda")
    with pytest.raises(ValueError, match="group runs on gloo"):
        check_capturable(on_card)
    check_capturable(TensorParallelEngine(model, AdamW(), make_mesh(),
                                          device="cpu"))
