"""The port's sharded checkpoint format (`checkpointing/`,
`--checkpoint-format sharded --async-save`) held against the JAX
package's.

Files cross both ways, bit for bit, on a tiny BERT (hidden 32, two
layers, 4 heads; the JAX engine's initial weights, one AdamW step at lr
1e-3 before each save):

* the port's FSDP at N 2 and tensor parallelism at M 2 write files the
  reference's `load_manifest` / `restore_checkpoint` read bit-exactly
  into its own engines' templates, and the reference's FSDP (data 2)
  and TP (model 2) files restore into the port's bit-exactly;
* resharding restores are bit-exact: 2 -> 1, 2 -> 4, FSDP -> TP and
  TP -> FSDP; and one step after the 2 -> 4 restore matches the
  reference's FSDP restored at data 4 (f32 bar, rtol 1e-5 / atol 1e-6);
* no collective runs on the save path: every all-gather, broadcast and
  all-reduce of `torch.distributed` raises while the ranks save.

Then the writer, on one process (tinycnn FSDP at N 1): an async save
returns while a slowed writer still writes; back-to-back saves get
distinct ids; a crash mid-write keeps the previous checkpoint
restorable and surfaces at the next check; the snapshot is a copy (a
step taken while the writer waits does not leak into the file);
successive saves delete stale shards; 0-d leaves stay 0-d; legacy
files restore through the unified reader; the serving readers see the
sharded file; the pipeline engine is refused with the reference's
message.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port_ranks as ranks
import test_torch_port_fsdp as base
from distributed_model_parallel_tpu import checkpointing as jckpt
from distributed_model_parallel_tpu.models.bert import (
    BertConfig as JBertConfig,
)
from distributed_model_parallel_tpu.models.bert import (
    bert_for_classification as j_bert,
)
from distributed_model_parallel_tpu.parallel.fsdp import (
    FSDPEngine as JFSDPEngine,
)
from distributed_model_parallel_tpu.parallel.tensor_parallel import (
    TensorParallelEngine as JTensorParallelEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu.training.optim import AdamW as JAdamW
from distributed_model_parallel_tpu_torch import checkpointing
from distributed_model_parallel_tpu_torch.checkpointing import (
    manifest as manifest_mod,
)
from distributed_model_parallel_tpu_torch.checkpointing import (
    writer as writer_mod,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import (
    split_stages,
    tiny_cnn,
)
from distributed_model_parallel_tpu_torch.parallel.fsdp import FSDPEngine
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    MeshSpec,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.training import checkpoint as legacy
from distributed_model_parallel_tpu_torch.training.optim import SGD, AdamW
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

F32 = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=16, dropout_rate=0.0)
CLASSES, LR = 4, 1e-3


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(2):
        ids = rng.randint(1, 97, size=(16, 12)).astype(np.int32)
        ids[:, -3:] = 0
        out.append((ids, rng.randint(0, CLASSES, 16).astype(np.int32)))
    return out


def _jax_engine(kind, n):
    spec = JMeshSpec(data=1, model=n) if kind == "tp" else JMeshSpec(data=n)
    mesh = j_make_mesh(spec, devices=jax.devices()[:n])
    cls = JTensorParallelEngine if kind == "tp" else JFSDPEngine
    return cls(j_bert(CLASSES, JBertConfig(**TINY)), JAdamW(), mesh,
               donate=False)


def _jax_step(eng, ts, batch):
    ts, m = eng.train_step(ts, *eng.shard_batch(*batch), jnp.float32(LR))
    return ts, {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Files written by each package, and every restore of them."""
    root = tmp_path_factory.mktemp("sharded")
    d = {k: str(root / k) for k in ("jax_fsdp", "jax_tp", "port_fsdp",
                                     "port_tp")}
    batches = _batches()
    ref = {}
    for kind in ("fsdp", "tp"):
        eng = _jax_engine(kind, 2)
        ts = eng.init_state(jax.random.PRNGKey(0))
        if kind == "fsdp":
            start = (jax.tree.map(np.asarray, ts.params),
                     jax.tree.map(np.asarray, ts.model_state))
        ts, _ = _jax_step(eng, ts, batches[0])
        jckpt.save_sharded(d[f"jax_{kind}"], eng.to_canonical_sharded(ts),
                           acc=1.5, epoch=2)
        ref[kind] = base.jax_tree(eng.to_canonical(ts))
    # The reference's twin of the 2 -> 4 restore: its FSDP at data 4 from
    # the data-2 file, one step.
    eng4 = _jax_engine("fsdp", 4)
    state, _, _ = jckpt.restore_checkpoint(
        d["jax_fsdp"], eng4.init_state(jax.random.PRNGKey(1)))
    ts4, sums4 = _jax_step(eng4, eng4.from_canonical(state), batches[0])
    ref["fsdp4"] = (sums4, base.jax_tree(eng4.to_canonical(ts4)))
    payload = {"model": "bert", "bert": TINY, "classes": CLASSES,
               "params": start[0], "state": start[1], "batches": batches,
               "lr": LR, "opt": "adamw", "steps": 1}
    two = ranks.spawn(2, "ckpt_suite", dict(payload, ops=[
        ("save", "fsdp", d["port_fsdp"]),
        ("save", "tp", d["port_tp"]),
        ("restore", "fsdp", d["jax_fsdp"]),
        ("restore", "tp", d["jax_tp"]),
        ("restore", "tp", d["port_fsdp"]),
        ("restore", "fsdp", d["port_tp"]),
    ]), tmp_path_factory.mktemp("ranks2"))
    four = ranks.spawn(4, "ckpt_suite", dict(payload, ops=[
        ("restore", "fsdp", d["jax_fsdp"]),
        ("restore", "fsdp", d["port_fsdp"]),
    ]), tmp_path_factory.mktemp("ranks4"))
    # The reference reads the port's files into its own templates.
    read = {}
    for kind in ("fsdp", "tp"):
        state, acc, epoch = jckpt.restore_checkpoint(
            d[f"port_{kind}"],
            _jax_engine(kind, 2).init_state(jax.random.PRNGKey(1)))
        read[kind] = (base.jax_tree(state), acc, epoch)
    return d, ref, two, four, read


def test_reference_reads_the_port_files_bit_exactly(crossed):
    d, _, two, _, read = crossed
    for i, kind in enumerate(("fsdp", "tp")):
        tree, acc, epoch = read[kind]
        assert (acc, epoch) == (1.5, 2)
        base.assert_trees(tree, two[0][i]["canonical"], **EXACT)
        m = jckpt.load_manifest(d[f"port_{kind}"])
        assert m.process_count == 2
        assert m.mesh_axes == ({"data": 2, "stage": 1, "model": 1, "seq": 1,
                                "expert": 1} if kind == "fsdp" else
                               {"data": 1, "stage": 1, "model": 2, "seq": 1,
                                "expert": 1})


def test_port_reads_the_reference_files_bit_exactly(crossed):
    _, ref, two, _, _ = crossed
    for i, kind in ((2, "fsdp"), (3, "tp")):
        for rank_out in two:
            base.assert_trees(rank_out[i]["canonical"], ref[kind], **EXACT)
            assert rank_out[i]["meta"] == (1.5, 2)


def test_port_writes_one_chunk_set_per_owner(crossed):
    """FSDP: every rank writes its 1/N of each sharded leaf and rank 0
    the replicated leaves; TP: the qkv shard is three rectangles of the
    canonical (D, 3D) leaf per model rank, and the LN scales one chunk."""
    d, _, _, _, _ = crossed
    m = manifest_mod.load_manifest(d["port_fsdp"])
    assert m.shards == ["ckpt.s0.shard0.npz", "ckpt.s0.shard1.npz"]
    emb = m.leaves["params/stem/word"]
    assert [(c.file, c.start) for c in emb.chunks] == [(0, (0, 0)),
                                                       (1, (0, 16))]
    assert emb.spec == [None, "data"]
    ln = m.leaves["params/stem/ln/scale"]
    assert [c.file for c in ln.chunks] == [0] and ln.spec == []
    assert m.leaves["opt_state/count"].shape == ()
    qkv = manifest_mod.load_manifest(d["port_tp"]).leaves[
        "params/blocks/0/attn/qkv/w"]
    assert [(c.file, c.start, c.shape) for c in qkv.chunks] == [
        (0, (0, 0), (32, 16)), (1, (0, 16), (32, 16)),
        (0, (0, 32), (32, 16)), (1, (0, 48), (32, 16)),
        (0, (0, 64), (32, 16)), (1, (0, 80), (32, 16))]


@pytest.mark.parametrize("move", ["2to1", "2to4", "fsdp_to_tp",
                                  "tp_to_fsdp"])
def test_reshard_restores_are_bit_exact(crossed, move):
    d, _, two, four, _ = crossed
    saved = {"fsdp": two[0][0]["canonical"], "tp": two[0][1]["canonical"]}
    if move == "2to1":
        eng = FSDPEngine(ranks.fsdp_model({"model": "bert", "bert": TINY,
                                           "classes": CLASSES}),
                         AdamW(), device="cpu")
        like = eng.init_state(1)
        tree, _, _ = checkpointing.restore_checkpoint(
            d["port_fsdp"], eng.canonical_spec(like))
        got = [eng.to_canonical(eng.from_canonical(tree, like))]
        want = saved["fsdp"]
    elif move == "2to4":
        got, want = [r[1]["canonical"] for r in four], saved["fsdp"]
    elif move == "fsdp_to_tp":
        got, want = [r[4]["canonical"] for r in two], saved["fsdp"]
    else:
        got, want = [r[5]["canonical"] for r in two], saved["tp"]
    for tree in got:
        base.assert_trees(tree, want, **EXACT)


def test_the_step_after_a_reshard_matches_the_reference_twin(crossed):
    _, ref, _, four, _ = crossed
    sums, tree = ref["fsdp4"]
    for rank_out in four:
        got = rank_out[0]
        np.testing.assert_allclose(got["sums"][0]["loss_sum"],
                                   sums["loss_sum"], **F32)
        assert got["sums"][0]["count"] == sums["count"]
        base.assert_trees(got["after"], tree, **F32)


# ------------------------------------------------------------- the writer

def _engine(opt=None):
    eng = FSDPEngine(tiny_cnn(10), opt or AdamW(), device="cpu",
                     min_shard_elems=64)
    return eng, eng.init_state(0)


def _batch():
    rng = np.random.RandomState(3)
    return (rng.rand(8, 8, 8, 3).astype(np.float32),
            rng.randint(0, 10, 8).astype(np.int32))


def _restored(eng, directory, name="ckpt"):
    tree, _, _ = checkpointing.restore_checkpoint(
        directory, eng.canonical_spec(eng.init_state(1)), name=name)
    return tree


@pytest.fixture
def slow_writer(monkeypatch):
    """`_write_shard` held until the test releases it."""
    gate = threading.Event()
    real = writer_mod._write_shard

    def slow(path, arrays):
        assert gate.wait(30)
        real(path, arrays)

    monkeypatch.setattr(writer_mod, "_write_shard", slow)
    return gate


def test_async_save_returns_before_the_write_lands(tmp_path, slow_writer):
    eng, ts = _engine()
    w = checkpointing.AsyncCheckpointer()
    t0 = time.perf_counter()
    handle = checkpointing.save_sharded(
        str(tmp_path), eng.to_canonical_sharded(ts), acc=0.0, epoch=0,
        writer=w)
    assert time.perf_counter() - t0 < 5.0
    assert not handle.done() and w.pending() == 1
    assert not checkpointing.manifest_exists(str(tmp_path))
    slow_writer.set()
    w.wait()
    assert checkpointing.manifest_exists(str(tmp_path))


def test_back_to_back_saves_get_distinct_ids(tmp_path, slow_writer):
    eng, ts = _engine()
    w = checkpointing.AsyncCheckpointer()
    for epoch in (0, 1):
        checkpointing.save_sharded(str(tmp_path),
                                   eng.to_canonical_sharded(ts), acc=0.0,
                                   epoch=epoch, writer=w)
    slow_writer.set()
    w.wait()
    m = checkpointing.load_manifest(str(tmp_path))
    assert (m.save_id, m.epoch) == (1, 1)
    # The first save's shards were collected once the second committed.
    assert [f for f, _, _ in manifest_mod.list_shard_files(
        str(tmp_path), "ckpt")] == ["ckpt.s1.shard0.npz"]


def test_a_crash_mid_write_keeps_the_previous_checkpoint(tmp_path,
                                                         monkeypatch):
    eng, ts = _engine()
    checkpointing.save_sharded(str(tmp_path), eng.to_canonical_sharded(ts),
                               acc=0.0, epoch=0)
    before = _restored(eng, str(tmp_path))

    def crash(path, arrays):
        with open(path + ".tmp", "wb") as f:
            f.write(b"half a shard")
        raise OSError("disk full")

    monkeypatch.setattr(writer_mod, "_write_shard", crash)
    ts, _ = eng.train_step(ts, *eng.shard_batch(*_batch()), 1e-3)
    w = checkpointing.AsyncCheckpointer()
    handle = checkpointing.save_sharded(
        str(tmp_path), eng.to_canonical_sharded(ts), acc=0.0, epoch=1,
        writer=w)
    with pytest.raises(OSError, match="disk full"):
        handle.wait()
    # The failure surfaces at the next save's check, once.
    with pytest.raises(OSError, match="disk full"):
        w.check()
    w.check()
    assert checkpointing.load_manifest(str(tmp_path)).epoch == 0
    base.assert_trees(_restored(eng, str(tmp_path)), before, **EXACT)


def test_the_async_snapshot_is_a_copy(tmp_path, slow_writer):
    """The engines update their state in place: a step taken while the
    writer waits must not reach the file (on the CPU `.cpu()` would
    return the live tensor)."""
    eng, ts = _engine()
    ts, _ = eng.train_step(ts, *eng.shard_batch(*_batch()), 1e-3)
    want = eng.to_canonical(ts)
    w = checkpointing.AsyncCheckpointer()
    checkpointing.save_sharded(str(tmp_path), eng.to_canonical_sharded(ts),
                               acc=0.0, epoch=0, writer=w)
    ts, _ = eng.train_step(ts, *eng.shard_batch(*_batch()), 1e-3)
    slow_writer.set()
    w.wait()
    got = _restored(eng, str(tmp_path))
    base.assert_trees(got, want, **EXACT)
    assert not np.array_equal(
        legacy.flatten_tree(got["params"])["head/1/w"],
        legacy.flatten_tree(eng.to_canonical(ts)["params"])["head/1/w"])


def test_successive_saves_collect_stale_shards_and_keep_0d_leaves(tmp_path):
    eng, ts = _engine()
    for epoch in range(3):
        checkpointing.save_sharded(str(tmp_path),
                                   eng.to_canonical_sharded(ts),
                                   acc=float(epoch), epoch=epoch)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt.manifest.json", "ckpt.s2.shard0.npz"]
    raw = json.loads((tmp_path / "ckpt.manifest.json").read_text())
    assert raw["leaves"]["opt_state/count"]["shape"] == []
    assert raw["leaves"]["step"]["shape"] == []
    tree = _restored(eng, str(tmp_path))
    assert tree["opt_state"]["count"].shape == () and tree["step"].shape == ()


def test_legacy_files_restore_through_the_unified_reader(tmp_path):
    eng, ts = _engine(SGD())
    legacy.save_checkpoint(str(tmp_path), eng.to_canonical(ts), acc=2.5,
                           epoch=4)
    spec = eng.canonical_spec(ts)
    got = checkpointing.restore_checkpoint(str(tmp_path), spec)
    want = legacy.restore_checkpoint(str(tmp_path), spec)
    base.assert_trees(got[0], want[0], **EXACT)
    assert got[1:] == want[1:] == (2.5, 4)
    assert checkpointing.checkpoint_metadata(str(tmp_path))["format"] == \
        "legacy"
    assert checkpointing.saved_topology(str(tmp_path)) is None


def test_the_serving_readers_see_the_sharded_file(tmp_path):
    eng, ts = _engine()
    checkpointing.save_sharded(str(tmp_path), eng.to_canonical_sharded(ts),
                               acc=3.0, epoch=5, extra={"k": 1})
    meta = checkpointing.checkpoint_metadata(str(tmp_path))
    assert (meta["format"], meta["epoch"], meta["k"]) == ("sharded", 5, 1)
    params, meta = checkpointing.restore_subtree(
        str(tmp_path), eng.canonical_spec(ts)["params"])
    base.assert_trees(params, eng.to_canonical(ts)["params"], **EXACT)
    assert checkpointing.saved_topology(str(tmp_path)) == {
        "mesh_axes": {"data": 1, "stage": 1, "model": 1, "seq": 1,
                      "expert": 1},
        "process_count": 1, "epoch": 5, "format": "sharded"}
    assert legacy.newest_checkpoint_name(str(tmp_path)) == "ckpt"
    assert legacy.checkpoint_epoch(str(tmp_path)) == 5


def test_the_pipeline_engine_is_refused_with_the_reference_message(
        tmp_path):
    eng = PipelineEngine(split_stages(2, 10), SGD(),
                         make_mesh(MeshSpec(stage=2)), num_microbatches=1)
    x, y = _batch()
    cfg = TrainerConfig(epochs=1, print_freq=0, log_dir=str(tmp_path),
                        checkpoint_dir=str(tmp_path), save_last=True,
                        checkpoint_format="sharded")
    trainer = Trainer(eng, [(x, y)], None, cfg)
    with pytest.raises(ValueError, match=(
            r"PipelineEngine defines a RESTRUCTURING canonical form "
            r"\(to_canonical\) without a to_canonical_sharded seam")):
        trainer.fit()
