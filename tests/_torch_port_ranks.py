"""Rank processes for the port's multi-process tests
(`tests/test_torch_port_ddp.py`, `tests/test_torch_port_pipeline.py`,
`tests/test_torch_port_tensor_parallel.py` and others).

This module imports neither jax nor the JAX package: a spawned rank
imports the module of its target, and so starts with torch and the port
only. `spawn` starts `world` CPU ranks on gloo (one thread each, as the
suite runs several workers at once), runs one of the functions below in
every rank and returns their results, rank by rank. The world's joins
share one deadline, and the process group has a timeout, so a lost rank
fails the test instead of hanging the suite.

Every port test file also imports `torch_port_worker`, which leaves its
pytest worker as it found it:

* one torch thread while the file's tests run. The suite runs several
  pytest workers at once (`-n 6` on a host of 8 cores); torch's default
  of one intra-op thread a core then puts six thread pools on the same
  cores, and the small tensors of these tests spend their time waiting
  for each other's threads (a 2-epoch CLI run read 364 s so, and 10 s
  on one thread). The rank processes run one thread each already;
* no process group left behind. An in-process CLI run joins a world of
  one gloo rank (`runtime/dist.initialize_backend`) and keeps it; the
  file's last test closes it, so that no later file in the worker finds
  a world it did not make and no worker ends with a gloo store open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path
from unittest import mock

import pytest

TIMEOUT_S = 120


_DEFAULT = {}


@pytest.fixture(autouse=True, scope="module")
def torch_port_worker():
    import torch
    import torch.distributed as dist

    threads = _DEFAULT.setdefault("threads", torch.get_num_threads())
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture
def default_torch_threads():
    """torch's own thread count for one test whose f32 bar was set at it:
    a conv's weight gradient sums in another order on one thread, and a
    bar of 1e-5 may see that order."""
    import torch

    torch.set_num_threads(_DEFAULT.get("threads", torch.get_num_threads()))
    try:
        yield
    finally:
        torch.set_num_threads(1)


def spawn(world: int, fn: str, payload, tmp_path: Path) -> list:
    from distributed_model_parallel_tpu_torch.runtime.dist import free_port

    ctx = multiprocessing.get_context("spawn")
    url = f"tcp://127.0.0.1:{free_port()}"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, url, fn, payload, str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    # One deadline for the whole world: joined one after the other with
    # TIMEOUT_S each, a stuck world of 8 would hold the worker 8 times
    # as long before it is killed.
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {TIMEOUT_S} s"
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert o.exists(), f"rank {r} exited with {p.exitcode}, no result"
    results = [pickle.loads(o.read_bytes()) for o in outs]
    for r, (ok, value) in enumerate(results):
        assert ok, f"rank {r} failed:\n{value}"
    assert [p.exitcode for p in procs] == [0] * world
    return [value for _, value in results]


def _rank_main(rank, world, url, fn, payload, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
        from distributed_model_parallel_tpu_torch.runtime.dist import (
            initialize_backend,
        )

        initialize_backend("cpu", url)
        try:
            result = (True, globals()[fn](rank, world, payload))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        result = (False, traceback.format_exc())
    Path(out).write_bytes(pickle.dumps(result))


def ddp_steps(rank, world, payload) -> dict:
    """The port's engines on tinycnn from the given reference weights:
    for each name in `payload["engines"]` ("ddp": per-replica BN,
    "ddp_sync": SyncBN, "gspmd": DataParallelEngine), one SGD step per
    global batch, this rank taking rows [rB/S, (r+1)B/S). Returns, per
    engine, the per-step metric sums and the final params and BN state in
    the reference layout."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
        to_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    model = tiny_cnn(10)
    out = {}
    for name in payload["engines"]:
        if name == "gspmd":
            eng = DataParallelEngine(model, SGD(), device="cpu")
        else:
            eng = DDPEngine(model, SGD(), sync_bn=name == "ddp_sync",
                            device="cpu")
        ts = eng.state_from_params(*from_jax_params(
            payload["params"], model=model, state=payload["state"]))
        sums = []
        for images, labels in payload["batches"]:
            b = len(labels) // world
            rows = slice(rank * b, (rank + 1) * b)
            ts, m = eng.train_step(ts, *eng.shard_batch(images[rows],
                                                        labels[rows]),
                                   payload["lr"])
            sums.append({k: float(v) for k, v in m.items()})
        params, state = to_jax_params(ts.params, model=model,
                                      state=ts.model_state)
        out[name] = {"sums": sums, "params": params, "state": state,
                     "grad_reductions": eng.grad_reductions,
                     "backend": dist.get_backend(eng.mesh.group)}
    return out


def cli_main(rank, world, payload) -> dict:
    """`cli/data_parallel.main` in this rank, from its own directory
    (the log goes under the working directory)."""
    from distributed_model_parallel_tpu_torch.cli import data_parallel

    os.chdir(payload["dirs"][rank])
    out = data_parallel.main(payload["argv"])
    return {"history": out["history"]}


def pipeline_steps(rank, world, payload) -> dict:
    """The port's PipelineEngine on tinycnn at stage 2 over `world` data
    ranks, from the given per-chunk reference weights: one SGD step on
    this rank's rows [rB/S, (r+1)B/S) of the global batch. Returns the
    metric sums and the per-chunk params and BN state in the reference
    layout."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
        to_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.tinycnn import (
        split_stages,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        PipelineEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    stages = split_stages(2, 10)
    mesh = make_mesh(MeshSpec(data=world, stage=2), devices=["cpu"])
    eng = PipelineEngine(stages, SGD(), mesh, sync_bn=payload["sync_bn"],
                         num_microbatches=payload["num_microbatches"])
    params, state = zip(*(from_jax_params(p, model=st, state=s)
                          for st, p, s in zip(stages, *payload["start"])))
    ts = eng.state_from_params(params, state)
    b = len(payload["labels"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    ts, m = eng.train_step(ts, *eng.shard_batch(payload["images"][rows],
                                                payload["labels"][rows]),
                           payload["lr"])
    out = [to_jax_params(p, model=st, state=s)
           for st, p, s in zip(stages, ts.params, ts.model_state)]
    return {"sums": {k: float(v) for k, v in m.items()},
            "trees": (tuple(p for p, _ in out), tuple(s for _, s in out)),
            "grad_reductions": eng.grad_reductions,
            "backend": dist.get_backend(mesh.group)}


def reducer_ops(rank, world, payload) -> dict:
    """The gradient-reduction primitives on this rank's inputs
    (`payload[name][rank]`, numpy): `ring_reduce_scatter` /
    `ring_all_gather` over the world, `compressed_dcn_psum` with every
    wire over a mesh of `world` slices of one rank, and `bucketed_pmean`
    of a mixed-dtype tree (the names in `payload["bf16"]` cast to bf16)
    for each (dcn, wire) in `payload["tree_cases"]`. Results as f32
    numpy."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.ops.grad_reduction import (
        bucketed_pmean,
        compressed_dcn_psum,
        data_replica_index,
        ring_all_gather,
        ring_reduce_scatter,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    meshes = {d: make_mesh(MeshSpec(dcn=d)) for d in payload["meshes"]}
    flat = torch.from_numpy(payload["flat"][rank])
    out = {
        "rs": ring_reduce_scatter(flat, meshes[1].group).numpy(),
        "ag": ring_all_gather(torch.from_numpy(payload["shard"][rank]),
                              meshes[1].group).numpy(),
        "replica": {d: data_replica_index(m.ici_group, m.dcn_group)
                    for d, m in meshes.items()},
    }
    if world in meshes:
        for wire in ("none", "bf16", "int8"):
            out["dcn", wire] = compressed_dcn_psum(
                flat, meshes[world].dcn_group, wire).numpy()
    tree = {k: torch.from_numpy(np.asarray(v[rank]))
            for k, v in payload["tree"].items()}
    tree = {k: v.to(torch.bfloat16) if k in payload["bf16"] else v
            for k, v in tree.items()}
    for dcn, wire in payload["tree_cases"]:
        got = bucketed_pmean(tree, meshes[dcn].ici_group,
                             meshes[dcn].dcn_group, bucket_mb=0.0005,
                             dcn_compression=wire)
        out["tree", dcn, wire] = {k: v.float().numpy()
                                  for k, v in got.items()}
    return out


def reducer_engines(rank, world, payload) -> dict:
    """DDPEngine (tinycnn, `payload["ddp"]` configs) and the LM engine
    (`payload["lm"]` configs) from the reference weights, each config a
    (grad_reduction, dcn, wire) triple on `make_mesh(MeshSpec(dcn=dcn))`:
    SGD steps on this rank's rows of each global batch. Returns, per
    config, the per-step metric sums, the final parameters (and BN
    state) in the reference layout and the collectives issued."""
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
        to_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
        CausalLMSequenceParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    meshes = {}

    def mesh(dcn):
        if dcn not in meshes:
            meshes[dcn] = make_mesh(MeshSpec(dcn=dcn))
        return meshes[dcn]

    out = {}
    model = tiny_cnn(10)
    for gr, dcn, wire in payload.get("ddp", ()):
        eng = DDPEngine(model, SGD(), mesh=mesh(dcn), device="cpu",
                        grad_reduction=gr, bucket_mb=0.002,
                        dcn_compression=wire)
        ts = eng.state_from_params(*from_jax_params(
            payload["params"], model=model, state=payload["state"]))
        sums = []
        for images, labels in payload["batches"]:
            b = len(labels) // world
            rows = slice(rank * b, (rank + 1) * b)
            ts, m = eng.train_step(ts, *eng.shard_batch(images[rows],
                                                        labels[rows]),
                                   payload["lr"])
            sums.append({k: float(v) for k, v in m.items()})
        params, state = to_jax_params(ts.params, model=model,
                                      state=ts.model_state)
        out["ddp", gr, dcn, wire] = {
            "sums": sums, "params": params, "state": state,
            "collectives": eng.grad_reductions}
    for gr, dcn, wire in payload.get("lm", ()):
        eng = CausalLMSequenceParallelEngine(
            GPTConfig(**payload["gpt"]), SGD(0.9, 1e-2), device="cpu",
            mesh=mesh(dcn), grad_reduction=gr, bucket_mb=0.02,
            dcn_compression=wire)
        ts = eng.state_from_params(from_jax_params(payload["gpt_params"]))
        sums = []
        for _ in range(payload["lm_steps"]):
            ts, m = eng.train_step(ts, *eng.shard_batch(payload["ids"]),
                                   payload["lm_lr"])
            sums.append({k: float(v) for k, v in m.items()})
        out["lm", gr, dcn, wire] = {
            "sums": sums, "params": to_jax_params(ts.params),
            "collectives": eng.grad_reductions}
    return out


def reducer_suite(rank, world, payload) -> dict:
    """`reducer_ops` and `reducer_engines` in one spawn, plus each
    factored mesh's groups as global ranks."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    out = {}
    for d in payload["ops"]["meshes"]:
        mesh = make_mesh(MeshSpec(dcn=d))
        out["groups", d] = tuple(
            None if g is None else dist.get_process_group_ranks(g)
            for g in (mesh.ici_group, mesh.dcn_group))
    out.update(reducer_ops(rank, world, payload["ops"]))
    out.update(reducer_engines(rank, world, payload["engines"]))
    return out


def _tp_optimizer(name: str):
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        AdamW,
    )

    return AdamW() if name == "adamw" else SGD()


def tp_suite(rank, world, payload) -> dict:
    """TensorParallelEngine runs on a tiny BERT (`payload["bert"]`), one
    per entry of `payload["runs"]`: `model` ranks a model group (the
    world's data ranks being world / model), `opt` "sgd" or "adamw",
    `dropout` the config's rate, `cm` collective matmul (Megatron-SP),
    and the start: the reference weights
    `payload["params"]`, or a canonical tree (`resume`, restored through
    a checkpoint file that rank 0 writes and every rank reads); `steps`
    SGD or AdamW steps at `lr` on the batches from index `first`, each
    on this data index's rows of the global batch. `ddp=True`
    runs DDPEngine over the mesh's data group instead (per model
    index). Returns per run: the per-step metric sums, the final
    canonical tree (gathered; `save_after` adds the one after that many
    steps), this rank's block-0 qkv shard and its optimizer moment, and
    its replicated leaves."""
    import torch

    from distributed_model_parallel_tpu_torch.models.bert import (
        BertConfig,
        bert_for_classification,
    )
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
        train_state_to_jax,
    )
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
        TensorParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        Mesh,
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training import checkpoint
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    out = {}
    for run in payload["runs"]:
        cfg = BertConfig(**{**payload["bert"],
                            "dropout_rate": run.get("dropout", 0.0)})
        model = bert_for_classification(payload["classes"], cfg)
        mesh = make_mesh(MeshSpec(data=-1, model=run["model"]))
        opt = _tp_optimizer(run["opt"])
        if run.get("ddp"):
            eng = DDPEngine(model, opt, mesh=Mesh(
                mesh.data, mesh.data_group, data_index=mesh.data_index),
                device="cpu")
        else:
            eng = TensorParallelEngine(model, opt, mesh, device="cpu",
                                       collective_matmul=run.get("cm",
                                                                 False))
        state = model.init(torch.Generator().manual_seed(0))[1]
        if "resume" in run:
            directory = os.path.join(payload["dir"], run["name"])
            checkpoint.save_checkpoint(directory, run["resume"], acc=1.0,
                                       epoch=0)
            like = eng.init_state(1)
            tree, _, _ = checkpoint.restore_checkpoint(
                directory, eng.canonical_spec(like))
            ts = eng.from_canonical(tree, like)
        else:
            ts = eng.state_from_params(
                from_jax_params(payload["params"], model=model), state)
        sums, saved = [], None
        d = mesh.data
        first = run.get("first", 0)
        batches = payload["batches"][first:first + run["steps"]]
        for i, (ids, labels) in enumerate(batches):
            b = len(labels) // d
            rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
            ts, m = eng.train_step(ts, *eng.shard_batch(ids[rows],
                                                        labels[rows]),
                                   run["lr"])
            sums.append({k: float(v) for k, v in m.items()})
            if run.get("save_after") == i + 1:
                saved = eng.to_canonical(ts)
        canon = (train_state_to_jax(ts) if run.get("ddp")
                 else eng.to_canonical(ts))
        flat = flatten_tree(ts.params)
        qkv = "blocks/0/attn/qkv/w"
        moment = (ts.opt_state.momentum if hasattr(ts.opt_state, "momentum")
                  else ts.opt_state.mu)
        out[run["name"]] = {
            "sums": sums, "canonical": canon, "saved": saved,
            "index": (mesh.data_index, mesh.model_index),
            "qkv": flat[qkv].detach().numpy().copy(),
            "qkv_moment": flatten_tree(moment)[qkv].numpy().copy(),
            "replicated": {k: v.detach().numpy().copy()
                           for k, v in flat.items()
                           if not any(s in k for s in ("attn/", "ffn/in",
                                                       "ffn/out/w"))},
            "backend": dist_backend(mesh.model_group),
        }
    if "vit_probe" in payload:
        # ViT's 65 tokens (64 patches and the class token) under
        # Megatron-SP at M = world: refused at the first step.
        import numpy as np

        from distributed_model_parallel_tpu_torch.models.vit import (
            ViTConfig,
            vit,
        )

        eng = TensorParallelEngine(
            vit(10, ViTConfig(**payload["vit_probe"])), SGD(),
            make_mesh(MeshSpec(data=1, model=world)), device="cpu",
            collective_matmul=True)
        images = np.zeros((2, 32, 32, 3), np.float32)
        try:
            eng.train_step(eng.init_state(0), *eng.shard_batch(
                images, np.zeros(2, np.int32)), 0.1)
        except ValueError as e:
            out["vit_refusal"] = str(e)
    return out


def dist_backend(group):
    import torch.distributed as dist

    return None if group is None else dist.get_backend(group)


def lm_pipeline_suite(rank, world, payload) -> dict:
    """LMPipelineEngine at stage 2 over a (data=world) mesh from the
    reference's per-chunk weights: each step on the GLOBAL ids (the
    engine takes this rank's rows); returns the rows it took, the
    per-step metric sums and the final per-chunk params (the start is
    `payload["start"]`, per-chunk params and state). Then, when
    `payload["cli"]` is given, `cli/lm.main` with those flags from this
    rank's directory."""
    from distributed_model_parallel_tpu_torch.models import gpt
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
        to_jax_params,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        LMPipelineEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    stages = gpt.split_stages(2, gpt.GPTConfig(**payload["gpt"]))
    mesh = make_mesh(MeshSpec(data=-1, stage=2), devices=["cpu"])
    eng = LMPipelineEngine(stages, SGD(), mesh, num_microbatches=2,
                           pad_token_id=0)
    params, state = zip(*(from_jax_params(p, model=st, state=s)
                          for st, p, s in zip(stages, *payload["start"])))
    ts = eng.state_from_params(params, state)
    sums, rows = [], []
    for ids in payload["batches"]:
        placed = eng.shard_batch(ids, ids)
        rows.append(placed[0].numpy().copy())
        ts, m = eng.train_step(ts, *placed, payload["lr"])
        sums.append({k: float(v) for k, v in m.items()})
    out = {"rows": rows, "sums": sums,
           "params": [to_jax_params(p, model=st)
                      for st, p in zip(stages, ts.params)],
           "data": (mesh.data, mesh.data_index)}
    if payload.get("cli"):
        from distributed_model_parallel_tpu_torch.cli import lm

        os.chdir(payload["dirs"][rank])
        out["history"] = lm.main(payload["cli"])["history"]
    return out


def val_cut(init, n: int):
    """`DatasetCollection.init` with its val split cut to the first n rows
    (the CLI tests' validation passes stay short)."""
    from distributed_model_parallel_tpu_torch.data import datasets

    def cut(self):
        train, val = init(self)
        return train, datasets.ArrayDataset(
            val.images[:n], val.labels[:n], val.num_classes, val.kind)

    return cut


def cli_suite(rank, world, payload) -> dict:
    """Each (module, argv, directory index) of `payload["runs"]`:
    `cli/<module>.main(argv)` in this rank, from
    `payload["dirs"][index][rank]`; returns each run's history. With
    `payload["val"]` the val splits are cut to that many rows."""
    if payload.get("val"):
        from distributed_model_parallel_tpu_torch.data import datasets

        datasets.DatasetCollection.init = val_cut(
            datasets.DatasetCollection.init, payload["val"])
    out = []
    for module, argv, where in payload["runs"]:
        main = importlib.import_module(
            f"distributed_model_parallel_tpu_torch.cli.{module}").main
        os.chdir(payload["dirs"][where][rank])
        out.append(main(argv)["history"])
    return out


def fsdp_model(payload):
    """The port's model of an FSDP payload: tinycnn(10), or the BERT
    classifier of `payload["bert"]`."""
    if payload["model"] == "tinycnn":
        from distributed_model_parallel_tpu_torch.models.tinycnn import (
            tiny_cnn,
        )

        return tiny_cnn(10)
    from distributed_model_parallel_tpu_torch.models.bert import (
        BertConfig,
        bert_for_classification,
    )

    return bert_for_classification(payload["classes"],
                                   BertConfig(**payload["bert"]))


def fsdp_suite(rank, world, payload) -> dict:
    """FSDPEngine runs from the reference weights `payload["params"]` /
    `["state"]`, one per entry of `payload["runs"]` (`name`, `gr`,
    `opt`, `lr`, and optionally `dcn`, `wire`, `bucket_mb`): SGD or
    AdamW steps on this rank's rows of each global batch. Returns per
    run: the per-step metric sums, the gathered canonical tree, this
    rank's parameter shard shapes in the canonical layout, and the
    collectives issued."""
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )

    model = fsdp_model(payload)
    meshes = {}
    out = {}
    for run in payload["runs"]:
        dcn = run.get("dcn", 1)
        if dcn not in meshes:
            meshes[dcn] = make_mesh(MeshSpec(dcn=dcn))
        eng = FSDPEngine(model, _tp_optimizer(run["opt"]), meshes[dcn],
                         device="cpu", grad_reduction=run["gr"],
                         bucket_mb=run.get("bucket_mb", 0.002),
                         dcn_compression=run.get("wire", "none"),
                         min_shard_elems=payload.get("min_shard_elems",
                                                     1024))
        ts = eng.state_from_params(*from_jax_params(
            payload["params"], model=model, state=payload["state"]))
        sums = []
        for x, y in payload["batches"]:
            b = len(y) // world
            rows = slice(rank * b, (rank + 1) * b)
            ts, m = eng.train_step(ts, *eng.shard_batch(x[rows], y[rows]),
                                   run["lr"])
            sums.append({k: float(v) for k, v in m.items()})
        shapes = {k: tuple(v.permute(2, 3, 1, 0).shape if v.dim() == 4
                           else v.shape)
                  for k, v in flatten_tree(ts.params).items()}
        out[run["name"]] = {
            "sums": sums, "canonical": eng.to_canonical(ts),
            "shapes": shapes, "grad_reductions": eng.grad_reductions,
            "param_gathers": eng.param_gathers}
    return out


def codec_suite(rank, world, payload) -> dict:
    """`coded_ppermute` forward and backward on this rank's row of
    `payload["x"]` / `["g"]` for each (perm name, perm, wire) of
    `payload["hops"]` over the world; `FSDPEngine._coded_dcn_gather` of
    this rank's rows of `payload["leaf"]` on a `MeshSpec(dcn=2)` mesh for
    each wire; then `fsdp_suite` on `payload["fsdp"]` when given."""
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.ops.wire_codec import (
        coded_ppermute,
    )
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    out = {}
    for name, perm, wire in payload["hops"]:
        x = torch.from_numpy(payload["x"][rank:rank + 1]).requires_grad_()
        y = coded_ppermute(x, dist.group.WORLD, perm, wire)
        y.backward(torch.from_numpy(payload["g"][rank:rank + 1]))
        out["hop", name, wire] = (y.detach().numpy().copy(),
                                  x.grad.numpy().copy())
    mesh = make_mesh(MeshSpec(dcn=2))
    leaf = payload["leaf"]
    rows = len(leaf) // world
    shard = torch.from_numpy(leaf[rank * rows:(rank + 1) * rows])
    for wire in ("none", "bf16", "int8"):
        eng = FSDPEngine(tiny_cnn(10), SGD(), mesh, device="cpu",
                         dcn_compression="int8")
        eng._wire = wire
        out["gather", wire] = eng._coded_dcn_gather(shard, 0).numpy()
    if "fsdp" in payload:
        out["fsdp"] = fsdp_suite(rank, world, payload["fsdp"])
    return out


def _ckpt_engine(payload, kind: str, opt: str):
    """An FSDPEngine or a TensorParallelEngine (model = the world) on the
    payload's BERT, on this process's world."""
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
        TensorParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.dist import (
        process_count,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    model = fsdp_model(payload)
    if kind == "tp":
        return TensorParallelEngine(
            model, _tp_optimizer(opt),
            make_mesh(MeshSpec(data=-1, model=process_count())),
            device="cpu")
    return FSDPEngine(model, _tp_optimizer(opt), device="cpu")


def _ckpt_steps(eng, ts, payload, steps: int, rank: int):
    """`steps` steps on this data index's rows of the payload's batches."""
    sums = []
    d, i = eng.mesh.data, eng.mesh.data_index
    for x, y in payload["batches"][:steps]:
        b = len(y) // d
        ts, m = eng.train_step(ts, *eng.shard_batch(x[i * b:(i + 1) * b],
                                                    y[i * b:(i + 1) * b]),
                               payload["lr"])
        sums.append({k: float(v) for k, v in m.items()})
    return ts, sums


def ckpt_suite(rank, world, payload) -> dict:
    """Sharded-checkpoint operations, in order (`payload["ops"]`):
    ("save", kind, directory): the engine (`_ckpt_engine`) from the
    reference weights, `payload["steps"]` steps, `save_sharded` of its
    `to_canonical_sharded` view with every all-gather and broadcast of
    `torch.distributed` made to raise; ("restore", kind, directory):
    the engine restored from the directory through the unified reader,
    then one step. Returns per op the gathered canonical tree (after the
    save's steps, or right after the restore) and, for a restore, the
    step's sums and the canonical tree after it."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )

    out = []
    for op, kind, directory in payload["ops"]:
        eng = _ckpt_engine(payload, kind, payload["opt"])
        if op == "save":
            ts = eng.state_from_params(*from_jax_params(
                payload["params"], model=eng.model, state=payload["state"]))
            ts, _ = _ckpt_steps(eng, ts, payload, payload["steps"], rank)
            view = eng.to_canonical_sharded(ts)
            saved = {}

            def refuse(*a, **k):
                raise AssertionError("a collective ran on the save path")

            for name in ("all_gather", "all_gather_into_tensor",
                         "all_gather_object", "broadcast", "all_reduce"):
                saved[name] = getattr(dist, name)
                setattr(dist, name, refuse)
            try:
                checkpointing.save_sharded(directory, view, acc=1.5,
                                           epoch=2)
            finally:
                for name, fn in saved.items():
                    setattr(dist, name, fn)
            dist.barrier()  # rank 0 committed the manifest
            out.append({"canonical": eng.to_canonical(ts)})
            continue
        like = eng.init_state(1)
        tree, acc, epoch = checkpointing.restore_checkpoint(
            directory, eng.canonical_spec(like))
        ts = eng.from_canonical(tree, like)
        before = eng.to_canonical(ts)
        ts, sums = _ckpt_steps(eng, ts, payload, 1, rank)
        out.append({"canonical": before, "meta": (acc, epoch),
                    "sums": sums, "after": eng.to_canonical(ts)})
    return out


def elastic_cli(rank, world, payload) -> dict:
    """`cli/data_parallel.main(payload["argv"])` in this rank from
    `payload["dir"]`, with the training failing once at the start of
    epoch `payload["fail_epoch"]` (None: never); the val split cut to
    `payload["val"]` rows; bert_tiny without dropout when
    `payload["no_dropout"]`, and FSDP's initial weights the reference
    tree `payload["init"]` when given. Returns the history, the elastic summary and
    the topology the checkpoint directory recorded before the run."""
    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.training import trainer

    datasets.DatasetCollection.init = val_cut(
        datasets.DatasetCollection.init, payload["val"])
    if payload.get("no_dropout"):
        import dataclasses

        from distributed_model_parallel_tpu_torch.cli import common

        tiny = common._bert_tiny_cfg
        common._bert_tiny_cfg = lambda: dataclasses.replace(
            tiny(), dropout_rate=0.0)
    if payload.get("init"):
        from distributed_model_parallel_tpu_torch.models.convert import (
            from_jax_params,
        )
        from distributed_model_parallel_tpu_torch.parallel.fsdp import (
            FSDPEngine,
        )

        params, state = payload["init"]
        FSDPEngine.init_state = lambda self, seed=0: self.state_from_params(
            *from_jax_params(params, model=self.model, state=state))
    real = trainer.Trainer.train_epoch
    failed = []

    def train_epoch(self, epoch):
        if epoch == payload.get("fail_epoch") and not failed:
            failed.append(epoch)
            raise RuntimeError(f"injected failure in epoch {epoch}")
        return real(self, epoch)

    trainer.Trainer.train_epoch = train_epoch
    os.chdir(payload["dir"])
    topology = checkpointing.saved_topology(payload["ckpt"], "last")
    out = data_parallel.main(payload["argv"])
    return {"history": out["history"], "elastic": out.get("elastic"),
            "topology": topology}


def ring_ops(rank, world, payload) -> dict:
    """Each (name, causal, dtype) of `payload["cases"]`: the port's
    sequence-parallel op (`ops/ring_attention.py`) on this rank's columns
    of the global q, k, v and key mask (numpy, f32) cast to `dtype`, over
    the seq group of `MeshSpec(data=1, seq=world)`. Returns, per case,
    the local output and the gradients of sum(out**2) with respect to the
    local q, k and v, as f32 numpy."""
    from functools import partial

    import torch

    from distributed_model_parallel_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    ra = importlib.import_module(
        "distributed_model_parallel_tpu_torch.ops.ring_attention")

    fns = {"ring": ra.ring_attention, "ring_flash": ra.ring_flash_attention,
           "ulysses": ra.ulysses_attention,
           "ulysses_flash": partial(ra.ulysses_attention,
                                    attention_impl=flash_attention)}
    mesh = make_mesh(MeshSpec(data=1, seq=world))
    t = payload["q"].shape[1] // world
    cols = slice(mesh.seq_index * t, (mesh.seq_index + 1) * t)
    out = {}
    for name, causal, dtype in payload["cases"]:
        q, k, v = (torch.from_numpy(payload[x][:, cols]).to(
            getattr(torch, dtype)).requires_grad_(True) for x in "qkv")
        mask = torch.from_numpy(payload["mask"][:, cols]).contiguous()
        o = fns[name](q, k, v, mask, group=mesh.seq_group, causal=causal)
        o.float().square().sum().backward()
        out[name, causal, dtype] = [t.detach().float().numpy()
                                    for t in (o, q.grad, k.grad, v.grad)]
    return out


def _sp_steps(eng, ts, batches, lr):
    sums = []
    for batch in batches:
        ts, m = eng.train_step(ts, *eng.shard_batch(*batch), lr)
        sums.append({k: float(v) for k, v in m.items()})
    return ts, sums


def sp_suite(rank, world, payload) -> dict:
    """The sequence-parallel engines from the reference's weights, SGD
    steps over the global batches of the payload on `MeshSpec(data=d,
    seq=s, dcn=k)` meshes of the world:

    * `payload["lm"]`: (d, s, k, attention, grad_reduction, wire, layers)
      configs of `CausalLMSequenceParallelEngine` (SGD(0.9, 1e-2));
      returns the metric sums a step, the final parameters and momentum
      in the reference layout and the collectives issued;
    * `payload["bert"]`: (d, s, attention) configs of
      `SequenceParallelEngine` (SGD()); the sums and parameters;
    * `payload["lm_cm"]` and `payload["bert_cm"]`: configs of the same
      forms run with `collective_matmul=True`;
    * `payload["dropout"]`: the LM at dropout 0.1 on (1, world): the
      mask each rank draws for one key, and the sums and parameters of
      two runs each with and without remat."""
    import torch

    from distributed_model_parallel_tpu_torch.models import bert as tbert
    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
        to_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine, SequenceParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    meshes = {}

    def mesh(d, s, k=1):
        if (d, s, k) not in meshes:
            meshes[d, s, k] = make_mesh(MeshSpec(data=d, seq=s, dcn=k))
        return meshes[d, s, k]

    def lm(cfg, d, s, k=1, **kw):
        return CausalLMSequenceParallelEngine(
            cfg, SGD(0.9, 1e-2), device="cpu", mesh=mesh(d, s, k),
            bucket_mb=0.02, **kw)

    out = {}
    ids = [(b,) for b in payload.get("ids", ())]
    for key in ("lm", "lm_cm"):
        for config in payload.get(key, ()):
            d, s, k, attention, gr, wire, layers = config
            eng = lm(GPTConfig(**dict(payload["gpt"], num_layers=layers)),
                     d, s, k, attention=attention, grad_reduction=gr,
                     dcn_compression=wire, collective_matmul=key == "lm_cm")
            ts = eng.state_from_params(from_jax_params(
                payload["gpt_params"][layers]))
            ts, sums = _sp_steps(eng, ts, ids, payload["lr"])
            out[key, config] = {
                "sums": sums, "params": to_jax_params(ts.params),
                "momentum": to_jax_params(ts.opt_state.momentum),
                "collectives": eng.grad_reductions}
    for key in ("bert", "bert_cm"):
        for config in payload.get(key, ()):
            d, s, attention = config
            cfg = tbert.BertConfig(**payload["bert_cfg"])
            model = tbert.bert_for_classification(payload["classes"], cfg)
            eng = SequenceParallelEngine(
                cfg, payload["classes"], SGD(), mesh=mesh(d, s),
                attention=attention, device="cpu",
                collective_matmul=key == "bert_cm")
            ts = eng.state_from_params(from_jax_params(
                payload["bert_params"], model=model))
            ts, sums = _sp_steps(eng, ts, payload["bert_batches"],
                                 payload["bert_lr"])
            out[key, config] = {"sums": sums,
                                "params": to_jax_params(ts.params,
                                                        model=model)}
    if "dropout" in payload:
        drop = payload["dropout"]
        cfg = GPTConfig(**dict(payload["gpt"], num_layers=2,
                               dropout_rate=0.1))
        probe = lm(cfg, 1, world, attention=drop["attention"])
        ctx = L.Context(train=True, rng=probe._key(0))
        out["mask"] = L.dropout(torch.ones(4, 8, 8), 0.1,
                                ctx.child(0)).numpy()
        runs = []
        for remat in (False, False, True):
            eng = lm(cfg, 1, world, attention=drop["attention"],
                     remat=remat)
            ts = eng.state_from_params(from_jax_params(drop["params"]))
            ts, sums = _sp_steps(eng, ts, ids, payload["lr"])
            runs.append({"sums": sums, "params": to_jax_params(ts.params)})
        out["dropout_runs"] = runs
    return out


def lm_engine_probe(rank, world, payload) -> dict:
    """`cli/lm.main(payload["argv"])` in this rank up to the trainer:
    the engine it builds, described (its mesh axes and attention)."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.cli import lm

    seen = {}

    class Stop(Exception):
        pass

    def trainer(engine, train, val, cfg, **kw):
        seen["engine"] = engine
        raise Stop

    lm.Trainer = trainer
    try:
        lm.main(payload["argv"])
    except Stop:
        pass
    eng = seen["engine"]
    return {"data": eng.mesh.data, "seq": eng.mesh.seq,
            "seq_index": eng.mesh.seq_index,
            "data_index": eng.mesh.data_index,
            "data_seq_ranks": dist.get_world_size(eng.mesh.data_seq_group),
            "attention": eng.attention}


def ring_flash_on_card(rank, world, payload) -> dict:
    """`ring_flash_attention` on the card (cuda:0, shared by the ranks of
    a gloo world, which stages the hops through the host) on this rank's
    columns of the global q, k, v and mask: per causal flag, the flash
    kernels' launches over one forward and backward, the local output
    and the gradients of sum(out**2), as numpy."""
    import torch

    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    fa = importlib.import_module(
        "distributed_model_parallel_tpu_torch.ops.flash_attention")
    ra = importlib.import_module(
        "distributed_model_parallel_tpu_torch.ops.ring_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = make_mesh(MeshSpec(data=1, seq=world))
    t = payload["q"].shape[1] // world
    cols = slice(mesh.seq_index * t, (mesh.seq_index + 1) * t)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    out = {}
    for causal in (True, False):
        for k in kernels:
            k.launches = 0
        q, k, v = (torch.from_numpy(payload[x][:, cols]).cuda()
                   .requires_grad_(True) for x in "qkv")
        mask = torch.from_numpy(payload["mask"][:, cols]).cuda()
        o = ra.ring_flash_attention(q, k, v, mask, group=mesh.seq_group,
                                    causal=causal)
        o.square().sum().backward()
        torch.cuda.synchronize()
        out[causal] = {"launches": [fn.launches for fn in kernels],
                       "parts": [x.detach().cpu().numpy()
                                 for x in (o, q.grad, k.grad, v.grad)]}
    return out


def cm_ops(rank, world, payload) -> dict:
    """The collective-matmul rings (`ops/collective_matmul.py`) over the
    world's group: for each case, this rank's rows of the global x
    (`ag`: x (B, T, D), w (D, F) column-sharded) or this rank's column
    block of x and row block of w (`rs`: x (B, T, F), w (F, D)). Returns
    the ring's output, the naive op's, and the ring's gradients of
    sum(out * g) (g the global cotangent, this rank's part) for x and w,
    with the hops each ring issued."""
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.ops import collective_matmul \
        as cm

    group, i = dist.group.WORLD, rank
    out = {}
    for name in ("ag", "rs"):
        x, w, g = (payload[name][k] for k in ("x", "w", "g"))
        if name == "ag":
            t, f = x.shape[-2] // world, w.shape[-1] // world
            xl, wl = x[..., i * t:(i + 1) * t, :], w[:, i * f:(i + 1) * f]
            gl = g[..., i * f:(i + 1) * f]
            ring, naive = cm.ag_matmul, cm.naive_ag_matmul
        else:
            f, t = x.shape[-1] // world, x.shape[-2] // world
            xl, wl = x[..., i * f:(i + 1) * f], w[i * f:(i + 1) * f]
            gl = g[..., i * t:(i + 1) * t, :]
            ring, naive = cm.matmul_rs, cm.naive_matmul_rs
        tx, tw = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (xl, wl))
        hops = cm.hops
        y = ring(tx, tw, group)
        fwd_hops = cm.hops - hops
        (y * torch.from_numpy(gl.copy())).sum().backward()
        with torch.no_grad():
            y_naive = naive(tx, tw, group)
        out[name] = {"y": y.detach().numpy(), "naive": y_naive.numpy(),
                     "dx": tx.grad.numpy(), "dw": tw.grad.numpy(),
                     "hops": fwd_hops,
                     "bwd_hops": cm.hops - hops - fwd_hops}
    return out


def run_serving_script(eng, params, script) -> list:
    """Drive `eng` (contiguous or paged) through `script`, teacher-forced:
    ("prefill", slot, prompt) -> next logits (vocab,); ("decode", tokens,
    active) -> logits (slots, vocab) of every slot; ("verify", tokens
    (slots, T), active) -> logits (slots, T, vocab), every active slot's
    span then kept; ("release", slot) frees a paged slot's pages. Returns
    the logits of each step as numpy, in order."""
    import numpy as np
    import torch

    n = eng.num_slots
    cache = eng.init_cache()
    host = eng.new_host() if eng.paged_spec is not None else None
    positions = np.zeros(n, np.int64)
    out = []

    def device(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype))

    for op, *args in script:
        if op == "release":
            host.release(args[0])
            continue
        if op == "prefill":
            slot, prompt = args
            ids, length = eng.pad_prompt(prompt)
            if host is None:
                cache, logits = eng.prefill(params, cache, ids, length, slot)
            else:
                host.ensure_pages(slot, int(prompt.size))
                cache, logits = eng.paged_prefill_step(
                    params, cache, host.device_row(slot), ids, length)
            positions[slot] = prompt.size
        elif op == "decode" and host is None:
            tokens, active = args
            cache, logits = eng.decode_step(params, cache,
                                            device(tokens, np.int64),
                                            device(active, bool))
            positions[active] += 1
        elif op == "decode":
            tokens, active = args
            for slot in np.nonzero(active)[0]:
                cache = host.ensure_writable(cache, int(slot),
                                             int(positions[slot]))
            cache, logits = eng.paged_decode_step(
                params, cache, host.device_table(),
                *eng.step_inputs(positions, tokens, active))
            positions[active] += 1
        else:  # verify
            tokens, active = args
            t = tokens.shape[1]
            for slot in np.nonzero(active)[0]:
                host.ensure_pages(int(slot), int(positions[slot]) + t)
            cache, logits = eng.paged_verify_step(
                params, cache, host.device_table(),
                device(positions, np.int64), device(tokens, np.int64),
                device(active, bool))
            positions[active] += t
        out.append(logits.float().numpy())
    return out


def serving_layouts(rank, world, payload) -> dict:
    """The port's `ServingEngine` under `payload["layout"]` ("tp" over
    `MeshSpec(data=1, model=world)`, "sp" over `seq=world`) from the
    reference's weights: for each (name, engine kwargs, script) of
    `payload["cases"]`, the script's logits (`run_serving_script`); for
    each (name, engine kwargs, requests) of `payload["runs"]`
    (speculative when the kwargs say so, with a draft mirroring the
    layout), the generated tokens and the scheduler's counts; and under
    tp, whether this rank's placed shards equal the replicated placement
    split (`placed_equals_split`)."""
    import dataclasses

    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.ops import collective_matmul \
        as cm
    from distributed_model_parallel_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from distributed_model_parallel_tpu_torch.serving.scheduler import (
        Request,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    axis = "model" if payload["layout"] == "tp" else "seq"
    mesh = make_mesh(MeshSpec(data=1, **{axis: world}))
    cfg = GPTConfig(**payload["cfg"])

    def engine(kw, config=cfg):
        return ServingEngine(config, mesh=mesh, layout=payload["layout"],
                             device="cpu", **kw)

    out = {"logits": {}, "hops": {}, "runs": {}}
    for name, kw, script in payload["cases"]:
        eng = engine(kw)
        params = eng.place_params(from_jax_params(payload["params"]))
        hops = cm.hops
        out["logits"][name] = run_serving_script(eng, params, script)
        out["hops"][name] = cm.hops - hops
    for name, kw, requests in payload.get("runs", ()):
        eng = engine(kw)
        params = eng.place_params(from_jax_params(payload["params"]))
        draft = draft_params = None
        if kw.get("speculative_k"):
            dcfg = dataclasses.replace(cfg, num_layers=1)
            draft = engine({k: v for k, v in kw.items()
                            if k != "speculative_k"}, dcfg)
            draft_params = draft.place_params(
                from_jax_params(payload["draft_params"]))
        sched = eng.run(params, [Request(rid=i, prompt=p, max_new_tokens=m)
                                 for i, (p, m) in enumerate(requests)],
                        draft=draft, draft_params=draft_params)
        out["runs"][name] = {f.rid: list(f.tokens) for f in sched.finished}
    if payload["layout"] == "tp":
        full = from_jax_params(payload["params"])
        rep = ServingEngine(cfg, device="cpu").place_params(full)
        split = tp.shard_tree(rep, tp.shard_specs(rep, tp.MEGATRON_RULES),
                              mesh.model_index, world)
        placed = engine({}).place_params(from_jax_params(payload["params"]))
        out["placed_equals_split"] = all(
            torch.equal(a, b)
            for a, b in zip(tree_leaves(placed), tree_leaves(split)))
    return out


def moe_suite(rank, world, payload) -> dict:
    """The port's expert parallelism over the world (`tests/
    test_torch_port_moe_exchange.py`):

    * `payload["ops"]`: for each (dcn, overlap, wire) case, this rank's
      (E, b, C, D) buffer `xin[rank]` through `dispatch_exchange`, the
      flat all-to-all and back through `combine_exchange`, and
      `exchanged_expert_ffn` with this rank's expert block of `w`: its
      output and the gradients of sum(out * cot[rank]), with the hops;
    * `payload["ep"]`: (data, expert, dcn, dispatch, overlap, wire)
      configs of `ExpertParallelLMEngine` from the reference's weights,
      SGD(0.9, 1e-2) over the global id batches: metric sums a step, the
      canonical parameters, hops and the local expert-parameter bytes;
    * `payload["ddp"]`: (grad_reduction, expert_dispatch, overlap)
      configs of `DDPEngine` on the MoE BERT classifier ("gspmd": the
      `DataParallelEngine`);
    * `payload["save"]` / `payload["restore"]`: a hierarchical EP state
      saved in the sharded format after `len(ids) - 1` steps, and one
      restored at this world's S, each then taking the last step;
    * `payload["cli"]`: `cli/lm.main` runs, as `cli_suite`'s."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.models import bert as tbert
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        gpt_lm_model,
    )
    from distributed_model_parallel_tpu_torch.ops import expert_dispatch \
        as xd
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import ExpertParallelLMEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    meshes = {}

    def mesh(d, n=1, k=1):
        if (d, n, k) not in meshes:
            meshes[d, n, k] = make_mesh(MeshSpec(data=d, expert=n, dcn=k))
        return meshes[d, n, k]

    def t(a, grad=False):
        return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)

    out = {}
    for case in payload.get("ops", ()):
        k, overlap, wire = case
        m = mesh(world, 1, k)
        xin, w, cot = (payload["xin"][rank], payload["w"],
                       payload["cot"][rank])
        el = w["w_in"].shape[0] // world
        rec = {}
        if not overlap and wire == "none":
            z = xd.dispatch_exchange(t(xin), m.ici_group, m.dcn_group)
            rec["z"] = z.numpy()
            rec["flat"] = xd.flat_expert_exchange(t(xin), m.group).numpy()
            rec["back"] = xd.combine_exchange(z, m.ici_group,
                                              m.dcn_group).numpy()
            rec["flat_back"] = xd.flat_expert_return(
                t(rec["flat"]), m.group).numpy()
        tx = t(xin, True)
        tw = {n: t(v[rank * el:(rank + 1) * el], True) for n, v in w.items()}
        before = xd.hops
        y = xd.exchanged_expert_ffn(tx, tw, m.ici_group, m.dcn_group,
                                    overlap, wire)
        rec["fwd_hops"] = xd.hops - before
        (y * t(cot)).sum().backward()
        rec["bwd_hops"] = xd.hops - before - rec["fwd_hops"]
        rec["y"] = y.detach().numpy()
        rec["dx"] = tx.grad.numpy()
        rec["dw"] = {n: v.grad.numpy() for n, v in tw.items()}
        out["ops", case] = rec

    ids = payload.get("ids", ())

    def lm_engine(d, n, k, dispatch, overlap, wire):
        cfg = GPTConfig(**payload["gpt"])
        return ExpertParallelLMEngine(
            gpt_lm_model(cfg), SGD(0.9, 1e-2), mesh(d, n, k), device="cpu",
            dispatch=dispatch, overlap=overlap, dcn_compression=wire,
            pad_token_id=0)

    def lm_steps(eng, ts, batches):
        sums = []
        for b in batches:
            ts, m = eng.train_step(ts, *eng.shard_batch(b), payload["lr"])
            sums.append({key: float(v) for key, v in m.items()})
        return ts, sums

    def start(eng):
        state = eng.model.init(torch.Generator())[1]
        return eng.state_from_params(from_jax_params(payload["params"]),
                                     state)

    def expert_bytes(ts):
        return sum(v.numel() * v.element_size()
                   for b in ts.params["blocks"].values() if "moe" in b
                   for v in b["moe"]["experts"].values())

    for config in payload.get("ep", ()):
        eng = lm_engine(*config)
        before = xd.hops
        ts, sums = lm_steps(eng, start(eng), ids)
        out["ep", config] = {"sums": sums,
                             "tree": eng.to_canonical(ts),
                             "hops": xd.hops - before,
                             "expert_bytes": expert_bytes(ts),
                             "grad_reductions": eng.grad_reductions}
    for config in payload.get("ddp", ()):
        gr, dispatch, overlap = config
        cfg = tbert.BertConfig(**payload["bert"])
        model = tbert.bert_for_classification(payload["classes"], cfg)
        if gr == "gspmd":  # the global-batch engine
            eng = DataParallelEngine(model, SGD(0.9, 1e-2), mesh(world),
                                     device="cpu")
        else:
            eng = DDPEngine(model, SGD(0.9, 1e-2), mesh(world),
                            device="cpu", grad_reduction=gr, bucket_mb=0.02,
                            expert_dispatch=dispatch, expert_overlap=overlap)
        ts = eng.state_from_params(*from_jax_params(
            payload["bert_params"], model=model,
            state=payload["bert_state"]))
        sums = []
        for b_ids, labels in payload["bert_batches"]:
            rows = slice(rank * len(labels) // world,
                         (rank + 1) * len(labels) // world)
            ts, m = eng.train_step(ts, *eng.shard_batch(b_ids[rows],
                                                        labels[rows]),
                                   payload["lr"])
            sums.append({key: float(v) for key, v in m.items()})
        out["ddp", config] = {
            "sums": sums, "params": {p: v.detach().numpy() for p, v in
                                     _flat_leaves(ts.params).items()}}
    if "save" in payload:
        eng = lm_engine(world, 1, 1, "hierarchical", False, "none")
        ts, _ = lm_steps(eng, start(eng), ids[:-1])
        checkpointing.save_sharded(payload["save"],
                                   eng.to_canonical_sharded(ts), acc=0.0,
                                   epoch=0)
        dist.barrier()
        ts, sums = lm_steps(eng, ts, ids[-1:])
        out["saved_then"] = {"sums": sums,
                             "tree": eng.to_canonical(ts)}
    for config in payload.get("restore", ()):
        eng = lm_engine(*config)
        like = start(eng)
        tree, _, _ = checkpointing.restore_checkpoint(
            payload["restore_dir"], eng.canonical_spec(like))
        ts, sums = lm_steps(eng, eng.from_canonical(tree, like), ids[-1:])
        out["restored", config] = {"sums": sums,
                                   "tree": eng.to_canonical(ts)}
    if "cli" in payload:
        out["cli"] = cli_suite(rank, world, payload["cli"])
    if "eptp" in payload:
        out["eptp"] = eptp_cases(rank, world, payload["eptp"])
    return out


def eptp_cases(rank, world, payload) -> dict:
    """EP x TP (`ExpertParallelEngine(rules=EXPERT_RULES +
    MEGATRON_RULES)` on `MeshSpec(data, model, expert)`), from the
    reference's weights (`tests/test_torch_port_moe_exchange.py`,
    `tests/test_torch_port_plan.py`):

    * `payload["bert"]` configs (data, model, expert[, "cm"]): the MoE
      BERT classifier (on the collective-matmul rings with "cm"), SGD
      over the global batch `ids` / `labels` (each data index its
      rows): per-step mean losses, this rank's qkv and w_in shapes, the
      canonical parameters;
    * `payload["lm"]` configs (data, model, expert[, dispatch]):
      `ExpertParallelLMEngine` on the MoE GPT over the global id batches:
      per-step sums, canonical parameters; with `payload["save"]`, the
      first config's state after the steps is saved in the sharded
      format there;
    * `payload["restore"]`: (config, directory) pairs restored at the
      config and taken one step on the last batch."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.models import bert as tbert
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        gpt_lm_model,
    )
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import (EXPERT_RULES, MEGATRON_RULES, ExpertParallelEngine,
                ExpertParallelLMEngine)
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    rules = EXPERT_RULES + MEGATRON_RULES
    out = {}
    for config in payload.get("bert", ()):
        mesh = make_mesh(MeshSpec(data=config[0], model=config[1],
                                  expert=config[2]))
        cfg = tbert.BertConfig(**payload["bert_cfg"])
        model = tbert.bert_for_classification(payload["classes"], cfg)
        eng = ExpertParallelEngine(model, SGD(), mesh, device="cpu",
                                   rules=rules,
                                   collective_matmul="cm" in config[3:])
        ts = eng.state_from_params(*from_jax_params(
            payload["bert_params"], model=model, state=payload["bert_state"]))
        ids, labels = payload["ids"], payload["labels"]
        rows = len(labels) // mesh.data
        mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
        losses = []
        for _ in range(payload["steps"]):
            ts, m = eng.train_step(ts, *eng.shard_batch(ids[mine],
                                                        labels[mine]),
                                   payload["lr"])
            losses.append(float(m["loss_sum"]) / float(m["count"]))
        blocks = ts.params["blocks"]
        out["bert", config] = {
            "losses": losses,
            "qkv": tuple(blocks["0"]["attn"]["qkv"]["w"].shape),
            "w_in": tuple(blocks["1"]["moe"]["experts"]["w_in"].shape),
            "tree": eng.to_canonical(ts)["params"]}
    for config in payload.get("lm", ()):
        mesh = make_mesh(MeshSpec(data=config[0], model=config[1],
                                  expert=config[2]))
        eng = ExpertParallelLMEngine(
            gpt_lm_model(GPTConfig(**payload["gpt"])), SGD(0.9, 1e-2), mesh,
            device="cpu", rules=rules, pad_token_id=0,
            dispatch=config[3] if config[3:] else "gspmd")
        ts = eng.state_from_params(from_jax_params(payload["gpt_params"]),
                                   eng.model.init(torch.Generator())[1])
        sums = []
        for b in payload["lm_ids"]:
            ts, m = eng.train_step(ts, *eng.shard_batch(b), payload["lm_lr"])
            sums.append({k: float(v) for k, v in m.items()})
        out["lm", config] = {"sums": sums,
                             "tree": eng.to_canonical(ts)}
        if payload.get("save") and config == payload["lm"][0]:
            checkpointing.save_sharded(payload["save"],
                                       eng.to_canonical_sharded(ts),
                                       acc=0.0, epoch=0)
            dist.barrier()
    for config, directory in payload.get("restore", ()):
        mesh = make_mesh(MeshSpec(data=config[0], model=config[1],
                                  expert=config[2]))
        eng = ExpertParallelLMEngine(
            gpt_lm_model(GPTConfig(**payload["gpt"])), SGD(0.9, 1e-2), mesh,
            device="cpu", rules=rules, pad_token_id=0)
        like = eng.init_state(1)
        tree, _, _ = checkpointing.restore_checkpoint(
            directory, eng.canonical_spec(like))
        ts, m = eng.train_step(eng.from_canonical(tree, like),
                               *eng.shard_batch(payload["lm_ids"][-1]),
                               payload["lm_lr"])
        out["restored", config, directory] = {
            "sums": {k: float(v) for k, v in m.items()},
            "tree": eng.to_canonical(ts)}
        out["restored_shapes", config, directory] = {
            k: tuple(v.shape) for k, v in _flat_leaves(ts.params).items()}
    return out


def _flat_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        flat = {}
        for key, v in tree.items():
            flat.update(_flat_leaves(v, f"{prefix}{key}/"))
        return flat
    return {prefix[:-1]: tree}


def plan_suite(rank, world, payload) -> dict:
    """Composed plans (`parallel/plan.py`) from the reference's weights.
    `payload["runs"]` lists (name, spec, ranks, options) runs; every rank
    builds every run's engine in order (the plan meshes' groups are
    collective over the world), then runs the ones whose ranks hold it,
    in order: SGD(*payload["sgd"]) steps over `payload["batches"]` and an eval
    step on the last batch. A run's first rank returns its metric sums a
    step, the eval sums, the canonical parameters and momentum
    (`to_canonical`), the stage-wire hops and the fused reductions of its
    ranks; `options["fsdp_shapes"]` adds this rank's parameter shapes. A
    pp-only plan (`LMPipelineEngine` on stage ranks) starts from the same
    weights cut into its chunks (`staging.partition_tree`)."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models import staging
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        build_plan_engine,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    cfg = GPTConfig(**payload["gpt"])
    engines = [build_plan_engine(cfg, SGD(*payload["sgd"]), spec,
                                 ranks=ranks, device="cpu",
                                 **opts.get("kw", {}))
               for _, spec, ranks, opts in payload["runs"]]
    params = from_jax_params(payload["params"])
    out = {}
    for eng, (name, spec, ranks, opts) in zip(engines, payload["runs"]):
        if rank not in ranks:
            continue
        if hasattr(eng, "stages"):
            cuts = staging.split_points(len(eng.stages), None,
                                        cfg.num_layers)
            empty = {"stem": {}, "head": {},
                     "blocks": {str(i): {} for i in range(cfg.num_layers)}}
            ts = eng.state_from_params(staging.partition_tree(params, cuts),
                                       staging.partition_tree(empty, cuts))
        else:
            ts = eng.state_from_params(params)
        sums = []
        for ids in payload["batches"]:
            ts, m = eng.train_step(ts, *eng.shard_batch(ids), payload["lr"])
            sums.append({k: float(v) for k, v in m.items()})
        ev = eng.eval_step(ts, *eng.shard_batch(payload["batches"][-1]))
        tree = eng.to_canonical(ts)
        mine = (eng.wire_hops, eng.grad_reductions)
        counts = [mine]
        if eng.mesh.plan_group is not None:
            counts = [None] * len(ranks) if rank == ranks[0] else None
            dist.gather_object(mine, counts, dst=ranks[0],
                               group=eng.mesh.plan_group)
        if rank == ranks[0]:
            out[name] = {"sums": sums, "eval": {k: float(v)
                                                for k, v in ev.items()},
                         "params": tree["params"],
                         "momentum": tree["opt_state"]["momentum"],
                         "hops": [c[0] for c in counts],
                         "reductions": [c[1] for c in counts]}
        if opts.get("fsdp_shapes"):
            out[name, "shapes", rank] = {
                k: tuple(v.shape) for k, v in _flat_leaves(ts.params).items()}
    if "eptp" in payload:
        out["eptp", rank] = eptp_cases(rank, world, payload["eptp"])
    return out


def plan_ckpt_suite(rank, world, payload) -> dict:
    """Composed plans through both checkpoint formats, in order
    (`payload["ops"]`; each op's engine is built on every rank, its
    `key` naming (spec, optimizer) in `payload["engines"]`):

    * ("save", key, dir): the engine from the reference weights, one
      step, `save_sharded` of its `to_canonical_sharded` view with every
      collective of `torch.distributed` made to raise;
    * ("legacy", key, dir): the same, written by rank 0 in the legacy
      format (`to_canonical`);
    * ("restore", key, dir[, save_to]): the engine restored from `dir`
      (either format) through the unified reader, optionally saved again
      (sharded) to `save_to`, then one step;
    * ("cli", argv, dirs): `cli/lm.main(argv)` from this rank's dir.

    Returns rank 0's per-op record: the canonical tree (after the save's
    step, or right after the restore), the restore's (acc, epoch) and
    the step's sums; for "cli", every rank's files under its dir."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        build_plan_engine,
    )
    from distributed_model_parallel_tpu_torch.training import checkpoint
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        AdamW,
    )

    cfg = GPTConfig(**payload["gpt"])

    def engine(key):
        spec, opt = payload["engines"][key]
        return build_plan_engine(
            cfg, AdamW() if opt == "adamw" else SGD(*payload["sgd"]), spec,
            device="cpu")

    def step(eng, ts):
        ts, m = eng.train_step(ts, *eng.shard_batch(payload["ids"]),
                               payload["lr"])
        return ts, {k: float(v) for k, v in m.items()}

    def save(eng, ts, directory):
        view = eng.to_canonical_sharded(ts)
        saved = {}

        def refuse(*a, **k):
            raise AssertionError("a collective ran on the save path")

        for name in ("all_gather", "all_gather_into_tensor",
                     "all_gather_object", "gather_object", "broadcast",
                     "all_reduce"):
            saved[name] = getattr(dist, name)
            setattr(dist, name, refuse)
        try:
            checkpointing.save_sharded(directory, view, acc=3.0, epoch=1)
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
        dist.barrier()  # rank 0 committed the manifest

    out = []
    for op, key, directory, *rest in payload["ops"]:
        if op == "cli":
            from distributed_model_parallel_tpu_torch.cli import lm

            os.chdir(directory[rank])
            lm.main(key)
            files = sorted(str(p.relative_to(directory[rank]))
                           for p in Path(directory[rank]).rglob("*")
                           if p.is_file())
            got = [None] * world if rank == 0 else None
            dist.gather_object(files, got, dst=0)
            out.append({"files": got})
            continue
        eng = engine(key)
        if op in ("save", "legacy"):
            ts = eng.state_from_params(from_jax_params(payload["params"]))
            ts, sums = step(eng, ts)
            tree = eng.to_canonical(ts)
            if op == "save":
                save(eng, ts, directory)
            else:
                checkpoint.save_checkpoint(directory, tree, acc=3.0,
                                           epoch=1)
                dist.barrier()
            out.append({"canonical": tree, "sums": sums})
            continue
        like = eng.init_state(1)
        tree, acc, epoch = checkpointing.restore_checkpoint(
            directory, eng.canonical_spec(like))
        ts = eng.from_canonical(tree, like)
        before = eng.to_canonical(ts)
        if rest:
            save(eng, ts, rest[0])
        ts, sums = step(eng, ts)
        out.append({"canonical": before, "meta": (acc, epoch),
                    "sums": sums})
    return out if rank == 0 else None


def _record_rows(rec) -> list:
    """A recording's collectives as comparable rows."""
    return [(r.op, r.ranks, r.dtype, r.elems, r.scope)
            for r in rec.records]


def lint_records(rank, world, payload) -> dict:
    """The linter's combos (`analysis/lint.py`) on real gloo ranks
    (`tests/test_torch_port_analysis.py`): every rank builds and steps
    each combo of `payload["combos"]` (Combo keyword dicts, each spanning
    this world) under `recording()`; returns this rank's rows a combo."""
    from distributed_model_parallel_tpu_torch.analysis import lint

    out = {}
    for kw in payload["combos"]:
        combo = lint.Combo(**kw)
        _, rec, _ = lint.record_step(combo, "cpu")
        out[combo.name] = _record_rows(rec)
    return out


def fake_lint_records(combos) -> dict:
    """The same combos as rank 0 on the fake process group, in this
    process (which must have no process group)."""
    from distributed_model_parallel_tpu_torch.analysis import lint

    out = {}
    for kw in combos:
        combo = lint.Combo(**kw)
        _, rec, _ = lint.record_combo(combo, "cpu")
        out[combo.name] = _record_rows(rec)
    return out


def lint_sites() -> list:
    """Every call site (`path:line`) the recorder saw while the whole
    lint matrix, its self-test breaks and the drivers below ran, in this
    process (which must have no process group). The drivers reach the
    sites no combo steps through: the monolithic baselines the rings and
    the exchange replace, Ulysses' all-to-all, the checkpoint restore's
    broadcast, the tensor-parallel canonical gather and the sp serving
    layout's prefill and decode."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.analysis import lint
    from distributed_model_parallel_tpu_torch.analysis.record import (
        fake_world,
        recording,
    )
    from distributed_model_parallel_tpu_torch.models.bert import (
        bert_for_classification,
    )
    from distributed_model_parallel_tpu_torch.ops import collective_matmul \
        as cm
    from distributed_model_parallel_tpu_torch.ops import expert_dispatch \
        as xd
    from distributed_model_parallel_tpu_torch.ops.ring_attention import (
        ulysses_attention,
    )
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel \
        import TensorParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from distributed_model_parallel_tpu_torch.training import checkpoint
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    sites = set()

    def keep(rec):
        sites.update(r.site for r in rec.records)

    for combo in lint.full_matrix():
        keep(lint.record_combo(combo, "cpu")[1])
    for _, combo, brk, _ in lint_breaks():
        with brk():
            keep(lint.record_combo(combo, "cpu")[1])
    with fake_world(0, 2):
        world = dist.group.WORLD
        tp = TensorParallelEngine(
            bert_for_classification(4, lint._bert_cfg(2)), SGD(),
            make_mesh(MeshSpec(data=1, model=2)), device="cpu")
        ts = tp.init_state(0)
        serve = ServingEngine(lint._gpt_cfg(num_layers=1, num_heads=2),
                              make_mesh(MeshSpec(data=1, seq=2)),
                              layout="sp", num_slots=2, max_len=16,
                              prefill_len=8, device="cpu")
        params, cache = serve.init_params(0), serve.init_cache()
        ids = torch.ones((1, 8), dtype=torch.int64)
        with recording() as rec:
            x = torch.zeros((2, 4, 8))
            cm.naive_ag_matmul(x, torch.zeros((8, 4)), world)
            cm.naive_matmul_rs(x, torch.zeros((8, 4)), world)
            xd.flat_expert_return(xd.flat_expert_exchange(
                torch.zeros((4, 1, 2, 8)), world), world)
            q = torch.zeros((1, 4, 2, 8))
            ulysses_attention(q, q, q, group=world)
            checkpoint._broadcast_leaves({"a": np.ones(3, np.float32)},
                                         {"a": np.ones(3, np.float32)})
            tp.to_canonical(ts)
            serve.prefill(params, cache, ids, 5, 0)
            serve.decode_step(params, cache, torch.zeros(2, dtype=torch.int64),
                              torch.ones(2, dtype=torch.bool))
        keep(rec)
    return sorted(sites)

# ------------------------------------------------ the linter's breaks
#
# One deliberate contract break per family of the linter's pre-gate
# matrix (`analysis/lint.pregate_matrix`), each a patch of the port's
# own code for the length of a `with` block. `lint_self_test` lints each
# combo under its break, which must be named by the rule it violates
# (`tests/test_torch_port_analysis.py`; chip_smoke.py's phase 18 (b)
# runs it on the card).


@contextlib.contextmanager
def flat_moe_exchange():
    """The hierarchical MoE exchange forced to the flat all-to-all over
    the whole world (the exchange the two-level path replaces)."""
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.ops import (
        expert_dispatch as xd,
    )

    class _Flat(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, fwd, bwd):
            ctx.bwd = bwd
            return fwd(x, dist.group.WORLD)

        @staticmethod
        def backward(ctx, g):
            return ctx.bwd(g.contiguous(), dist.group.WORLD), None, None

    def flat(xin, w, ici, dcn=None, overlap=False, wire="none", dtype=None):
        z = _Flat.apply(xin, xd.flat_expert_exchange, xd.flat_expert_return)
        y = xd.expert_ffn(w, z, dtype)
        return _Flat.apply(y, xd.flat_expert_return, xd.flat_expert_exchange)

    with mock.patch.object(xd, "exchanged_expert_ffn", flat):
        yield


@contextlib.contextmanager
def monolithic_buckets():
    """Every gradient bucket all-reduced whole over the data fabric
    instead of its reduce-scatter / all-gather halves."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.ops import grad_reduction

    def chain(flat, ici_group, dcn_group, wire):
        dist.all_reduce(flat)
        return flat, None

    with mock.patch.object(grad_reduction, "_reduce_chain", chain):
        yield


@contextlib.contextmanager
def fsdp_replicated():
    """FSDP's at-rest policy made to shard nothing."""
    from distributed_model_parallel_tpu_torch.parallel import fsdp
    from distributed_model_parallel_tpu_torch.training.optim import tree_map

    def specs(tree, *args, **kwargs):
        return tree_map(lambda _: fsdp.P(), tree)

    with mock.patch.object(fsdp, "fsdp_specs", specs):
        yield


@contextlib.contextmanager
def uncoded_wire():
    """The cross-slice codec made to send f32 payloads (the int8 scale
    still riding beside them)."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import wire_codec

    def encode(wire, x):
        if wire == "int8":
            return x.float(), torch.ones((), device=x.device)
        return x, None

    with mock.patch.object(wire_codec, "wire_encode", encode):
        yield


@contextlib.contextmanager
def gathered_projection():
    """The decode rings' column projections replaced by one monolithic
    all-gather of the rows and a local product."""
    from distributed_model_parallel_tpu_torch.ops.collective_matmul import (
        _all_gather_rows,
    )
    from distributed_model_parallel_tpu_torch.serving import decode

    def column(self, h, w, b):
        t = h.shape[1]
        y = _all_gather_rows(h.reshape(-1, h.shape[-1]), self.group) @ w
        return (y + b.to(y.dtype)).reshape(-1, t, y.shape[-1])

    with mock.patch.object(decode.DecodeCollectiveMatmul, "column", column):
        yield


@contextlib.contextmanager
def world_plan_grad():
    """A composed plan's gradient reduction widened to the whole world
    (across the stage fabric)."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.parallel import plan

    make = plan.make_plan_mesh

    def widened(*args, **kwargs):
        return dataclasses.replace(make(*args, **kwargs),
                                   data_seq_group=dist.group.WORLD)

    with mock.patch.object(plan, "make_plan_mesh", widened):
        yield


def lint_breaks() -> list:
    """(family, combo, break, the rule that must name it) for each
    family of the linter's `pregate_matrix()`."""
    from distributed_model_parallel_tpu_torch.analysis import lint

    pre = lint.pregate_matrix()
    return [("ddp", pre[0], monolithic_buckets, "no-grad-all-reduce"),
            ("fsdp", pre[1], fsdp_replicated, "fsdp-at-rest-sharded"),
            ("ep", pre[2], flat_moe_exchange, "moe-hierarchical-a2a"),
            ("dcn_wire", pre[3], uncoded_wire, "dcn-compressed-payload"),
            ("serve", pre[4], gathered_projection, "serve-decode-ring"),
            ("speculative", pre[5], gathered_projection,
             "spec-verify-step"),
            ("plan", pre[6], world_plan_grad, "plan-grad-fabric")]


def lint_self_test(device: str) -> int:
    """Each family's break (`lint_breaks`) linted in this process (which
    must have no process group): prints one `{"self_test": ...}` line a
    family, with the rules it violated and whether the expected one is
    among them; returns 1 when a break went unnamed, else 0.

        python -c "import sys; sys.path.insert(0, 'tests');
            import _torch_port_ranks as r; sys.exit(r.lint_self_test('cpu'))"
    """
    import json

    from distributed_model_parallel_tpu_torch.analysis import lint

    out = []
    for family, combo, brk, want in lint_breaks():
        with brk():
            rep = lint.lint_combo(combo, device)
        named = sorted({f.rule for f in rep.errors})
        out.append({"family": family, "combo": combo.name,
                    "expected": want, "named": named,
                    "caught": want in named})
    for r in out:
        print(json.dumps({"self_test": r}), flush=True)
    return 0 if all(r["caught"] for r in out) else 1
