#!/usr/bin/env python3
"""Validation accuracy of the port's data-parallel engines against the
JAX package's, at the RESULTS.md section 2b budget, on the CPU.

Section 2b (`experiments/compare_engines.py`, recorded in
`experiments/results_textures.json`) trains tinycnn on SyntheticTextures
(50,000 train / 10,000 val images, 32x32x3, 10 classes) at global batch
256 for 3 epochs of 24 steps, SGD(0.9, 1e-4), lr 0.1 with a 3-epoch
cosine and 2-epoch warmup, the train loader augmenting, and validates
on all 10,000 val images after each epoch. The reference ran on 8
devices: `DataParallelEngine` (BN over the global batch) and
`DDPEngine` (per-replica BN, 32 images a replica).

Printed, one JSON line each, every epoch's train loss / acc1 and val
loss / acc1:
* `gspmd`, for each seed: the JAX engine on one CPU device (its init
  from `PRNGKey(seed)`), the port's engine from its own init
  (`init_state(seed)`), and the port's engine from the JAX init carried
  across by `models/convert.from_jax_params`;
* `ddp`: the port's `DDPEngine` on 8 gloo ranks (per-replica BN over 8
  replicas, as the reference's), seed 0, beside the recorded reference.

    python3 dp_val_check.py            # about 6 min on the CPU, 8 processes

It imports both packages, as the parity tests do; the port itself never
imports JAX, and the port's ranks import only the port.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(REPO, "experiments", "results_textures.json")
SEEDS = (0, 1, 2)
DDP_RANKS = 8
# compare_engines.py's TrainerConfig fields (checkpoints off)
TRAINER = dict(epochs=3, base_lr=0.1, t_max=3, warmup_period=2, print_freq=0,
               save_best=False, steps_per_epoch=24)


def epochs(history) -> list:
    return [{"train_loss": e["train"]["loss"], "train_acc1": e["train"]["acc1"],
             "val_loss": e["val"]["loss"], "val_acc1": e["val"]["acc1"],
             "val_count": e["val"]["count"]} for e in history]


def port_fit(engine: str, seed: int, init=None) -> list:
    """The port's engine through its Trainer, in this process's world;
    `init` = (params, model_state) replaces the engine's own init."""
    from distributed_model_parallel_tpu_torch.cli.common import (
        build_loaders,
    )
    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import make_mesh
    from distributed_model_parallel_tpu_torch.training.optim import SGD
    from distributed_model_parallel_tpu_torch.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    train, val, num_classes = build_loaders("SyntheticTextures", "./data",
                                            256)
    cls = DataParallelEngine if engine == "gspmd" else DDPEngine
    eng = cls(tiny_cnn(num_classes), SGD(), mesh=make_mesh(), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(eng, train, val,
                          TrainerConfig(log_dir=tmp, **TRAINER), seed=seed)
        if init is not None:
            trainer.state = eng.state_from_params(*init)
        return epochs(trainer.fit()["history"])


def jax_fit(seed: int):
    """The JAX DataParallelEngine on one CPU device: (epochs, its init
    as numpy trees)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np

    from distributed_model_parallel_tpu.cli.common import build_loaders
    from distributed_model_parallel_tpu.models import tiny_cnn
    from distributed_model_parallel_tpu.parallel.data_parallel import (
        DataParallelEngine,
    )
    from distributed_model_parallel_tpu.runtime.mesh import MeshSpec, make_mesh
    from distributed_model_parallel_tpu.training.optim import SGD
    from distributed_model_parallel_tpu.training.trainer import (
        Trainer,
        TrainerConfig,
    )

    jax.config.update("jax_default_matmul_precision", "highest")
    train, val, num_classes = build_loaders("SyntheticTextures", "./data",
                                            256)
    eng = DataParallelEngine(tiny_cnn(num_classes), SGD(),
                             make_mesh(MeshSpec(data=1),
                                       devices=jax.devices()[:1]))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(eng, train, val,
                          TrainerConfig(log_dir=tmp, **TRAINER),
                          rng=jax.random.PRNGKey(seed))
        init = jax.tree.map(np.asarray, (trainer.state.params,
                                         trainer.state.model_state))
        return epochs(trainer.fit()["history"]), init


def ddp_rank(rank: int, world: int, url: str, out: str) -> None:
    import torch

    from distributed_model_parallel_tpu_torch.runtime.dist import (
        initialize_backend,
    )

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    initialize_backend("cpu", url)
    hist = port_fit("ddp", 0)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(hist, f)
    torch.distributed.destroy_process_group()


def ddp_ranks() -> list:
    from distributed_model_parallel_tpu_torch.runtime.dist import free_port

    url = f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        procs = [ctx.Process(target=ddp_rank, args=(r, DDP_RANKS, url, out))
                 for r in range(DDP_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(3600)
        codes = [p.exitcode for p in procs]
        if codes != [0] * DDP_RANKS:
            raise RuntimeError(f"ddp: rank exit codes {codes}")
        with open(out, "rb") as f:
            return pickle.load(f)


def main() -> int:
    from distributed_model_parallel_tpu_torch.models.convert import (
        from_jax_params,
    )
    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn

    with open(REFERENCE) as f:
        recorded = json.load(f)["results"]
    for seed in SEEDS:
        t0 = time.perf_counter()
        jax_epochs, (params, state) = jax_fit(seed)
        init = from_jax_params(params, model=tiny_cnn(10), state=state)
        print(json.dumps({
            "engine": "gspmd", "seed": seed, "jax": jax_epochs,
            "port": port_fit("gspmd", seed),
            "port_from_jax_init": port_fit("gspmd", seed, init),
            "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"engine": "ddp", "ranks": DDP_RANKS, "seed": 0,
                      "port": ddp_ranks(),
                      "reference_recorded": epochs(
                          recorded["ddp"]["history"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
