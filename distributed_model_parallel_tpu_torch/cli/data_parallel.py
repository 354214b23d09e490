"""Data-parallel CIFAR-10 training (port of `cli/data_parallel.py`, the
reference repo's own subject): MobileNetV2 (CIFAR variant) at the
reference's global batch 512, lr 0.4, SGD(momentum 0.9, wd 1e-4),
cosine LR with linear warmup, a txt epoch log.

One process per GPU over `torch.distributed` (NCCL; gloo on the CPU):

  python -m distributed_model_parallel_tpu_torch.cli.data_parallel \\
      --dataset-type SyntheticTextures --engine ddp     # one GPU
  torchrun --nproc-per-node 2 -m \\
      distributed_model_parallel_tpu_torch.cli.data_parallel \\
      --device cpu --model tinycnn --dataset-type Synthetic  # 2 gloo ranks

`-b` is the GLOBAL batch, divided by the world; each rank's loader
draws from its own shard. The best-val-acc model is saved to
`--checkpoint-dir` (`ckpt.npz` + `ckpt.json`, the JAX package's
format) and `--resume` continues from it; `--finetune CKPT` starts
MobileNetV2 from a reference-format torch checkpoint
(`models/torch_import.py`). `--engine gspmd` (the default) is the
global-batch step (BN over the whole batch); `--engine ddp` is per-rank
BN, or SyncBN with `--sync-bn`. `--device` (cuda, the default, or cpu)
is the port's addition. `--model vit` (CIFAR-scale ViT) trains on the
image datasets, `--model bert|bert_tiny` on `-type SyntheticText` (token
ids, shipped raw); `--remat` checkpoints each block, `--steps-per-
dispatch N` replays a CUDA graph of the train (and eval) step N times a
dispatch on the card, `--profile-dir` writes a torch.profiler trace and
`--metrics-out x.prom` Prometheus text (JSON for any other name).
`--engine ddp --grad-reduction bucketed|overlapped` reduces the
gradients through DDP's bucketed Reducer (`--bucket-mb`, `--overlap-
stages`); `--dcn-slices K` factors the ranks into K slices and makes the
reduction hierarchical, `--dcn-compression bf16|int8` compresses its
cross-slice hop. `--engine tp --model-shards M` (bert, bert_tiny, vit)
is Megatron tensor parallelism over M consecutive ranks
(`parallel/tensor_parallel.py`), the world being world / M data ranks,
and `--collective-matmul` runs its projections on the latency-hiding
rings (`ops/collective_matmul.py`, Megatron-SP between blocks);
`--device-cache` uploads the train and val images to the device once
and ships only index vectors (`data/device_cache.py`), under every
engine; `-type Imagenet|Place365|CUB200` reads an image tree under
`--data`. `--engine fsdp` shards parameters and optimizer state 1/N over
the ranks (`parallel/fsdp.py`, ZeRO-3; `--grad-reduction` and
`--dcn-compression` as under ddp). `--checkpoint-format sharded` has
every rank write its own chunks (`checkpointing/`, a filesystem all the
ranks share), `--async-save` writes them from a background thread, and
`--resume` reads either format at any rank count. `--max-restarts R`
runs the trainer under `training/elastic.elastic_fit`: a per-epoch
`last` checkpoint, and up to R restarts from it after a failure.
`--plan dpN|fsdpN` is the reference's degenerate plan spelling of
`--engine ddp|fsdp` on an N-rank world (`cli/common.
check_data_parallel_plan`). The parser keeps the reference's whole flag
surface; flags whose features belong to later port slices are refused
with the slice named (`cli/common.check_data_parallel_args`).
"""

from __future__ import annotations

import argparse

import torch

from distributed_model_parallel_tpu_torch.cli.common import (
    add_auto_tune_flags,
    add_checkpoint_flags,
    add_common_tpu_flags,
    add_grad_reduction_flags,
    build_index_loaders,
    build_loaders,
    build_model,
    build_optimizer,
    check_batch_divisibility,
    check_data_parallel_args,
    compute_dtype_from_flag,
    export_metrics_out,
    reducer_mesh,
    set_device_numerics,
    setup_metrics_out,
    stats_for,
)
from distributed_model_parallel_tpu_torch.data.loader import device_normalizer
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.parallel.fsdp import FSDPEngine
from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
    TensorParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.dist import (
    initialize_backend,
    is_primary,
    process_count,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    MeshSpec,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch CIFAR10 Training")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model trains (default cuda, one GPU per "
                        "rank; cpu trains on gloo ranks)")
    p.add_argument("--dist-url", default=None, metavar="tcp://HOST:PORT",
                   help="rendezvous of the ranks (default: torchrun's "
                        "MASTER_ADDR/MASTER_PORT, or a free local port "
                        "for one rank)")
    p.add_argument("--lr", default=0.4, type=float, help="learning rate")
    p.add_argument("--resume", "-r", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--finetune", default=None, metavar="CKPT",
                   help="start MobileNetV2 from a reference-format torch "
                        "checkpoint (.pth/.pt, or .npz); a head of "
                        "another class count is left fresh")
    p.add_argument("-b", "--batch-size", default=512, type=int,
                   help="global batch size (reference: 512)")
    p.add_argument("--val-batch-size", default=1000, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("-type", "--dataset-type", default="CIFAR10",
                   dest="dataset_type",
                   help="CIFAR10 (from --data, or synthetic data of its "
                        "shapes when absent), Synthetic, SyntheticTextures, "
                        "SyntheticText (token ids, for bert / bert_tiny)")
    p.add_argument("--data", default="./data", help="dataset path")
    p.add_argument("--wd", "--weight-decay", default=1e-4, type=float,
                   dest="weight_decay")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("-j", "--workers", default=1, type=int,
                   help="native augmentation thread-pool size")
    p.add_argument("--engine", default="gspmd",
                   choices=("gspmd", "ddp", "fsdp", "tp"),
                   help="gspmd: global-batch BN (nn.DataParallel with "
                        "SyncBN semantics); ddp: explicit gradient "
                        "all-reduce, per-rank BN or --sync-bn; tp: "
                        "Megatron tensor parallelism over --model-shards "
                        "ranks (bert, bert_tiny, vit); fsdp: parameters "
                        "and optimizer state sharded 1/N over the ranks "
                        "(ZeRO-3)")
    p.add_argument("--model-shards", default=1, type=int,
                   help="'model' mesh axis size under --engine tp: each "
                        "group of this many consecutive ranks shards the "
                        "Megatron projections (must divide the heads and "
                        "the FFN width)")
    p.add_argument("--collective-matmul", action="store_true",
                   help="--engine tp: run the Megatron projections as "
                        "latency-hiding rings over the 'model' axis, the "
                        "residual stream sequence-sharded between blocks "
                        "(Megatron-SP; same math)")
    p.add_argument("--plan", default=None, metavar="SPEC",
                   help="degenerate ParallelPlan spec for the image "
                        "engines (dpN / fsdpN): the declarative spelling "
                        "of --engine ddp/fsdp on an N-rank data world; "
                        "pp/sp/ep tokens are the LM CLI's surface "
                        "(cli/lm.py --plan)")
    add_grad_reduction_flags(p)
    add_checkpoint_flags(p)
    add_auto_tune_flags(p)
    p.add_argument("--max-restarts", default=0, type=int,
                   help="fail-fast elastic mode: restart from the "
                        "per-epoch checkpoint up to N times on failure "
                        "(0 = off)")
    p.add_argument("--sync-bn", action="store_true",
                   help="SyncBatchNorm under --engine ddp")
    p.add_argument("--device-normalize", action="store_true",
                   help="ship uint8 batches and normalize on the device "
                        "(4x fewer host-to-device bytes; same math)")
    p.add_argument("--device-cache", action="store_true",
                   help="upload the train and val images to the device "
                        "once; each step ships only its index vector and "
                        "the gather, crop/flip and normalize run on the "
                        "device")
    add_common_tpu_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    plan = check_data_parallel_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to train on the CPU"
        )
    setup_metrics_out(args.metrics_out)
    device = initialize_backend(args.device, args.dist_url)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if plan is not None and plan.num_devices != world:
        raise SystemExit(
            f"--plan {plan.spec} factors {plan.num_devices} "
            f"device(s); this world has {world} — "
            "respell the plan's data axis")
    set_device_numerics()
    if args.engine == "tp":
        try:
            mesh = make_mesh(MeshSpec(data=-1, model=args.model_shards))
        except ValueError as e:
            raise SystemExit(f"--model-shards {args.model_shards}: {e}") \
                from e
    else:
        mesh = reducer_mesh(args.dcn_slices)
    check_batch_divisibility(args.batch_size, mesh)
    check_batch_divisibility(args.val_batch_size, mesh, label="val batch")
    # Each data rank's shard (the model ranks of a data index share it).
    shard = (mesh.data_index, mesh.data)
    if args.device_cache:
        train, val, num_classes, itf = build_index_loaders(
            args.dataset_type, args.data, args.batch_size, device,
            val_batch_size=args.val_batch_size, shard=shard)
    else:
        train, val, num_classes = build_loaders(
            args.dataset_type, args.data, args.batch_size,
            val_batch_size=args.val_batch_size, workers=args.workers,
            device_normalize=args.device_normalize, shard=shard)
        itf = (device_normalizer(*stats_for(args.dataset_type))
               if args.device_normalize else None)
    common = dict(mesh=mesh, compute_dtype=compute_dtype_from_flag(args.dtype),
                  input_transform=itf, device=device)
    model = build_model(args.model, num_classes, remat=args.remat)
    if args.engine == "tp":
        engine = TensorParallelEngine(
            model, build_optimizer(args),
            collective_matmul=args.collective_matmul, **common)
    elif args.engine in ("ddp", "fsdp"):
        reduction = dict(grad_reduction=args.grad_reduction,
                         bucket_mb=args.bucket_mb,
                         overlap_stages=args.overlap_stages,
                         dcn_compression=args.dcn_compression, **common)
        engine = (FSDPEngine(model, build_optimizer(args), **reduction)
                  if args.engine == "fsdp" else
                  DDPEngine(model, build_optimizer(args),
                            sync_bn=args.sync_bn, **reduction))
    else:
        engine = DataParallelEngine(model, build_optimizer(args), **common)
    if is_primary():
        print(f"==> {args.engine} on {mesh.data} rank(s) of {device.type} "
              f"({torch.distributed.get_backend()}); checkpoints in "
              f"{args.checkpoint_dir}", flush=True)
        if args.engine == "tp":
            print(f"==> tensor parallel: {mesh.data} data x {mesh.model} "
                  "model rank(s)", flush=True)
        if args.engine == "fsdp":
            print(f"==> fsdp: parameters and optimizer state sharded over "
                  f"{mesh.data} data rank(s)", flush=True)
        if args.device_cache:
            print(f"==> device cache: {itf.cache.nbytes} bytes of images "
                  f"on {device}", flush=True)
        if args.grad_reduction != "monolithic" or mesh.dcn > 1:
            print(f"==> grad reduction {args.grad_reduction} "
                  f"(bucket {args.bucket_mb} MB) over {mesh.dcn} slice(s) "
                  f"x {mesh.ici}, dcn wire {args.dcn_compression}",
                  flush=True)
    checkpoint_dir = args.checkpoint_dir

    def restart_can_resume() -> bool:
        """Rank 0's answer on every rank: with per-rank disks the ranks
        must agree on resuming, or they part ways in the restore's
        broadcast."""
        from distributed_model_parallel_tpu_torch.training.checkpoint import (
            latest_exists,
        )

        exists = [latest_exists(checkpoint_dir, "last")
                  or latest_exists(checkpoint_dir)]
        if process_count() > 1:
            torch.distributed.broadcast_object_list(exists, src=0)
        return bool(exists[0])

    def make_trainer(restart: bool) -> Trainer:
        resume = args.resume or (restart and restart_can_resume())
        cfg = TrainerConfig(
            epochs=args.epochs,
            base_lr=args.lr,
            t_max=90,
            warmup_period=10,
            log_file=args.log_file or f"data_para_{args.batch_size}.txt",
            checkpoint_dir=checkpoint_dir,
            resume=resume,
            steps_per_epoch=args.steps_per_epoch,
            steps_per_dispatch=args.steps_per_dispatch,
            profile_dir=args.profile_dir,
            save_last=args.max_restarts > 0,
            checkpoint_format=args.checkpoint_format,
            async_save=args.async_save,
        )
        trainer = Trainer(engine, train, val, cfg, seed=0)
        if args.finetune and not resume:
            from distributed_model_parallel_tpu_torch.models.torch_import \
                import load_torch_checkpoint, mobilenetv2_from_torch_state_dict

            # The full trees as the template (FSDP's state holds shards);
            # state_from_params places them in the engine's layout.
            params, model_state = mobilenetv2_from_torch_state_dict(
                *model.init(torch.Generator().manual_seed(0)),
                load_torch_checkpoint(args.finetune))
            trainer.state = engine.state_from_params(params, model_state)
            if is_primary():
                print(f"==> Transplanted torch weights from {args.finetune}",
                      flush=True)
        return trainer

    if args.max_restarts > 0:
        from distributed_model_parallel_tpu_torch.training.elastic import (
            elastic_fit,
        )

        out = elastic_fit(make_trainer, max_restarts=args.max_restarts,
                          checkpoint_dir=checkpoint_dir)
    else:
        out = make_trainer(False).fit()
    if is_primary():
        export_metrics_out(args.metrics_out)
    return out


if __name__ == "__main__":
    main()
