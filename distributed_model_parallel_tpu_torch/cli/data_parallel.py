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
is the port's addition. The parser keeps the reference's whole flag
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
    build_loaders,
    build_model,
    build_optimizer,
    check_batch_divisibility,
    check_data_parallel_args,
    compute_dtype_from_flag,
    export_metrics_out,
    set_device_numerics,
    setup_metrics_out,
    stats_for,
)
from distributed_model_parallel_tpu_torch.data.loader import device_normalizer
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.runtime.dist import (
    initialize_backend,
    is_primary,
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
                        "shapes when absent), Synthetic, SyntheticTextures")
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
                        "all-reduce, per-rank BN or --sync-bn; fsdp, tp: "
                        "not ported yet")
    p.add_argument("--model-shards", default=1, type=int,
                   help="not ported yet (tensor-parallel slice)")
    p.add_argument("--collective-matmul", action="store_true",
                   help="not ported yet (collective-matmul slice)")
    p.add_argument("--plan", default=None, metavar="SPEC",
                   help="not ported yet (composed-parallel-plan slice)")
    add_grad_reduction_flags(p)
    add_checkpoint_flags(p)
    add_auto_tune_flags(p)
    p.add_argument("--max-restarts", default=0, type=int,
                   help="not ported yet (elastic-restart slice)")
    p.add_argument("--sync-bn", action="store_true",
                   help="SyncBatchNorm under --engine ddp")
    p.add_argument("--device-normalize", action="store_true",
                   help="ship uint8 batches and normalize on the device "
                        "(4x fewer host-to-device bytes; same math)")
    p.add_argument("--device-cache", action="store_true",
                   help="not ported yet (device-cache slice)")
    add_common_tpu_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_data_parallel_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to train on the CPU"
        )
    setup_metrics_out(args.metrics_out)
    device = initialize_backend(args.device, args.dist_url)
    set_device_numerics()
    mesh = make_mesh(MeshSpec(data=-1))
    check_batch_divisibility(args.batch_size, mesh)
    check_batch_divisibility(args.val_batch_size, mesh, label="val batch")
    train, val, num_classes = build_loaders(
        args.dataset_type, args.data, args.batch_size,
        val_batch_size=args.val_batch_size, workers=args.workers,
        device_normalize=args.device_normalize,
    )
    itf = (device_normalizer(*stats_for(args.dataset_type))
           if args.device_normalize else None)
    common = dict(mesh=mesh, compute_dtype=compute_dtype_from_flag(args.dtype),
                  input_transform=itf, device=device)
    model = build_model(args.model, num_classes)
    if args.engine == "ddp":
        engine = DDPEngine(model, build_optimizer(args), sync_bn=args.sync_bn,
                           **common)
    else:
        engine = DataParallelEngine(model, build_optimizer(args), **common)
    if is_primary():
        print(f"==> {args.engine} on {mesh.data} rank(s) of {device.type} "
              f"({torch.distributed.get_backend()}); checkpoints in "
              f"{args.checkpoint_dir}", flush=True)
    cfg = TrainerConfig(
        epochs=args.epochs,
        base_lr=args.lr,
        t_max=90,
        warmup_period=10,
        log_file=args.log_file or f"data_para_{args.batch_size}.txt",
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        steps_per_epoch=args.steps_per_epoch,
    )
    trainer = Trainer(engine, train, val, cfg, seed=0)
    if args.finetune:
        from distributed_model_parallel_tpu_torch.models.torch_import import (
            load_torch_checkpoint,
            mobilenetv2_from_torch_state_dict,
        )

        params, model_state = mobilenetv2_from_torch_state_dict(
            trainer.state.params, trainer.state.model_state,
            load_torch_checkpoint(args.finetune))
        trainer.state = engine.state_from_params(params, model_state)
        if is_primary():
            print(f"==> Transplanted torch weights from {args.finetune}",
                  flush=True)
    out = trainer.fit()
    if is_primary():
        export_metrics_out(args.metrics_out)
    return out


if __name__ == "__main__":
    main()
