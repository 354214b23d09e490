"""Pipeline model-parallel CIFAR-10 training (port of
`cli/model_parallel.py`, the reference's other entry point): MobileNetV2
split into `--world-size` pipeline stages, the reference's global batch
512, lr 0.4, SGD(momentum 0.9, wd 1e-4), cosine LR with linear warmup,
a txt epoch log, and the best-val-acc model saved to `./checkpoint` (the
JAX package's format; this CLI has no --resume, as neither the
reference's nor the JAX package's has):

  python -m distributed_model_parallel_tpu_torch.cli.model_parallel \\
      ./data -type SyntheticTextures --world-size 4 --reference-split \\
      --microbatches 8 --pipeline-schedule 1f1b        # one GPU
  python -m distributed_model_parallel_tpu_torch.cli.model_parallel \\
      ./data --device cpu --model tinycnn -type Synthetic \\
      --world-size 2 --microbatches 2 -b 64 --epochs 1 --steps-per-epoch 8

One process drives every stage (`parallel/pipeline.py`); stage s runs on
the process's device s mod the device count (one GPU: all of them on
it). Under `torchrun` each rank is a data replica of the whole pipeline
(`--dist-backend` xla or nccl: NCCL on the GPU, gloo on the CPU,
`runtime/dist.py`). `-b` is the global batch. The reference's flags, the
JAX package's additions (`--microbatches`, `--pipeline-schedule`,
`--virtual-stages`, `--reference-split`, `--stage-local-params`) and the
shared training flags are kept; `--device` (cuda, the default, or cpu)
is the port's addition. `--remat` checkpoints each chunk,
`--steps-per-dispatch N` replays a CUDA graph of the step N times a
dispatch while the stages share one device (more than one device is
refused, ROADMAP.md §A.7), `--profile-dir` writes a torch.profiler
trace. `--model bert|bert_tiny` pipelines the BERT classifier on
`-type SyntheticText`. Flags of later port slices are refused with the
slice named (`cli/common.check_model_parallel_args`).
"""

from __future__ import annotations

import argparse

import torch

from distributed_model_parallel_tpu_torch.cli.common import (
    add_common_tpu_flags,
    build_loaders,
    build_optimizer,
    build_stages,
    check_batch_divisibility,
    check_model_parallel_args,
    compute_dtype_from_flag,
    export_metrics_out,
    refuse_uncapturable,
    set_device_numerics,
    setup_metrics_out,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.runtime.dist import (
    initialize_backend,
    is_primary,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    MeshSpec,
    local_devices,
    make_mesh,
)
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch Pipeline Training")
    # -- the reference's flags (`model_parallel.py:15-42`) ---------------
    p.add_argument("data", metavar="DIR", help="path to dataset")
    p.add_argument("--dist-url", default=None, metavar="tcp://HOST:PORT",
                   help="rendezvous of the data ranks (default: torchrun's "
                        "MASTER_ADDR/MASTER_PORT, or a free local port for "
                        "one rank)")
    p.add_argument("--world-size", default=1, type=int,
                   help="number of pipeline stages (reference: number of "
                        "ranks)")
    p.add_argument("--dist-backend", default="xla", choices=("xla", "nccl"),
                   help="accepted for launch-line compatibility: the "
                        "backend is NCCL on the GPU, gloo on the CPU")
    p.add_argument("--lr", "--learning-rate", default=0.4, type=float,
                   dest="lr")
    p.add_argument("--epochs", default=90, type=int)
    p.add_argument("-type", "--dataset-type", default="Imagenet",
                   dest="dataset_type",
                   help="CIFAR10 (from DIR, or synthetic data of its "
                        "shapes when absent), Synthetic, SyntheticTextures")
    p.add_argument("-b", "--batch-size", default=512, type=int,
                   help="global batch size (reference: 512)")
    p.add_argument("-j", "--workers", default=12, type=int,
                   help="native augmentation thread-pool size")
    p.add_argument("--wd", "--weight-decay", default=1e-4, type=float,
                   dest="weight_decay")
    p.add_argument("--momentum", default=0.9, type=float)
    # -- the JAX package's additions ---------------------------------
    p.add_argument("--microbatches", default=1, type=int,
                   help="pipeline microbatches in flight; 1 = the "
                        "reference's single-batch schedule")
    p.add_argument("--pipeline-schedule", default="gpipe",
                   choices=("gpipe", "1f1b", "interleaved"),
                   help="gpipe = fill-drain (O(M) live activations); 1f1b "
                        "= one-forward-one-backward, the same step with "
                        "O(S) live activations; interleaved = Megatron's "
                        "virtual pipeline (with --virtual-stages V)")
    p.add_argument("--virtual-stages", default=1, type=int,
                   help="model chunks per stage (interleaved schedule): "
                        "stage s owns chunks s, s+S, ...; needs "
                        "--microbatches divisible by --world-size")
    p.add_argument("--reference-split", action="store_true",
                   help="the reference's ws=4 stage boundaries [3, 9, 15] "
                        "(--world-size 4, MobileNetV2)")
    p.add_argument("--stage-local-params", action="store_true",
                   help="accepted: each stage's parameters and optimizer "
                        "state always live on its own device")
    # -- the port's addition -----------------------------------------
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the stages run (default cuda; cpu runs them "
                        "on gloo ranks)")
    add_common_tpu_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_model_parallel_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to train on the CPU"
        )
    setup_metrics_out(args.metrics_out)
    device = initialize_backend(args.device, args.dist_url)
    set_device_numerics()
    mesh = make_mesh(MeshSpec(data=-1, stage=args.world_size),
                     devices=local_devices(device.type))
    check_batch_divisibility(args.batch_size, mesh,
                             microbatches=args.microbatches)
    train, val, num_classes = build_loaders(
        args.dataset_type, args.data, args.batch_size, workers=args.workers)
    engine = PipelineEngine(
        build_stages(args.model, args.world_size, num_classes,
                     args.reference_split, args.virtual_stages),
        build_optimizer(args), mesh,
        num_microbatches=args.microbatches,
        compute_dtype=compute_dtype_from_flag(args.dtype),
        stage_local_params=args.stage_local_params,
        remat=args.remat,
        schedule=args.pipeline_schedule,
        virtual_stages=args.virtual_stages,
    )
    refuse_uncapturable(engine, args.steps_per_dispatch)
    if is_primary():
        print(f"==> pipeline {args.pipeline_schedule}: {args.world_size} "
              f"stage(s) x {args.virtual_stages} chunk(s), "
              f"{args.microbatches} microbatch(es), on "
              f"{', '.join(map(str, mesh.devices))}; "
              f"{mesh.data} data rank(s) "
              f"({torch.distributed.get_backend()})", flush=True)
    cfg = TrainerConfig(
        epochs=args.epochs,
        base_lr=args.lr,
        t_max=90,
        warmup_period=10,
        log_file=args.log_file or f"{args.batch_size}.txt",
        steps_per_epoch=args.steps_per_epoch,
        steps_per_dispatch=args.steps_per_dispatch,
        profile_dir=args.profile_dir,
    )
    out = Trainer(engine, train, val, cfg, seed=0).fit()
    if is_primary():
        export_metrics_out(args.metrics_out)
    return out


if __name__ == "__main__":
    main()
