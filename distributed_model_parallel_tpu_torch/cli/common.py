"""Shared CLI pieces for `cli/serve.py`, `cli/lm.py` and
`cli/data_parallel.py` (port of `cli/common.py`).

The parsers carry the reference's whole flag surface, so a pasted
launch line fails with an explanation instead of an argparse error;
flags whose features belong to later port slices are refused loudly,
naming the slice (`check_serving_args`, `check_lm_args`,
`check_data_parallel_args`). The image side: `MODELS`, `build_model`,
`stats_for`, `build_loaders` (per-rank loaders from the global batch)
and `check_batch_divisibility`. `set_device_numerics` is the one place
the CLIs fix the card's f32 arithmetic.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np

from distributed_model_parallel_tpu_torch.data.datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    LATER_TYPES,
    DatasetCollection,
)
from distributed_model_parallel_tpu_torch.data.loader import Loader
from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
    mobilenet_v2,
    mobilenet_v2_nobn,
)
from distributed_model_parallel_tpu_torch.models.resnet import (
    resnet18,
    resnet50,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.runtime import dist
from distributed_model_parallel_tpu_torch.serving.engine import (
    BF16_SLICE,
    PAGED_SLICE,
    SPECULATIVE_SLICE,
    TP_SP_SLICE,
)


def add_grad_reduction_flags(parser: argparse.ArgumentParser) -> None:
    """The training engines' reducer flags, carried so a pasted launch
    line is refused with an explanation (`check_serving_args`: serving
    runs no backward; `check_lm_args`, `check_data_parallel_args`: not
    ported yet)."""
    parser.add_argument("--grad-reduction", default="monolithic",
                        choices=("monolithic", "bucketed", "overlapped"),
                        help="gradient-reduction flag; refused")
    parser.add_argument("--bucket-mb", default=None, type=float,
                        help="gradient-reduction flag; refused")
    parser.add_argument("--dcn-slices", default=1, type=int,
                        help="gradient-reduction flag; refused")
    parser.add_argument("--overlap-stages", default=None, type=int,
                        help="gradient-reduction flag; refused")
    parser.add_argument("--dcn-compression", default="none",
                        choices=("none", "bf16", "int8"),
                        help="gradient-reduction flag; refused")


def add_metrics_out_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="enable the metrics registry (observability/metrics.py) "
             "and write its JSON export here at exit. Fails fast if "
             "PATH's directory does not exist.",
    )


def set_device_numerics() -> None:
    """What every CLI sets where it picks its device, so that an f32 run
    on the card is the f32 path the tests hold: no TF32 in matmuls or
    cuDNN convolutions (torch leaves cuDNN's on by default), and cuDNN's
    deterministic algorithms, without autotuning (its f32 weight- and
    data-gradient algorithms otherwise sum in a different order from run
    to run). The flags are process-wide and settable on a CPU build."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _refuse(flag: str, later: str) -> SystemExit:
    return SystemExit(
        f"{flag} is not ported to the PyTorch package yet: it belongs to "
        f"{later} (ROADMAP.md) — drop the flag, or run the JAX package's "
        "cli/serve.py"
    )


def check_serving_args(args) -> None:
    """Startup-time validation of the serving CLI surface: reject
    training flags, out-of-slice flags and bad values before any engine
    is built."""
    if args.pipeline_stages != 1:
        raise SystemExit(
            "--pipeline-stages selects a TRAINING engine's stage wires; "
            "serving decodes token-by-token through one replica's "
            "layers — drop the flag"
        )
    if args.grad_reduction != "monolithic":
        raise SystemExit(
            "--grad-reduction configures the training engines' gradient "
            "collective; serving runs no backward — drop the flag"
        )
    if args.bucket_mb is not None:
        raise SystemExit(
            "--bucket-mb sizes gradient-reduction buckets; serving runs "
            "no backward — drop the flag"
        )
    if args.overlap_stages is not None:
        raise SystemExit(
            "--overlap-stages cuts the stagewise backward; serving runs "
            "no backward — drop the flag"
        )
    if args.dcn_slices != 1:
        raise SystemExit(
            "--dcn-slices factors the data axis for gradient traffic; "
            "serving has no 'dcn' axis — drop the flag"
        )
    if args.dcn_compression != "none":
        raise SystemExit(
            "--dcn-compression compresses the training engines' "
            "cross-slice hop; serving has no 'dcn' fabric — drop the flag"
        )
    # --- features of later port slices --------------------------------
    if args.layout != "replicated":
        raise _refuse(f"--layout {args.layout}", TP_SP_SLICE)
    if args.model_shards != 1 or args.seq_shards != 1:
        raise _refuse("--model-shards / --seq-shards", TP_SP_SLICE)
    if args.collective_matmul:
        raise _refuse("--collective-matmul", TP_SP_SLICE)
    for value, flag in ((args.page_size, "--page-size"),
                        (args.kv_pages, "--kv-pages"),
                        (args.prefill_chunk, "--prefill-chunk"),
                        (args.prefix_cache, "--prefix-cache")):
        if value:
            raise _refuse(flag, PAGED_SLICE)
    for value, flag in ((args.speculative_k, "--speculative-k"),
                        (args.speculative_draft, "--speculative-draft"),
                        (args.speculative_draft_layers,
                         "--speculative-draft-layers")):
        if value:
            raise _refuse(flag, SPECULATIVE_SLICE)
    if args.compute_dtype != "f32" and args.dtype != "float32":
        raise SystemExit(
            "--dtype and --compute-dtype both set the decode "
            "arithmetic; --dtype bfloat16 is the legacy spelling of "
            "--compute-dtype bf16 — pass only --compute-dtype"
        )
    if args.compute_dtype == "bf16" or args.dtype == "bfloat16":
        raise _refuse("bf16 decode (--compute-dtype bf16 / --dtype "
                      "bfloat16)", BF16_SLICE)
    # --- sampling knobs ----------------------------------------------
    if args.temperature < 0:
        raise SystemExit(
            f"--temperature must be >= 0, got {args.temperature}"
        )
    if args.top_k < 0:
        raise SystemExit(f"--top-k must be >= 0, got {args.top_k}")
    if not 0 < args.top_p <= 1:
        raise SystemExit(f"--top-p must be in (0, 1], got {args.top_p}")
    if args.temperature == 0 and (args.top_k or args.top_p < 1):
        raise SystemExit(
            "--top-k/--top-p filter a SAMPLING distribution; with the "
            "greedy default (--temperature 0) they would silently do "
            "nothing — set --temperature > 0"
        )
    # --- synthetic arrivals (Poisson offered load) -------------------
    if args.arrival_rate < 0:
        raise SystemExit(
            f"--arrival-rate must be >= 0 (0 = all requests arrive at "
            f"t=0), got {args.arrival_rate}"
        )
    if args.arrival_burst < 1:
        raise SystemExit(
            f"--arrival-burst must be >= 1, got {args.arrival_burst}"
        )
    if args.arrival_burst > 1 and not args.arrival_rate:
        raise SystemExit(
            "--arrival-burst groups Poisson arrival events into bursts; "
            "set --arrival-rate > 0 as well"
        )


def build_optimizer(args):
    """--optimizer flag -> optimizer instance. --wd is the decay strength
    of both; --momentum applies to sgd only."""
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        AdamW,
    )

    if args.optimizer == "adamw":
        return AdamW(weight_decay=args.weight_decay)
    return SGD(momentum=args.momentum, weight_decay=args.weight_decay)


def compute_dtype_from_flag(name: str):
    """--dtype flag value -> engine compute_dtype (None = pure f32)."""
    import torch

    return {"float32": None, "bfloat16": torch.bfloat16}[name]


def add_checkpoint_flags(parser: argparse.ArgumentParser) -> None:
    """The training CLIs' checkpoint flags. The sharded format and
    --async-save are carried so a reference launch line is refused with
    an explanation (`check_lm_args`, `check_data_parallel_args`)."""
    parser.add_argument("--checkpoint-dir", default="./checkpoint",
                        help="where the best-acc 'ckpt' (and 'last') "
                             "snapshots are written and --resume reads")
    parser.add_argument("--checkpoint-format", default="legacy",
                        choices=("legacy", "sharded"),
                        help="legacy = one .npz + .json sidecar (the JAX "
                             "package's format); sharded is not ported "
                             "yet (sharded-checkpoint slice)")
    parser.add_argument("--async-save", action="store_true",
                        help="not ported yet (sharded-checkpoint slice)")


def add_auto_tune_flags(parser: argparse.ArgumentParser) -> None:
    """The tuner's flags, carried so they are refused by name."""
    parser.add_argument("--auto-tune", default=None, metavar="PLAN|search",
                        help="not ported yet (auto-tuning slice)")
    parser.add_argument("--auto-tune-out", default=None, metavar="PATH",
                        help="not ported yet (auto-tuning slice)")
    parser.add_argument("--auto-tune-calibration", default=None,
                        metavar="JSON",
                        help="not ported yet (auto-tuning slice)")


# Later port slices named by the `check_*_args` refusals.
SLICES = {
    "plan": "the composed-parallel-plan slice",
    "tune": "the auto-tuning slice",
    "pipeline": "the pipeline slice",
    "seq": "the sequence-parallel slice",
    "moe": "the expert-parallel slice",
    "cm": "the collective-matmul slice",
    "reducer": "the gradient-reduction slice",
    "remat": "the activation-rematerialization slice",
    "sharded": "the sharded-checkpoint slice",
    "multistep": "the multi-step dispatch slice",
    "profile": "the profiler-capture slice",
    "fsdp": "the FSDP slice",
    "tp": "the tensor-parallel slice",
    "device_cache": "the device-cache slice",
    "elastic": "the elastic-restart slice",
    "transformer": "the transformer-classifier slice",
}


def check_lm_args(args) -> None:
    """Startup-time validation of the LM CLI surface: every flag whose
    feature belongs to a later port slice is refused, naming the slice,
    before any engine or corpus is built."""
    s = SLICES
    refusals = (
        ("--plan", args.plan, s["plan"]),
        ("--auto-tune / --auto-tune-out / --auto-tune-calibration",
         args.auto_tune or args.auto_tune_out or args.auto_tune_calibration,
         s["tune"]),
        ("--pipeline-stages > 1", args.pipeline_stages != 1, s["pipeline"]),
        ("--microbatches / --pipeline-schedule / --virtual-stages",
         args.microbatches != 1 or args.pipeline_schedule != "gpipe"
         or args.virtual_stages != 1, s["pipeline"]),
        ("--seq-shards > 1", args.seq_shards != 1, s["seq"]),
        ("--moe-experts > 0", args.moe_experts != 0, s["moe"]),
        ("--moe-every / --moe-dispatch / --moe-overlap / --expert-shards",
         args.moe_every != 2 or args.moe_dispatch != "gspmd"
         or args.moe_overlap or args.expert_shards != 1, s["moe"]),
        ("--collective-matmul", args.collective_matmul, s["cm"]),
        ("--grad-reduction / --bucket-mb / --dcn-slices / "
         "--overlap-stages / --dcn-compression",
         args.grad_reduction != "monolithic" or args.bucket_mb is not None
         or args.dcn_slices != 1 or args.overlap_stages is not None
         or args.dcn_compression != "none", s["reducer"]),
        ("--remat", args.remat, s["remat"]),
        ("--checkpoint-format sharded / --async-save",
         args.checkpoint_format != "legacy" or args.async_save,
         s["sharded"]),
        ("--steps-per-dispatch > 1", args.steps_per_dispatch != 1,
         s["multistep"]),
        ("--profile-dir", args.profile_dir, s["profile"]),
    )
    for flag, bad, later in refusals:
        if bad:
            raise SystemExit(
                f"{flag} is not ported to the PyTorch package yet: it "
                f"belongs to {later} (ROADMAP.md) — drop the flag, or run "
                "the JAX package's cli/lm.py"
            )


# ---------------------------------------------------------------- images

MODELS = {
    "mobilenetv2": mobilenet_v2,
    "mobilenetv2_nobn": mobilenet_v2_nobn,
    "resnet18": resnet18,
    "resnet50": resnet50,
    "tinycnn": tiny_cnn,
}
# Models of the reference's --model choices that later slices bring.
LATER_MODELS = ("bert", "bert_tiny", "vit")


def build_model(name: str, num_classes: int):
    if name in LATER_MODELS:
        raise SystemExit(
            f"--model {name} is not ported to the PyTorch package yet: it "
            f"belongs to {SLICES['transformer']} (ROADMAP.md)"
        )
    if name not in MODELS:
        raise SystemExit(f"unknown model {name!r}; choose from "
                         f"{sorted(MODELS)}")
    return MODELS[name](num_classes)


def stats_for(dataset_type: str) -> Tuple[np.ndarray, np.ndarray]:
    if dataset_type in ("CIFAR10", "Synthetic", "SyntheticTextures"):
        return CIFAR10_MEAN, CIFAR10_STD
    return IMAGENET_MEAN, IMAGENET_STD


def build_loaders(dataset_type: str, data_path: str, batch_size: int, *,
                  val_batch_size=None, augment: bool = True, seed: int = 0,
                  workers: int = 1, device_normalize: bool = False):
    """(train_loader, val_loader, num_classes) for this rank. `batch_size`
    and `val_batch_size` are GLOBAL batches (the reference's `-b 512` is
    512 in all, and lr 0.4 is tuned to it); each rank's Loader draws
    global / world samples a step from its own shard."""
    procs = dist.process_count()
    for label, b in (("", batch_size), ("val ", val_batch_size)):
        if b is not None and b % procs:
            raise SystemExit(f"global {label}batch size {b} must be "
                             f"divisible by the process count {procs}")
    train_ds, val_ds = DatasetCollection(dataset_type, data_path).init()
    mean, std = stats_for(dataset_type)
    rank = dict(process_index=dist.process_index(), process_count=procs,
                workers=workers, device_normalize=device_normalize,
                mean=mean, std=std)
    train = Loader(train_ds, batch_size=batch_size // procs, shuffle=True,
                   augment=augment, seed=seed, **rank)
    val = Loader(val_ds, batch_size=(val_batch_size or batch_size) // procs,
                 shuffle=False, augment=False, drop_last=False, **rank)
    return train, val, train_ds.num_classes


def check_batch_divisibility(global_batch: int, mesh, *,
                             label: str = "batch") -> None:
    """Fail at startup when the global batch does not split evenly over
    the mesh's data ranks."""
    if global_batch % mesh.data:
        raise SystemExit(
            f"{label} size {global_batch} must be divisible by the 'data' "
            f"mesh axis ({mesh.data} ranks)"
        )


def add_common_tpu_flags(parser: argparse.ArgumentParser) -> None:
    """The reference's shared training flags (its name kept): --model,
    --dtype, --remat, --optimizer, --profile-dir, --steps-per-epoch,
    --steps-per-dispatch, --log-file, --metrics-out."""
    parser.add_argument("--model", default="mobilenetv2",
                        choices=sorted((*MODELS, *LATER_MODELS)),
                        help="model family (the reference trains "
                             "MobileNetV2); bert, bert_tiny and vit are not "
                             "ported yet")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="activation dtype (parameters stay f32)")
    parser.add_argument("--remat", action="store_true",
                        help="not ported yet (activation-rematerialization "
                             "slice)")
    parser.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"),
                        help="sgd = the reference's SGD(momentum, wd); adamw "
                             "= decoupled-decay AdamW")
    parser.add_argument("--profile-dir", default=None,
                        help="not ported yet (profiler-capture slice)")
    parser.add_argument("--steps-per-epoch", default=0, type=int,
                        help="truncate each epoch to N batches (0 = full "
                             "epoch)")
    parser.add_argument("--steps-per-dispatch", default=1, type=int,
                        help="not ported yet (multi-step dispatch slice)")
    parser.add_argument("--log-file", default=None,
                        help="epoch log filename under ./log")
    add_metrics_out_flag(parser)


def check_data_parallel_args(args) -> None:
    """Startup-time validation of the data-parallel CLI surface: every
    flag whose feature belongs to a later port slice is refused, naming
    the slice, before any dataset, process group or engine is built."""
    s = SLICES
    refusals = (
        ("--engine fsdp", args.engine == "fsdp", s["fsdp"]),
        ("--engine tp / --model-shards", args.engine == "tp"
         or args.model_shards != 1, s["tp"]),
        ("--collective-matmul", args.collective_matmul, s["cm"]),
        ("--plan", args.plan, s["plan"]),
        ("--grad-reduction / --bucket-mb / --dcn-slices / "
         "--overlap-stages / --dcn-compression",
         args.grad_reduction != "monolithic" or args.bucket_mb is not None
         or args.dcn_slices != 1 or args.overlap_stages is not None
         or args.dcn_compression != "none", s["reducer"]),
        ("--device-cache", args.device_cache, s["device_cache"]),
        ("--checkpoint-format sharded / --async-save",
         args.checkpoint_format != "legacy" or args.async_save,
         s["sharded"]),
        ("--max-restarts", args.max_restarts != 0, s["elastic"]),
        ("--auto-tune / --auto-tune-out / --auto-tune-calibration",
         args.auto_tune or args.auto_tune_out or args.auto_tune_calibration,
         s["tune"]),
        ("--remat", args.remat, s["remat"]),
        ("--steps-per-dispatch > 1", args.steps_per_dispatch != 1,
         s["multistep"]),
        ("--profile-dir", args.profile_dir, s["profile"]),
        (f"--model {args.model}", args.model in LATER_MODELS,
         s["transformer"]),
    )
    for flag, bad, later in refusals:
        if bad:
            raise SystemExit(
                f"{flag} is not ported to the PyTorch package yet: it "
                f"belongs to {later} (ROADMAP.md) — drop the flag, or run "
                "the JAX package's cli/data_parallel.py"
            )
    if args.dataset_type in LATER_TYPES:
        raise SystemExit(
            f"--dataset-type {args.dataset_type} is not ported to the "
            f"PyTorch package yet: it belongs to "
            f"{LATER_TYPES[args.dataset_type]} (ROADMAP.md)"
        )
    if args.finetune:
        # Before any dataset or process group is built.
        if args.resume:
            raise SystemExit(
                "--finetune conflicts with --resume: resume restores the "
                "full training state; drop one of the flags")
        if args.model != "mobilenetv2":
            raise SystemExit(
                "--finetune supports the BN MobileNetV2 ('mobilenetv2'); "
                f"got --model {args.model}")
        if not os.path.exists(args.finetune):
            raise SystemExit(f"--finetune: no such file {args.finetune!r}")
    if args.sync_bn and args.engine != "ddp":
        raise SystemExit("--sync-bn selects SyncBatchNorm under --engine "
                         "ddp; --engine gspmd always normalizes over the "
                         "global batch")


def setup_metrics_out(path) -> None:
    """Validate + enable for `--metrics-out`, before anything runs."""
    if not path:
        return
    out_dir = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(out_dir):
        raise SystemExit(
            f"--metrics-out {path}: directory {out_dir} does not exist"
        )
    from distributed_model_parallel_tpu_torch.observability import metrics

    metrics.enable()


def export_metrics_out(path) -> None:
    if not path:
        return
    from distributed_model_parallel_tpu_torch.observability.metrics import (
        get_metrics,
    )

    get_metrics().export(path)
    print(f"==> wrote metrics to {path}", flush=True)


__all__ = [
    "MODELS",
    "SLICES",
    "add_common_tpu_flags",
    "add_auto_tune_flags",
    "add_checkpoint_flags",
    "add_grad_reduction_flags",
    "add_metrics_out_flag",
    "build_loaders",
    "build_model",
    "build_optimizer",
    "check_batch_divisibility",
    "check_data_parallel_args",
    "check_lm_args",
    "check_serving_args",
    "compute_dtype_from_flag",
    "export_metrics_out",
    "set_device_numerics",
    "setup_metrics_out",
    "stats_for",
]
