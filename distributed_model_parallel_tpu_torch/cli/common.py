"""Shared CLI pieces for `cli/serve.py` and `cli/lm.py` (port of the
serving and LM parts of `cli/common.py`).

Both parsers carry the reference's whole flag surface, so a pasted
launch line fails with an explanation instead of an argparse error;
flags whose features belong to later port slices are refused loudly,
naming the slice (`check_serving_args`, `check_lm_args`).
"""

from __future__ import annotations

import argparse
import os

from distributed_model_parallel_tpu_torch.serving.engine import (
    BF16_SLICE,
    PAGED_SLICE,
    SPECULATIVE_SLICE,
    TP_SP_SLICE,
)


def add_grad_reduction_flags(parser: argparse.ArgumentParser) -> None:
    """The training engines' reducer flags, carried so a pasted launch
    line is refused with an explanation (`check_serving_args`: serving
    runs no backward; `check_lm_args`: not ported yet)."""
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
    if args.checkpoint:
        raise _refuse("--checkpoint", "the checkpointing slice")
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
    """The training CLIs' checkpoint flags, carried so a reference launch
    line is refused with an explanation (`check_lm_args`)."""
    parser.add_argument("--checkpoint-dir", default="./checkpoint",
                        help="not ported yet (checkpointing slice)")
    parser.add_argument("--checkpoint-format", default="legacy",
                        choices=("legacy", "sharded"),
                        help="not ported yet (checkpointing slice)")
    parser.add_argument("--async-save", action="store_true",
                        help="not ported yet (checkpointing slice)")


def add_auto_tune_flags(parser: argparse.ArgumentParser) -> None:
    """The tuner's flags, carried so they are refused by name."""
    parser.add_argument("--auto-tune", default=None, metavar="PLAN|search",
                        help="not ported yet (auto-tuning slice)")
    parser.add_argument("--auto-tune-out", default=None, metavar="PATH",
                        help="not ported yet (auto-tuning slice)")
    parser.add_argument("--auto-tune-calibration", default=None,
                        metavar="JSON",
                        help="not ported yet (auto-tuning slice)")


# Later port slices named by `check_lm_args`.
LM_SLICES = {
    "plan": "the composed-parallel-plan slice",
    "tune": "the auto-tuning slice",
    "pipeline": "the pipeline slice",
    "seq": "the sequence-parallel slice",
    "moe": "the expert-parallel slice",
    "cm": "the collective-matmul slice",
    "reducer": "the gradient-reduction slice",
    "remat": "the activation-rematerialization slice",
    "checkpoint": "the checkpointing slice",
    "multistep": "the multi-step dispatch slice",
    "profile": "the profiler-capture slice",
}


def check_lm_args(args) -> None:
    """Startup-time validation of the LM CLI surface: every flag whose
    feature belongs to a later port slice is refused, naming the slice,
    before any engine or corpus is built."""
    s = LM_SLICES
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
        ("--resume / --checkpoint-dir / --checkpoint-format / --async-save",
         args.resume or args.checkpoint_dir != "./checkpoint"
         or args.checkpoint_format != "legacy" or args.async_save,
         s["checkpoint"]),
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
    "LM_SLICES",
    "add_auto_tune_flags",
    "add_checkpoint_flags",
    "add_grad_reduction_flags",
    "add_metrics_out_flag",
    "build_optimizer",
    "check_lm_args",
    "check_serving_args",
    "compute_dtype_from_flag",
    "export_metrics_out",
    "setup_metrics_out",
]
