"""Serving-flag checks for `cli/serve.py` (port of the serving parts of
`cli/common.py`).

The serve parser carries the reference's whole flag surface, including
the shared training flags, so a pasted launch line fails with an
explanation instead of an argparse error; flags whose features belong to
later port slices are refused loudly, naming the slice.
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
    """The training engines' reducer flags, carried so a pasted training
    line is refused with an explanation (`check_serving_args`)."""
    parser.add_argument("--grad-reduction", default="monolithic",
                        choices=("monolithic", "bucketed", "overlapped"),
                        help="TRAINING flag; rejected here")
    parser.add_argument("--bucket-mb", default=None, type=float,
                        help="TRAINING flag; rejected here")
    parser.add_argument("--dcn-slices", default=1, type=int,
                        help="TRAINING flag; rejected here")
    parser.add_argument("--overlap-stages", default=None, type=int,
                        help="TRAINING flag; rejected here")
    parser.add_argument("--dcn-compression", default="none",
                        choices=("none", "bf16", "int8"),
                        help="TRAINING flag; rejected here")


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
    "add_grad_reduction_flags",
    "add_metrics_out_flag",
    "check_serving_args",
    "export_metrics_out",
    "setup_metrics_out",
]
