"""Shared CLI pieces for `cli/serve.py`, `cli/lm.py`,
`cli/data_parallel.py` and `cli/model_parallel.py` (port of
`cli/common.py`).

The parsers carry the reference's whole flag surface, so a pasted
launch line fails with an explanation instead of an argparse error;
flags whose features belong to later port slices are refused loudly,
naming the slice (`check_serving_args`, `check_model_parallel_args`).
The image
side: `MODELS`, `build_model`, `STAGE_BUILDERS` (the pipeline splits),
`stats_for`, `build_loaders` (per-rank loaders from the global batch;
token-id datasets ship raw), `build_index_loaders` (its `--device-cache`
twin) and `check_batch_divisibility`; `check_pipeline_schedule_args` is shared
by both pipeline CLIs. `set_device_numerics` is the one place the CLIs
fix the card's f32 arithmetic.
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
    DatasetCollection,
)
from distributed_model_parallel_tpu_torch.data.loader import Loader
from distributed_model_parallel_tpu_torch.models import (
    bert,
    mobilenetv2,
    tinycnn,
)
from distributed_model_parallel_tpu_torch.models.resnet import (
    resnet18,
    resnet50,
)
from distributed_model_parallel_tpu_torch.models.resnet import (
    split_stages as resnet_split_stages,
)
from distributed_model_parallel_tpu_torch.models.vit import (
    VIT_CIFAR,
    vit_cifar,
)
from distributed_model_parallel_tpu_torch.runtime import dist


def add_grad_reduction_flags(parser: argparse.ArgumentParser) -> None:
    """The bucketed-reducer surface of the data_parallel and lm CLIs
    (`ops/grad_reduction.py`); serving carries it to refuse it
    (`check_serving_args`)."""
    parser.add_argument(
        "--grad-reduction", default="monolithic",
        choices=("monolithic", "bucketed", "overlapped"),
        help="gradient reduction: monolithic = one all-reduce of the "
             "whole flattened gradient; bucketed = DDP-Reducer-style "
             "~--bucket-mb flat buckets in reverse parameter order, each "
             "a reduce-scatter/all-gather pair, hierarchical over a "
             "--dcn-slices factored data axis (same math); overlapped = "
             "the buckets issued from a stagewise backward (the model is "
             "cut into --overlap-stages segments, late layers "
             "differentiate first and their buckets launch while earlier "
             "segments still run: the Reducer's autograd-hook overlap; "
             "same math)",
    )
    # None = "flag not passed": check_grad_reduction_args rejects an
    # explicit --bucket-mb outside bucketed/overlapped (any value,
    # including 25) and resolves the default itself.
    parser.add_argument(
        "--bucket-mb", default=None, type=float,
        help="flat-buffer bucket size in MB under --grad-reduction "
             "bucketed / overlapped (the Reducer's bucket_cap_mb; "
             "default 25)",
    )
    parser.add_argument(
        "--dcn-slices", default=1, type=int,
        help="cross-slice (DCN) factor of the data axis: the ranks form "
             "--dcn-slices slices of consecutive ranks, so the bucketed "
             "reduction reduce-scatters inside a slice and all-reduces "
             "only the 1/N shard across slices",
    )
    # None sentinel, like --bucket-mb.
    parser.add_argument(
        "--overlap-stages", default=None, type=int,
        help="backward segment count under --grad-reduction overlapped "
             "(pipeline-style split points; default: min(4, model "
             "blocks))",
    )
    parser.add_argument(
        "--dcn-compression", default="none",
        choices=("none", "bf16", "int8"),
        help="compress the cross-slice 'dcn' hop of the bucket "
             "reduction to this wire dtype (ops/wire_codec.py: bf16 = "
             "cast codec, 1/2 the bytes; int8 = absmax-scale codec + f32 "
             "scale sidecar, 1/4 the bytes; int8 never sums in int8). "
             "Master weights, intra-slice collectives and all math stay "
             "full precision; requires --dcn-slices >= 2",
    )


def check_grad_reduction_args(args) -> None:
    """Startup-time validation of the shared reducer flags, before any
    dataset or process group is built. Resolves the `--bucket-mb` and
    `--overlap-stages` None sentinels to 25 and 0 (auto)."""
    if args.bucket_mb is not None:
        if args.bucket_mb <= 0:
            raise SystemExit(
                f"--bucket-mb must be > 0, got {args.bucket_mb}"
            )
        if args.grad_reduction not in ("bucketed", "overlapped"):
            raise SystemExit(
                "--bucket-mb sizes the bucketed reducer's flat "
                "buffers; it only applies under --grad-reduction "
                "bucketed / overlapped"
            )
    else:
        args.bucket_mb = 25.0
    if args.overlap_stages is not None:
        if args.grad_reduction != "overlapped":
            raise SystemExit(
                "--overlap-stages cuts the stagewise backward; it only "
                "applies under --grad-reduction overlapped"
            )
        if args.overlap_stages < 2:
            raise SystemExit(
                "--overlap-stages must be >= 2 (one segment is the "
                f"monolithic backward), got {args.overlap_stages}"
            )
    else:
        args.overlap_stages = 0  # engine auto: min(4, model blocks)
    if args.dcn_slices < 1:
        raise SystemExit(
            f"--dcn-slices must be >= 1, got {args.dcn_slices}"
        )
    if args.dcn_compression != "none" and args.dcn_slices < 2:
        raise SystemExit(
            "--dcn-compression compresses the cross-slice 'dcn' hop, "
            "and this run has no 'dcn' axis to cross — factor the data "
            "axis with --dcn-slices >= 2 (or drop --dcn-compression)"
        )


def check_overlapped_model(name: str, overlap_stages: int = 0) -> None:
    """Fail fast, before any dataset or process group is built, when
    `--grad-reduction overlapped` names a model that cannot be cut into
    >= 2 backward segments, or `--overlap-stages` asks for more segments
    than it has blocks. Builds the model's structure only (no init)."""
    if name not in MODELS:
        return  # build_model raises the unknown-model error
    probe = MODELS[name](10)
    parts = getattr(probe, "parts", None)
    n_blocks = len(parts.blocks) if parts is not None else 0
    if n_blocks < 2:
        raise SystemExit(
            "--grad-reduction overlapped splits the backward into >= 2 "
            f"segments; --model {name} exposes {n_blocks} block(s) "
            "(models/staging.staged_model anatomy)"
        )
    if overlap_stages > n_blocks:
        raise SystemExit(
            f"--overlap-stages {overlap_stages} exceeds the "
            f"{n_blocks} blocks --model {name} exposes; each backward "
            "segment needs at least one block"
        )


def reducer_mesh(dcn_slices: int, seq_shards: int = 1, **axes):
    """`make_mesh(MeshSpec(data=-1, seq=seq_shards, dcn=dcn_slices,
    ...))` for the training CLIs, a bad factorization exiting with the
    mesh's reason."""
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    try:
        return make_mesh(MeshSpec(data=-1, seq=seq_shards, dcn=dcn_slices,
                                  **axes))
    except ValueError as e:
        flags = f"--dcn-slices {dcn_slices}"
        if seq_shards != 1:
            flags += f" / --seq-shards {seq_shards}"
        if axes.get("expert", 1) != 1:
            flags += f" / --expert-shards {axes['expert']}"
        raise SystemExit(f"{flags}: {e}") from e


def add_metrics_out_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="enable the metrics registry (observability/metrics.py) "
             "and write its export here at exit: Prometheus text when "
             "PATH ends in .prom, JSON otherwise. Fails fast if PATH's "
             "directory does not exist.",
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


def check_serving_args(args) -> None:
    """Startup-time validation of the serving CLI surface, the
    reference's checks and messages: reject training flags, layout flags
    that do not compose and bad values before any process group or
    engine is built."""
    if args.pipeline_stages != 1:
        raise SystemExit(
            "--pipeline-stages selects a TRAINING engine's stage wires; "
            "serving decodes token-by-token through one replica's "
            "layers (compose tp/sp layouts instead) — drop the flag"
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
            "the serving meshes are 'model'/'seq' only — drop the flag"
        )
    if args.dcn_compression != "none":
        raise SystemExit(
            "--dcn-compression compresses the training engines' "
            "cross-slice gradient/dispatch hop; the serving meshes "
            "have no 'dcn' fabric — drop the flag"
        )
    # --- layouts (serving/engine.py) ----------------------------------
    if args.layout == "tp":
        if args.model_shards < 2:
            raise SystemExit(
                "--layout tp shards heads over the 'model' axis; "
                "--model-shards must be >= 2 (1 shard IS the "
                "replicated layout — use --layout replicated)"
            )
        if args.seq_shards != 1:
            raise SystemExit(
                "--seq-shards belongs to --layout sp; the tp layout "
                "rings over 'model' — drop one of the flags"
            )
    elif args.layout == "sp":
        if args.seq_shards < 2:
            raise SystemExit(
                "--layout sp shards cache positions over the 'seq' "
                "axis; --seq-shards must be >= 2 (1 shard IS the "
                "replicated layout — use --layout replicated)"
            )
        if args.model_shards != 1:
            raise SystemExit(
                "--model-shards belongs to --layout tp; the sp layout "
                "shards over 'seq' — drop one of the flags"
            )
    else:  # replicated
        if args.model_shards != 1 or args.seq_shards != 1:
            raise SystemExit(
                "--model-shards / --seq-shards select the tp / sp "
                "layouts; pass --layout tp or --layout sp explicitly"
            )
    if args.collective_matmul and args.layout != "tp":
        raise SystemExit(
            "--collective-matmul rings decode projections over the "
            "'model' axis; it requires --layout tp with "
            "--model-shards >= 2"
        )
    if args.compute_dtype != "f32":
        if args.dtype != "float32":
            raise SystemExit(
                "--dtype and --compute-dtype both set the decode "
                "arithmetic; --dtype bfloat16 is the legacy spelling of "
                "--compute-dtype bf16 — pass only --compute-dtype"
            )
        if args.compute_dtype == "int8" and args.layout == "sp":
            raise SystemExit(
                "--compute-dtype int8 quantizes the decode projection "
                "GEMMs (replicated/tp layouts); the sp layout's "
                "shard_map decode has no quantized policy path — use "
                "bf16 or a tp/replicated layout"
            )
    # --- paged-cache knobs (serving/kv_cache.py) ---------------------
    if args.page_size < 0:
        raise SystemExit(f"--page-size must be >= 0, got {args.page_size}")
    if args.page_size:
        if args.max_len % args.page_size:
            raise SystemExit(
                f"--page-size {args.page_size} must divide --max-len "
                f"{args.max_len} (the block table covers whole pages)"
            )
        if args.layout == "sp" and args.page_size % args.seq_shards:
            raise SystemExit(
                f"--layout sp shards each page's positions over "
                f"'seq': --page-size {args.page_size} must be "
                f"divisible by --seq-shards {args.seq_shards}"
            )
    else:
        for val, flag in ((args.kv_pages, "--kv-pages"),
                          (args.prefill_chunk, "--prefill-chunk")):
            if val:
                raise SystemExit(
                    f"{flag} configures the block-paged KV cache; set "
                    "--page-size as well (0 = contiguous slots)"
                )
        if args.prefix_cache:
            raise SystemExit(
                "--prefix-cache shares pool PAGES between slots; it "
                "requires --page-size (the contiguous layout has no "
                "sharable unit)"
            )
    if args.kv_pages < 0:
        raise SystemExit(f"--kv-pages must be >= 0, got {args.kv_pages}")
    if args.prefill_chunk < 0:
        raise SystemExit(
            f"--prefill-chunk must be >= 0, got {args.prefill_chunk}"
        )
    if args.prefill_chunk and args.layout == "sp":
        raise SystemExit(
            "--prefill-chunk is not supported under --layout sp: sp "
            "prefill rides the training ring over 'seq' in one pass — "
            "drop the flag or use the replicated/tp layouts"
        )
    if args.prefix_cache:
        if args.layout == "sp":
            raise SystemExit(
                "--prefix-cache is not supported under --layout sp "
                "(shared pages would need coherent copy-on-write "
                "across 'seq' shards)"
            )
        if not args.prefill_chunk:
            raise SystemExit(
                "--prefix-cache needs --prefill-chunk: a partial prefix "
                "hit resumes ingestion mid-prompt, which only the chunked "
                "path can do"
            )
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
    # --- speculative decoding (serving/speculative.py) ---------------
    spec_k = args.speculative_k
    if spec_k < 0 or spec_k > 8:
        raise SystemExit(
            f"--speculative-k must be in [0, 8] (0 = off; past ~8 the "
            f"verify step's wasted work dominates), got {spec_k}"
        )
    if spec_k:
        if args.layout == "sp":
            raise SystemExit(
                "--speculative-k is not supported under --layout sp: "
                "the verify step rides the chunk-shaped paged decode "
                "path, which sp's shard_map decode does not lower — "
                "use the replicated/tp layouts"
            )
        if not args.page_size:
            raise SystemExit(
                "--speculative-k rolls rejected draft suffixes back by "
                "TRUNCATING THE BLOCK TABLE; it requires --page-size "
                "(the contiguous layout has no page-granular rollback)"
            )
        if spec_k + 1 >= args.max_len:
            raise SystemExit(
                f"--speculative-k {spec_k} writes k+1 positions per "
                f"verify round; --max-len {args.max_len} cannot hold "
                "one round past the prompt"
            )
        if args.speculative_draft_layers < 0:
            raise SystemExit(
                f"--speculative-draft-layers must be >= 0 (0 = "
                f"max(1, --layers // 2)), got "
                f"{args.speculative_draft_layers}"
            )
        if args.speculative_draft and args.speculative_draft_layers:
            raise SystemExit(
                "--speculative-draft-layers sizes a FRESH-INIT draft; "
                "--speculative-draft supplies the draft's dims from its "
                "recorded config — drop one of the flags"
            )
    else:
        for val, flag in (
                (args.speculative_draft, "--speculative-draft"),
                (args.speculative_draft_layers,
                 "--speculative-draft-layers")):
            if val:
                raise SystemExit(
                    f"{flag} configures the draft model for speculative "
                    "decoding; set --speculative-k >= 1 as well (0 = off)"
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


def serve_compute_dtype(args) -> str:
    """--compute-dtype (preferred) / legacy --dtype -> the ServingEngine
    compute_dtype string (`check_serving_args` has rejected setting
    both)."""
    if args.compute_dtype != "f32":
        return args.compute_dtype
    return "bf16" if args.dtype == "bfloat16" else "f32"


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
    """The checkpoint-format surface shared by the training CLIs
    (`checkpointing/`): sharded parallel saves, async off-step-path
    writes, resharding restore."""
    parser.add_argument("--checkpoint-dir", default="./checkpoint",
                        help="where the best-acc 'ckpt' (and 'last') "
                             "snapshots are written and --resume reads")
    parser.add_argument("--checkpoint-format", default="legacy",
                        choices=("legacy", "sharded"),
                        help="legacy = one .npz + .json sidecar gathered to "
                             "rank 0 (the JAX package's format); sharded = "
                             "each rank writes only its own chunks + a JSON "
                             "manifest (no gather on the save path; restore "
                             "reshards onto the current mesh, so a restart "
                             "may resize; every rank needs the same "
                             "filesystem). Restore reads either format")
    parser.add_argument("--async-save", action="store_true",
                        help="move checkpoint file I/O off the step path "
                             "(sharded format only): one device->host "
                             "snapshot, then a background writer thread; "
                             "write errors surface at the next save or at "
                             "exit, never silently")


def check_checkpoint_args(args) -> None:
    """The shared checkpoint flags, checked at startup (the Trainer
    checks the same, but only after datasets and meshes are built)."""
    if args.async_save and args.checkpoint_format != "sharded":
        raise SystemExit(
            "--async-save moves the sharded writer off the step path; "
            "it requires --checkpoint-format sharded (the legacy "
            "format gathers to host 0 synchronously by design)")


def _parse_plan(spec: str):
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        parse_plan,
    )

    try:
        return parse_plan(spec)
    except ValueError as e:
        raise SystemExit(f"--plan: {e}") from e


def check_lm_plan_args(args):
    """The LM CLI's `--plan` with the JAX CLI's guards and messages (None
    without the flag): `auto` rides the tuner (`--auto-tune` replaces it
    with the searched spec before this check, `tuning/apply.py`; alone
    it is refused); the plan IS the mesh factorization, so the per-axis flags,
    the schedule flags (the pp token's suffix spells the schedule),
    `--microbatches` at pp 1, an ep token, `--moe-experts`, `--attention`
    and `--collective-matmul` at sp 1, `--dcn-slices` and the reducer
    knobs (one fused reduction) are refused."""
    if not args.plan:
        return None
    if args.plan == "auto":
        raise SystemExit(
            "--plan auto rides the tuner: add --auto-tune search "
            "(or --auto-tune PLAN.json) to pick the spec from the "
            "plan family's search space")
    plan = _parse_plan(args.plan)
    if args.pipeline_stages > 1 or args.seq_shards > 1:
        raise SystemExit(
            f"--plan {plan.spec} IS the mesh factorization; it "
            "composes with neither --pipeline-stages nor "
            "--seq-shards (the plan's pp/sp fields replace them) "
            "— drop the per-axis flags")
    if args.pipeline_schedule != "gpipe" or args.virtual_stages != 1:
        raise SystemExit(
            f"plan {plan.spec}: ParallelPlan.schedule rides the "
            "pp token's suffix (--plan pp2-1f1b, pp4-int2); "
            "--pipeline-schedule and --virtual-stages ride "
            "--pipeline-stages, not --plan — drop the flags and "
            "spell the schedule in the spec")
    if args.microbatches != 1 and plan.pp <= 1:
        raise SystemExit(
            f"--microbatches schedules the plan's pipeline axis, "
            f"but plan {plan.spec} has pp=1 — add a ppN token or "
            "drop the flag")
    if plan.ep > 1:
        raise SystemExit(
            f"plan {plan.spec}: the CLI's expert surface is "
            "--moe-experts/--moe-dispatch (experts ride the data "
            "fabric); the plan's ep field is the engine/tuner "
            "surface — drop the ep token")
    if args.moe_experts > 0:
        raise SystemExit(
            f"--moe-experts trains under the expert-parallel "
            f"engine, but plan {plan.spec} has ParallelPlan.ep=1 "
            "and ep composition is not built — drop --plan or "
            "--moe-experts")
    if args.attention != "ring" and plan.tp_or_sp <= 1:
        raise SystemExit(
            f"--attention selects the 'seq'-axis distribution, "
            f"but plan {plan.spec} has sp=1 (stages attend "
            "locally, dense causal) — add an spN token or drop "
            "the flag")
    if args.collective_matmul and plan.tp_or_sp <= 1:
        raise SystemExit(
            f"--collective-matmul rings over the plan's 'seq' "
            f"axis, but plan {plan.spec} has sp=1 — add an spN "
            "token or drop the flag")
    if args.dcn_slices != 1:
        raise SystemExit(
            f"--dcn-slices factors the data axis for the "
            "hierarchical reducer; the stage-major plan mesh "
            f"(plan {plan.spec}) lays its pp field across the "
            "slice boundary by construction — drop the flag")
    if (args.grad_reduction != "monolithic"
            or args.dcn_compression != "none"
            or args.bucket_mb is not None
            or args.overlap_stages is not None):
        raise SystemExit(
            f"plan {plan.spec} reduces gradients with ONE fused "
            "psum over ('stage','data','seq'); the "
            "--grad-reduction/--bucket-mb/--overlap-stages/"
            "--dcn-compression knobs ride the single-axis "
            "engines — drop the flags or --plan")
    return plan


def check_plan_world(plan, world: int, global_batch: int, seq_len: int,
                     microbatches: int) -> None:
    """The JAX LM CLI's plan checks after the backend is up: the plan
    needs its ranks (the port's ranks are its devices, so a world the
    plan does not fill, whose extra ranks would idle, is refused too),
    the batch divides into its microbatches x data shards and the
    sequence into its seq shards."""
    if plan.num_devices > world:
        raise SystemExit(
            f"--plan {plan.spec} needs {plan.num_devices} "
            f"device(s), {world} present")
    if plan.num_devices < world:
        raise SystemExit(
            f"--plan {plan.spec} factors {plan.num_devices} device(s); "
            f"this world has {world} ranks, one a device — launch "
            f"{plan.num_devices} ranks or respell the plan's data axis")
    plan_mb = (microbatches if microbatches != 1
               else plan.pp * plan.virtual_stages)
    if global_batch % max(plan.dp * plan_mb, 1):
        raise SystemExit(
            f"--batch-size {global_batch} must divide into "
            f"{plan_mb} microbatch(es) x {plan.dp}-way 'data' "
            f"shards (plan {plan.spec})")
    if seq_len % plan.tp_or_sp:
        raise SystemExit(
            f"--seq-len {seq_len} not divisible by plan "
            f"{plan.spec}'s {plan.tp_or_sp}-way 'seq' axis")


def check_lm_args(args):
    """Startup-time validation of the LM CLI surface, with the JAX CLI's
    checks, before any engine or corpus is built (after the tuner's hook
    has set the knobs it owns). Returns the parsed `--plan` (None
    without it)."""
    plan = check_lm_plan_args(args)
    check_seq_shard_args(args, plan)
    check_moe_args(args)
    check_grad_reduction_args(args)
    check_checkpoint_args(args)
    if args.pipeline_stages > 1 and (
        args.grad_reduction != "monolithic"
        or args.dcn_slices != 1
        or args.dcn_compression != "none"
    ):
        raise SystemExit(
            "--grad-reduction bucketed/overlapped / --dcn-slices / "
            "--dcn-compression address the sequence-parallel engine's "
            "data-axis gradient collective; the pipeline engine "
            "reduces over 'stage' wires — drop the flags or "
            "--pipeline-stages"
        )
    if args.grad_reduction == "overlapped":
        if args.layers < 2:
            raise SystemExit(
                "--grad-reduction overlapped splits the decoder stack "
                f"into >= 2 backward segments; --layers {args.layers} "
                "leaves nothing to overlap"
            )
        if args.overlap_stages > args.layers:
            raise SystemExit(
                f"--overlap-stages {args.overlap_stages} exceeds "
                f"--layers {args.layers}: a backward segment needs at "
                "least one decoder block"
            )
    check_lm_pipeline_args(args, plan)
    return plan


def check_moe_args(args) -> None:
    """The LM CLI's MoE flags, with the JAX CLI's checks and messages:
    they need --moe-experts; MoE trains under the expert-parallel LM
    engine, so it refuses --seq-shards, --pipeline-stages (and with them
    --collective-matmul, which needs --seq-shards >= 2),
    --attention and --grad-reduction; --moe-overlap
    and --dcn-compression need the hierarchical dispatch, which keeps
    --expert-shards at 1."""
    if args.moe_experts < 0:
        raise SystemExit(
            f"--moe-experts must be >= 0, got {args.moe_experts}")
    if args.moe_experts == 0:
        for flag, bad in (
            ("--moe-dispatch", args.moe_dispatch != "gspmd"),
            ("--moe-overlap", args.moe_overlap),
            ("--expert-shards", args.expert_shards != 1),
            ("--moe-every", args.moe_every != 2),
        ):
            if bad:
                raise SystemExit(
                    f"{flag} configures the MoE expert exchange; it "
                    "has no effect without --moe-experts > 0")
        return
    if args.seq_shards > 1 or args.pipeline_stages > 1:
        raise SystemExit(
            "--moe-experts trains under the expert-parallel LM "
            "engine (GSPMD data x expert); it composes with "
            "neither --seq-shards > 1 nor --pipeline-stages > 1 — "
            "per-shard routing would break the dense capacity "
            "semantics")
    if args.attention != "ring":
        raise SystemExit(
            "--attention selects the sequence-parallel "
            "distribution and has no effect under --moe-experts "
            "(the MoE LM attends locally, dense causal); drop the "
            "flag")
    if args.grad_reduction != "monolithic":
        raise SystemExit(
            "--grad-reduction bucketed/overlapped addresses the "
            "sequence-parallel engine's explicit reducer; the "
            "expert-parallel LM engine is GSPMD — drop the flag")
    if args.moe_overlap and args.moe_dispatch != "hierarchical":
        raise SystemExit(
            "--moe-overlap chunks the hierarchical exchange; set "
            "--moe-dispatch hierarchical")
    if args.dcn_compression != "none" and \
            args.moe_dispatch != "hierarchical":
        raise SystemExit(
            "--dcn-compression compresses the hierarchical "
            "exchange's cross-slice messages; the gspmd dispatch "
            "has no explicit 'dcn' hop — set --moe-dispatch "
            "hierarchical (with --dcn-slices >= 2) or drop the flag")
    if args.moe_dispatch == "hierarchical" and args.expert_shards != 1:
        raise SystemExit(
            "--moe-dispatch hierarchical shards experts over the "
            "(factored) data fabric; --expert-shards must stay 1 "
            "(the 'expert' axis is the gspmd layout)")


def check_moe_experts_divide(num_experts: int, mesh) -> None:
    """Under the hierarchical dispatch each data rank owns an E/S expert
    block: the JAX CLI's check, after the mesh is built."""
    ways = mesh.data
    if num_experts % ways:
        raise SystemExit(
            f"--moe-dispatch hierarchical shards "
            f"--moe-experts {num_experts} over the "
            f"{ways}-way data fabric; the count must divide "
            "evenly (each device owns an E/S expert block)")


def check_seq_shard_args(args, plan=None) -> None:
    """The LM CLI's sequence-parallel flags, with the JAX CLI's checks and
    messages: stages exclude seq shards and collective matmul, collective
    matmul rings over two seq shards or more (under `--plan` the plan's
    sp field rules), the sequence splits evenly, and Ulysses scatters
    whole heads."""
    n = plan.tp_or_sp if plan is not None else args.seq_shards
    if n < 1:
        raise SystemExit(f"--seq-shards must be >= 1, got {n}")
    if args.pipeline_stages > 1 and n > 1:
        raise SystemExit(
            "--pipeline-stages and --seq-shards are mutually exclusive "
            "(one engine per run; compose data parallelism with either)"
        )
    if args.pipeline_stages > 1 and args.collective_matmul:
        raise SystemExit(
            "--collective-matmul decomposes the sequence-parallel "
            "engine's FFN collectives; it has no effect under "
            "--pipeline-stages (stages compute dense locally)"
        )
    if args.collective_matmul and n < 2 and plan is None:
        raise SystemExit(
            "--collective-matmul rings over the 'seq' axis; a size-1 "
            "ring is a plain dot, so the flag would silently do "
            "nothing — set --seq-shards >= 2"
        )
    if args.seq_len % n and plan is None:
        raise SystemExit(
            f"--seq-len {args.seq_len} not divisible by --seq-shards {n}")
    if args.attention.startswith("ulysses") and args.heads % n:
        raise SystemExit(f"ulysses needs heads ({args.heads}) divisible by "
                         f"'seq' axis size ({n})")


def check_lm_pipeline_args(args, plan=None) -> None:
    """The LM CLI's pipeline flags (the JAX CLI's checks): stages attend
    dense (no --attention), and the schedule knobs need
    --pipeline-stages > 1 (`check_seq_shard_args` keeps sequence shards
    and collective matmul off the stages); under `--plan` the plan's pp
    field takes --microbatches (`check_lm_plan_args`)."""
    stages = args.pipeline_stages
    if stages > 1 and args.attention != "ring":
        raise SystemExit(
            "--attention has no effect under --pipeline-stages (it selects "
            "the sequence-parallel distribution; stages attend locally, "
            "dense causal); drop the flag")
    if args.microbatches < 1:
        raise SystemExit(
            f"--microbatches must be >= 1, got {args.microbatches}")
    if stages < 1:
        raise SystemExit(
            f"--pipeline-stages must be >= 1, got {stages}")
    if stages == 1:
        if plan is not None:
            return
        for flag, bad in (
            ("--microbatches", args.microbatches != 1),
            ("--pipeline-schedule", args.pipeline_schedule != "gpipe"),
            ("--virtual-stages", args.virtual_stages != 1),
        ):
            if bad:
                raise SystemExit(
                    f"{flag} is a pipeline-schedule knob; it has no effect "
                    "without --pipeline-stages > 1")
        return
    check_pipeline_schedule_args(args.pipeline_schedule, args.virtual_stages,
                                 args.microbatches, stages)
    chunks = stages * args.virtual_stages
    if chunks > args.layers:
        raise SystemExit(
            f"--pipeline-stages {stages} x --virtual-stages "
            f"{args.virtual_stages} = {chunks} chunks exceeds --layers "
            f"{args.layers}: a chunk needs at least one decoder block")


def check_pipeline_schedule_args(schedule: str, virtual_stages: int,
                                 microbatches: int, num_stages: int) -> None:
    """The (schedule, V, M, S) surface of both pipeline CLIs, checked
    before any loader or mesh is built: --virtual-stages is an
    interleaved-only knob, interleaving needs >= 2 stages, and V > 1
    needs --microbatches divisible by the stage count (Megatron's
    round-robin microbatch groups; the schedule builder enforces the
    same)."""
    if virtual_stages < 1:
        raise SystemExit(
            f"--virtual-stages must be >= 1, got {virtual_stages}")
    if virtual_stages > 1 and schedule != "interleaved":
        raise SystemExit(
            "--virtual-stages > 1 requires --pipeline-schedule "
            "interleaved (gpipe/1f1b run exactly one model chunk per "
            "device, so the flag would silently do nothing)")
    if schedule == "interleaved":
        if num_stages < 2:
            raise SystemExit(
                "--pipeline-schedule interleaved needs >= 2 pipeline "
                "stages (a one-device pipeline has no bubble to divide)")
        if virtual_stages > 1 and microbatches % num_stages:
            raise SystemExit(
                f"interleaved schedule needs --microbatches divisible "
                f"by the stage count (got M={microbatches}, "
                f"S={num_stages}) — Megatron's round-robin microbatch "
                f"groups")


# ---------------------------------------------------------------- images

def _bert_tiny_cfg():
    """The reference's bert_tiny: sized for the SyntheticText task (vocab
    512, seq 64); 'bert' is BERT_BASE."""
    return bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=4,
                           num_heads=4, intermediate_size=256,
                           max_position=128)


def _bert_model(num_classes: int, cfg=None, *, remat: bool = False):
    return bert.bert_for_classification(num_classes, cfg or bert.BERT_BASE,
                                        remat=remat)


def _bert_stages(num_stages, num_classes, boundaries, cfg=None):
    return bert.split_stages(num_stages, num_classes, cfg or bert.BERT_BASE,
                             boundaries=boundaries)


MODELS = {
    "mobilenetv2": mobilenetv2.mobilenet_v2,
    "mobilenetv2_nobn": mobilenetv2.mobilenet_v2_nobn,
    "resnet18": resnet18,
    "resnet50": resnet50,
    "tinycnn": tinycnn.tiny_cnn,
    "vit": vit_cifar,  # CIFAR-scale ViT (32² inputs, 4x4 patches)
    # Token-id classifiers (pair with --dataset-type SyntheticText):
    "bert": _bert_model,
    "bert_tiny": lambda c, *, remat=False: _bert_model(
        c, _bert_tiny_cfg(), remat=remat),
}


# Pipeline stage builders: name -> fn(num_stages, num_classes,
# boundaries) -> [Layer]. `num_stages` counts chunks: the interleaved
# schedule passes S·V and the engine deals them round-robin.
STAGE_BUILDERS = {
    "mobilenetv2": lambda n, c, b: mobilenetv2.split_stages(
        n, c, boundaries=b),
    "mobilenetv2_nobn": lambda n, c, b: mobilenetv2.split_stages(
        n, c, batchnorm=False, boundaries=b),
    "resnet18": lambda n, c, b: resnet_split_stages(
        18, n, c, cifar=True, boundaries=b),
    "resnet50": lambda n, c, b: resnet_split_stages(50, n, c, boundaries=b),
    "tinycnn": lambda n, c, b: tinycnn.split_stages(n, c, boundaries=b),
    # Transformer pipelines: the wire carries the (hidden, mask) pair.
    "bert": _bert_stages,
    "bert_tiny": lambda n, c, b: _bert_stages(n, c, b, _bert_tiny_cfg()),
}


def build_model(name: str, num_classes: int, *, remat: bool = False):
    if name not in MODELS:
        raise SystemExit(f"unknown model {name!r}; choose from "
                         f"{sorted(MODELS)}")
    return MODELS[name](num_classes, remat=remat)


def stats_for(dataset_type: str) -> Tuple[np.ndarray, np.ndarray]:
    if dataset_type in ("CIFAR10", "Synthetic", "SyntheticTextures"):
        return CIFAR10_MEAN, CIFAR10_STD
    return IMAGENET_MEAN, IMAGENET_STD


def _shard_of(batch_size: int, val_batch_size, shard) -> Tuple[int, int]:
    """(index, count) of this rank's shard of every batch: `shard`, or
    the process's rank and world; each global batch must divide."""
    index, procs = shard or (dist.process_index(), dist.process_count())
    for label, b in (("", batch_size), ("val ", val_batch_size)):
        if b is not None and b % procs:
            raise SystemExit(f"global {label}batch size {b} must be "
                             f"divisible by the process count {procs}")
    return index, procs


def build_loaders(dataset_type: str, data_path: str, batch_size: int, *,
                  val_batch_size=None, augment: bool = True, seed: int = 0,
                  workers: int = 1, device_normalize: bool = False,
                  shard=None):
    """(train_loader, val_loader, num_classes) for this rank. `batch_size`
    and `val_batch_size` are GLOBAL batches (the reference's `-b 512` is
    512 in all, and lr 0.4 is tuned to it); each rank's Loader draws
    global / count samples a step from shard `index` of `shard = (index,
    count)`: by default the process's rank and world, under tensor
    parallelism the data index and the data ranks (the model ranks of a
    data index read the same rows)."""
    index, procs = _shard_of(batch_size, val_batch_size, shard)
    train_ds, val_ds = DatasetCollection(dataset_type, data_path).init()
    mean, std = stats_for(dataset_type)
    raw = getattr(train_ds, "kind", "image") == "text"
    if raw:  # token ids: no crop / flip, no normalize
        mean = std = None
        augment = False
    rank = dict(process_index=index, process_count=procs,
                workers=workers, device_normalize=device_normalize,
                mean=mean, std=std, raw=raw)
    train = Loader(train_ds, batch_size=batch_size // procs, shuffle=True,
                   augment=augment, seed=seed, **rank)
    val = Loader(val_ds, batch_size=(val_batch_size or batch_size) // procs,
                 shuffle=False, augment=False, drop_last=False, **rank)
    return train, val, train_ds.num_classes


def build_index_loaders(dataset_type: str, data_path: str, batch_size: int,
                        device, *, val_batch_size=None, augment: bool = True,
                        seed: int = 0, shard=None):
    """The `--device-cache` twin of `build_loaders`: the same per-rank
    batch division and datasets, but the loaders yield INDEX vectors and
    the train and val images upload to `device` once
    (`data/device_cache.combined_cache`). Returns (train_loader,
    val_loader, num_classes, input_transform)."""
    from distributed_model_parallel_tpu_torch.data.device_cache import (
        IndexLoader,
        combined_cache,
    )

    index, procs = _shard_of(batch_size, val_batch_size, shard)
    train_ds, val_ds = DatasetCollection(dataset_type, data_path).init()
    mean, std = stats_for(dataset_type)
    try:
        transform, val_off = combined_cache(
            train_ds, val_ds, device, augment=augment, mean=mean, std=std)
    except ValueError as e:
        raise SystemExit(f"--device-cache: {e}") from e
    rank = dict(process_index=index, process_count=procs)
    train = IndexLoader(train_ds, batch_size=batch_size // procs,
                        shuffle=True, seed=seed, **rank)
    val = IndexLoader(val_ds,
                      batch_size=(val_batch_size or batch_size) // procs,
                      shuffle=False, drop_last=False, index_offset=val_off,
                      **rank)
    return train, val, train_ds.num_classes, transform


def check_batch_divisibility(global_batch: int, mesh, *,
                             microbatches: int = 1,
                             label: str = "batch") -> None:
    """Fail at startup when the global batch does not split evenly over
    the mesh's data ranks, or a rank's share into `microbatches` equal
    pipeline microbatches."""
    if global_batch % mesh.data:
        raise SystemExit(
            f"{label} size {global_batch} must be divisible by the 'data' "
            f"mesh axis ({mesh.data} ranks)"
        )
    local = global_batch // mesh.data
    if local % microbatches:
        raise SystemExit(
            f"{label} size {global_batch} gives {local} samples per 'data' "
            f"shard, not divisible by --microbatches {microbatches}"
        )


def add_remat_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize activations in the backward "
                             "pass (torch.utils.checkpoint per block, per "
                             "pipeline chunk): less memory, one more "
                             "forward")


def add_dispatch_flags(parser: argparse.ArgumentParser) -> None:
    """--steps-per-dispatch and --profile-dir, shared by the training
    CLIs."""
    parser.add_argument("--steps-per-dispatch", default=1, type=int,
                        help="train steps per host dispatch: on the card "
                             "the step is captured in a CUDA graph and "
                             "replayed N times (same trajectory as step "
                             "by step); 1 = off")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace (Chrome JSON) "
                             "of three steady-state train steps (whole "
                             "dispatch groups: one group of N steps when "
                             "--steps-per-dispatch N >= 3) into this "
                             "directory")


def add_common_tpu_flags(parser: argparse.ArgumentParser) -> None:
    """The reference's shared training flags (its name kept): --model,
    --dtype, --remat, --optimizer, --profile-dir, --steps-per-epoch,
    --steps-per-dispatch, --log-file, --metrics-out."""
    parser.add_argument("--model", default="mobilenetv2",
                        choices=sorted(MODELS),
                        help="model family (the reference trains "
                             "MobileNetV2); bert and bert_tiny take "
                             "--dataset-type SyntheticText")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="activation dtype (parameters stay f32)")
    add_remat_flag(parser)
    parser.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"),
                        help="sgd = the reference's SGD(momentum, wd); adamw "
                             "= decoupled-decay AdamW")
    parser.add_argument("--steps-per-epoch", default=0, type=int,
                        help="truncate each epoch to N batches (0 = full "
                             "epoch)")
    add_dispatch_flags(parser)
    parser.add_argument("--log-file", default=None,
                        help="epoch log filename under ./log")
    add_metrics_out_flag(parser)


def check_data_parallel_plan(args):
    """The data-parallel CLI's `--plan dpN|fsdpN` (None without it), the
    JAX CLI's degenerate plan spelling of `--engine ddp|fsdp`, with its
    guards: pp / sp / ep tokens are the LM CLI's surface, and an
    `--engine` that is not the one the plan spells conflicts. Sets
    `args.engine`."""
    if not args.plan:
        return None
    plan = _parse_plan(args.plan)
    if plan.pp > 1 or plan.tp_or_sp > 1 or plan.ep > 1:
        raise SystemExit(
            f"--plan {plan.spec}: the image engines run the "
            "data axis only — the plan's pp/sp/ep fields are the "
            "LM CLI's surface (cli/lm.py --plan)")
    want = "fsdp" if plan.fsdp else "ddp"
    if args.engine not in ("gspmd", want):
        raise SystemExit(
            f"--plan {plan.spec} spells --engine {want} (plan "
            f"field {'fsdp' if plan.fsdp else 'dp'}); it "
            f"conflicts with --engine {args.engine} — drop one")
    args.engine = want
    return plan


def check_data_parallel_args(args):
    """Startup-time validation of the data-parallel CLI surface, with the
    JAX CLI's checks, before any dataset, process group or engine is
    built (after the tuner's hook has set the knobs it owns). Returns
    the parsed `--plan` (None without it)."""
    plan = check_data_parallel_plan(args)
    check_grad_reduction_args(args)
    check_checkpoint_args(args)
    if args.grad_reduction != "monolithic" and args.engine not in (
            "ddp", "fsdp"):
        raise SystemExit(
            f"--grad-reduction {args.grad_reduction} replaces the "
            "explicit gradient collective of the shard_map engines "
            f"(ddp, fsdp); the declarative --engine {args.engine} step "
            "has no explicit reduction site to bucket or overlap"
        )
    if args.dcn_compression != "none" and args.engine not in ("ddp",
                                                             "fsdp"):
        raise SystemExit(
            "--dcn-compression compresses the explicit cross-slice "
            "gradient hop of the shard_map engines (ddp, fsdp); the "
            f"declarative --engine {args.engine} step has no explicit "
            "'dcn' hop to compress — switch to --engine ddp/fsdp or "
            "drop the flag"
        )
    if args.grad_reduction == "overlapped":
        check_overlapped_model(args.model, args.overlap_stages)
    check_tensor_parallel_args(args)
    if args.dataset_type == "SyntheticText" and (
            args.device_cache or args.device_normalize):
        raise SystemExit(
            "--device-cache/--device-normalize apply the image "
            "normalize pipeline; token-id datasets ship raw (and are "
            "small on the wire already)"
        )
    if args.device_cache and args.device_normalize:
        raise SystemExit(
            "--device-cache already normalizes on device; drop "
            "--device-normalize")
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
    return plan


# The models `--engine tp` shards: the Megatron rules match their
# projection paths (the reference's TRANSFORMER_MODELS).
TRANSFORMER_MODELS = ("bert", "bert_tiny", "vit")


def model_widths(name: str) -> Tuple[int, int]:
    """(attention heads, FFN width) of a TRANSFORMER_MODELS entry."""
    if name == "vit":
        return VIT_CIFAR.num_heads, VIT_CIFAR.mlp_dim
    cfg = _bert_tiny_cfg() if name == "bert_tiny" else bert.BERT_BASE
    return cfg.num_heads, cfg.intermediate_size


def check_tensor_parallel_args(args) -> None:
    """The reference CLI's `--engine tp` checks, plus the port's own:
    --model-shards divides the model's heads and FFN width."""
    if args.engine == "tp" and args.dcn_slices != 1:
        raise SystemExit(
            "--dcn-slices factors the data axis for the hierarchical "
            "reducer; combine it with --engine gspmd/ddp/fsdp, not tp")
    if args.engine != "tp":
        if args.model_shards != 1:
            raise SystemExit(
                "--model-shards sizes the 'model' mesh axis and only "
                "applies under --engine tp")
        if args.collective_matmul:
            raise SystemExit(
                "--collective-matmul decomposes the Megatron TP "
                "projections; it only applies under --engine tp")
        return
    if args.model not in TRANSFORMER_MODELS:
        raise SystemExit(
            "--engine tp shards the Megatron projection layers; "
            f"--model {args.model} has none, so every weight would "
            "silently replicate across the 'model' axis (redundant "
            f"compute). Choose one of {', '.join(TRANSFORMER_MODELS)}.")
    if args.model_shards < 1:
        raise SystemExit(
            f"--model-shards must be >= 1, got {args.model_shards}")
    if args.collective_matmul and args.model_shards < 2:
        raise SystemExit(
            "--collective-matmul rings over the 'model' axis; a size-1 "
            "ring is a plain dot, so the flag would silently do "
            "nothing — set --model-shards >= 2")
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel \
        import check_divisibility

    try:
        check_divisibility(*model_widths(args.model), args.model_shards)
    except ValueError as e:
        raise SystemExit(f"--model {args.model}: {e}") from e


def check_model_parallel_args(args) -> None:
    """Startup-time validation of the pipeline CLI surface: the flags of
    later port slices are refused by name, then the schedule knobs and
    the stage builder are checked, before any dataset, process group or
    engine is built."""
    if args.world_size < 1:
        raise SystemExit(f"--world-size (pipeline stages) must be >= 1, "
                         f"got {args.world_size}")
    if args.microbatches < 1:
        raise SystemExit(
            f"--microbatches must be >= 1, got {args.microbatches}")
    check_pipeline_schedule_args(args.pipeline_schedule, args.virtual_stages,
                                 args.microbatches, args.world_size)
    if args.model not in STAGE_BUILDERS:
        raise SystemExit(
            f"model {args.model!r} has no pipeline stage builder; "
            f"pipeline-splittable models: {sorted(STAGE_BUILDERS)}. "
            "(Every model trains under the data-parallel CLI.)"
        )
    if args.reference_split:
        if args.virtual_stages != 1:
            raise SystemExit(
                "--reference-split fixes the ws=4 one-chunk-per-rank "
                "boundaries [3, 9, 15]; it cannot be combined with "
                "--virtual-stages > 1 (which needs a 4*V-way split)")
        if args.world_size != 4 or not args.model.startswith("mobilenetv2"):
            raise SystemExit(
                "--reference-split needs --world-size 4 and MobileNetV2")


def build_stages(model: str, num_stages: int, num_classes: int,
                 reference_split: bool, virtual_stages: int = 1):
    """[Layer] chunks for the pipeline engine: `num_stages` stages x
    `virtual_stages` chunks each; `reference_split` takes the
    reference's ws=4 boundaries [3, 9, 15]."""
    boundaries = [3, 9, 15] if reference_split else None
    chunks = num_stages * virtual_stages
    try:
        return STAGE_BUILDERS[model](chunks, num_classes, boundaries)
    except ValueError as e:
        raise SystemExit(
            f"model {model!r} cannot split into {chunks} chunks "
            f"(--world-size {num_stages} x --virtual-stages "
            f"{virtual_stages}): {e}") from e


def refuse_uncapturable(engine, steps_per_dispatch: int) -> None:
    """--steps-per-dispatch > 1 on an engine whose step spans more than
    one device (a pipeline over several cards): exit naming ROADMAP.md
    §A.7, before any data is loaded."""
    if steps_per_dispatch > 1:
        from distributed_model_parallel_tpu_torch.training.multistep import (
            check_capturable,
        )

        try:
            check_capturable(engine)
        except ValueError as e:
            raise SystemExit(f"--steps-per-dispatch: {e}") from e


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
    "STAGE_BUILDERS",
    "add_common_tpu_flags",
    "add_dispatch_flags",
    "add_remat_flag",
    "add_checkpoint_flags",
    "add_grad_reduction_flags",
    "add_metrics_out_flag",
    "build_index_loaders",
    "build_loaders",
    "build_model",
    "build_optimizer",
    "build_stages",
    "check_batch_divisibility",
    "check_checkpoint_args",
    "check_grad_reduction_args",
    "check_overlapped_model",
    "check_data_parallel_args",
    "check_data_parallel_plan",
    "check_lm_args",
    "check_lm_plan_args",
    "check_moe_args",
    "check_moe_experts_divide",
    "check_lm_pipeline_args",
    "check_model_parallel_args",
    "check_pipeline_schedule_args",
    "check_plan_world",
    "check_serving_args",
    "check_tensor_parallel_args",
    "compute_dtype_from_flag",
    "export_metrics_out",
    "reducer_mesh",
    "refuse_uncapturable",
    "set_device_numerics",
    "setup_metrics_out",
    "stats_for",
    "TRANSFORMER_MODELS",
]
