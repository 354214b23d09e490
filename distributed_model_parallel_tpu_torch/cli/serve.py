"""Offline serving driver (port of `cli/serve.py`).

Feeds a synthetic request trace (random prompts, optionally staggered
Poisson arrivals collapsed to submission order) through
`serving.engine.ServingEngine` under continuous batching, and prints
per-request results plus the aggregate tokens/sec and p50/p99 legs as
JSON on stdout — the reference's flags, report and trace.

  python -m distributed_model_parallel_tpu_torch.cli.serve \\
      --compute-dtype int8                       # on the GPU (default)
  python -m distributed_model_parallel_tpu_torch.cli.serve \\
      --device cpu --dim 64 --layers 2 --heads 4

`--device` picks where the model runs: cuda (the default; refused when
no GPU is present) or cpu. `--checkpoint DIR` serves a trained model:
the `params` of the newest snapshot in DIR (`last` or `ckpt`, as a
resumed training run would pick), written by either package's
training CLIs; the sidecar's recorded `gpt_config` must match the
serve flags. Flags whose features belong to later port slices (tp/sp
layouts, paged cache, speculative decoding, bf16) are refused with the
slice named (`cli/common.py`).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.cli.common import (
    add_grad_reduction_flags,
    add_metrics_out_flag,
    check_serving_args,
    export_metrics_out,
    set_device_numerics,
    setup_metrics_out,
)
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    params_spec,
)
from distributed_model_parallel_tpu_torch.models.gpt import (
    GPTConfig,
    init_params,
)
from distributed_model_parallel_tpu_torch.serving.engine import (
    ServingEngine,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import Request
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    checkpoint_metadata,
    newest_checkpoint_name,
    restore_subtree,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="offline autoregressive serving (continuous "
                    "batching over a contiguous KV cache) on PyTorch"
    )
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs (default cuda; cpu for "
                        "small runs without a GPU)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="serve the params of the newest checkpoint in DIR "
                        "(a training CLI's --checkpoint-dir) instead of "
                        "random weights")
    p.add_argument("--vocab-size", default=256, type=int)
    p.add_argument("--dim", default=128, type=int)
    p.add_argument("--layers", default=4, type=int)
    p.add_argument("--heads", default=4, type=int)
    p.add_argument("--ffn-dim", default=None, type=int,
                   help="default 4*dim")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="legacy activation-dtype spelling; bfloat16 is "
                        "not ported yet")
    p.add_argument("--compute-dtype", default="f32",
                   choices=("f32", "bf16", "int8"),
                   help="decode projection GEMM arithmetic "
                        "(ops/quant_matmul.py): int8 quantizes each "
                        "decode projection with per-output-channel "
                        "weight scales and per-token activation scales, "
                        "accumulating in int32 (the CUDA int8 kernel on "
                        "the GPU); activations, cache, prefill and head "
                        "stay f32. bf16 is not ported yet")
    p.add_argument("--layout", default="replicated",
                   choices=("replicated", "tp", "sp"),
                   help="cache/param layout; only replicated is ported")
    p.add_argument("--model-shards", default=1, type=int,
                   help="not ported yet (tp layout)")
    p.add_argument("--seq-shards", default=1, type=int,
                   help="not ported yet (sp layout)")
    p.add_argument("--collective-matmul", action="store_true",
                   help="not ported yet (tp layout)")
    p.add_argument("--num-slots", default=8, type=int,
                   help="KV-cache slots = max concurrent sequences")
    p.add_argument("--max-len", default=256, type=int,
                   help="cache positions per slot (prompt + generated)")
    p.add_argument("--prefill-len", default=64, type=int,
                   help="padded prompt length")
    p.add_argument("--page-size", default=0, type=int,
                   help="not ported yet (paged-cache slice)")
    p.add_argument("--kv-pages", default=0, type=int,
                   help="not ported yet (paged-cache slice)")
    p.add_argument("--prefill-chunk", default=0, type=int,
                   help="not ported yet (paged-cache slice)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="not ported yet (paged-cache slice)")
    p.add_argument("--speculative-k", default=0, type=int,
                   help="not ported yet (speculative-decoding slice)")
    p.add_argument("--speculative-draft", default=None, metavar="DIR",
                   help="not ported yet (speculative-decoding slice)")
    p.add_argument("--speculative-draft-layers", default=0, type=int,
                   help="not ported yet (speculative-decoding slice)")
    p.add_argument("--arrival-rate", default=0.0, type=float,
                   help="Poisson arrival-EVENT rate in events/s for the "
                        "synthetic trace (0 = every request arrives at "
                        "t=0)")
    p.add_argument("--arrival-burst", default=1, type=int,
                   help="requests arriving per Poisson event (needs "
                        "--arrival-rate > 0)")
    p.add_argument("--temperature", default=0.0, type=float,
                   help="sampling temperature (0 = greedy argmax)")
    p.add_argument("--top-k", default=0, type=int,
                   help="keep only the k most probable tokens (needs "
                        "--temperature > 0)")
    p.add_argument("--top-p", default=1.0, type=float,
                   help="nucleus sampling mass (needs --temperature > 0)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="dump a Chrome trace_event JSON of the run "
                        "(observability/trace.py). Fails fast if PATH's "
                        "directory does not exist.")
    add_metrics_out_flag(p)
    p.add_argument("--num-requests", default=16, type=int)
    p.add_argument("--prompt-len-min", default=4, type=int)
    p.add_argument("--prompt-len-max", default=32, type=int)
    p.add_argument("--max-new-tokens", default=32, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--pipeline-stages", default=1, type=int,
                   help="TRAINING flag; rejected here")
    add_grad_reduction_flags(p)
    return p


def synthetic_trace(args) -> list:
    """Deterministic random request set: prompt lengths uniform in
    [min, max], token ids uniform over the vocabulary (0 is reserved for
    padding). Same draws as the reference for the same flags."""
    rng = np.random.RandomState(args.seed)
    out = []
    for i in range(args.num_requests):
        n = int(rng.randint(args.prompt_len_min, args.prompt_len_max + 1))
        out.append(Request(
            rid=i,
            prompt=rng.randint(1, args.vocab_size, size=n).astype(np.int32),
            max_new_tokens=args.max_new_tokens,
        ))
    return out


def synthetic_arrivals(args) -> np.ndarray:
    """Arrival time (seconds) per request: Poisson events at
    --arrival-rate, --arrival-burst requests per event; its own RNG
    stream, so arrival flags never perturb prompt content. Rate 0 = all
    at t=0."""
    if not args.arrival_rate:
        return np.zeros(args.num_requests, np.float64)
    rng = np.random.RandomState(args.seed + 0x5EED)
    n_events = -(-args.num_requests // args.arrival_burst)  # ceil
    gaps = rng.exponential(1.0 / args.arrival_rate, size=n_events)
    events = np.cumsum(gaps)
    return np.repeat(events, args.arrival_burst)[:args.num_requests]


# GPTConfig fields recorded by the lm CLI (checkpoint_extra) -> the serve
# flag that sets each, for mismatch messages a user can act on. The
# position table is --max-len long at serve time.
_GPT_CONFIG_FLAGS = {
    "vocab_size": "--vocab-size",
    "dim": "--dim",
    "num_layers": "--layers",
    "num_heads": "--heads",
    "ffn_dim": "--ffn-dim",
    "max_position": "--max-len",
}


def _checkpoint_guard(directory: str, name: str, cfg) -> None:
    """Fail before any engine is built, naming the field and its flag,
    when the checkpoint's recorded model config disagrees with the serve
    flags; refuse Mixture-of-Experts checkpoints. A checkpoint with no
    recorded config falls through to the shape check at load time."""
    try:
        meta = checkpoint_metadata(directory, name)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    recorded = meta.get("gpt_config")
    if not recorded:
        return
    if int(recorded.get("num_experts", 0)) > 0:
        raise SystemExit(
            f"--checkpoint {directory}: the checkpoint is a "
            f"Mixture-of-Experts LM (num_experts="
            f"{recorded['num_experts']}); the serving engine builds dense "
            "decoder blocks and cannot serve it")
    for field, flag in _GPT_CONFIG_FLAGS.items():
        if field in recorded and int(recorded[field]) != int(
                getattr(cfg, field)):
            raise SystemExit(
                f"--checkpoint {directory}: the checkpoint was trained "
                f"with {field}={recorded[field]} but the serve flags give "
                f"{field}={getattr(cfg, field)} — adjust {flag} to match "
                "the trained model")


def load_checkpoint_params(directory: str, name: str, cfg, seed: int,
                           device) -> dict:
    """The `params` subtree of checkpoint `name` in `directory`, in the
    port's layout on the host; a missing or misshapen leaf exits naming
    it."""
    template = params_spec(init_params(cfg, seed, device=device))
    try:
        raw, meta = restore_subtree(directory, template, name=name)
    except (FileNotFoundError, KeyError, ValueError) as e:
        raise SystemExit(f"--checkpoint {directory}: {e}")
    print(f"==> serving checkpoint {directory} ({name}, epoch "
          f"{meta.get('epoch')}, format {meta.get('format')})", flush=True)
    return from_jax_params(raw)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_serving_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to serve on the CPU"
        )
    setup_metrics_out(args.metrics_out)
    if args.trace_out:
        trace_dir = os.path.dirname(os.path.abspath(args.trace_out))
        if not os.path.isdir(trace_dir):
            raise SystemExit(
                f"--trace-out {args.trace_out}: directory {trace_dir} "
                "does not exist"
            )
    if args.prompt_len_min < 1 or args.prompt_len_max < args.prompt_len_min:
        raise SystemExit(
            f"--prompt-len-min/max must satisfy 1 <= min <= max, got "
            f"[{args.prompt_len_min}, {args.prompt_len_max}]"
        )
    if args.prompt_len_max > args.prefill_len:
        raise SystemExit(
            f"--prompt-len-max {args.prompt_len_max} exceeds "
            f"--prefill-len {args.prefill_len}"
        )
    cfg = GPTConfig(
        vocab_size=args.vocab_size,
        dim=args.dim,
        num_layers=args.layers,
        num_heads=args.heads,
        ffn_dim=args.ffn_dim or 4 * args.dim,
        max_position=args.max_len,
        dropout_rate=0.0,
        pad_token_id=0,
    )
    ckpt_name = None
    if args.checkpoint:
        # The resume rule of the Trainer: serve what a resumed training
        # run would load.
        ckpt_name = newest_checkpoint_name(args.checkpoint)
        _checkpoint_guard(args.checkpoint, ckpt_name, cfg)
    set_device_numerics()
    engine = ServingEngine(
        cfg,
        num_slots=args.num_slots,
        max_len=args.max_len,
        prefill_len=args.prefill_len,
        compute_dtype=args.compute_dtype,
        device=args.device,
    )
    if args.checkpoint:
        params = engine.place_params(load_checkpoint_params(
            args.checkpoint, ckpt_name, cfg, args.seed, engine.device))
    else:
        params = engine.init_params(args.seed)
    requests = synthetic_trace(args)
    if args.trace_out:
        from distributed_model_parallel_tpu_torch.observability import trace

        trace.enable()
    sampling = None
    if args.temperature > 0:
        from distributed_model_parallel_tpu_torch.serving.sampling import (
            SamplingConfig,
        )

        sampling = SamplingConfig(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed,
        )
    sched = engine.run(params, requests, sampling=sampling)
    report = sched.latency_report()
    if args.arrival_rate:
        # Offered load vs achieved goodput; span = last arrival + one
        # mean inter-event gap, so a single burst stays finite.
        arrivals = synthetic_arrivals(args)
        span = float(arrivals[-1]) + 1.0 / args.arrival_rate
        offered_req_s = args.num_requests / span
        report["offered_load"] = {
            "arrival_rate": args.arrival_rate,
            "arrival_burst": args.arrival_burst,
            "offered_req_per_s": round(offered_req_s, 3),
            "offered_tokens_per_s": round(
                offered_req_s * args.max_new_tokens, 3
            ),
            "goodput": report.get("goodput"),
            "achieved_tokens_per_s": report.get("tokens_per_s"),
        }
    export_metrics_out(args.metrics_out)
    if args.trace_out:
        from distributed_model_parallel_tpu_torch.observability import trace

        trace.get_tracer().export(args.trace_out)
        print(f"==> wrote Chrome trace to {args.trace_out}", flush=True)
    per_request = [
        {
            "rid": f.rid,
            "prompt_len": f.prompt_len,
            "generated": len(f.tokens),
            "tokens": [int(t) for t in f.tokens],
            "prefill_ms": round(f.prefill_s * 1e3, 3),
            "total_ms": round(f.total_s * 1e3, 3),
        }
        for f in sched.finished
    ]
    device_name = (
        torch.cuda.get_device_name(engine.device)
        if engine.device.type == "cuda" else "cpu"
    )
    out = {
        "serving": {
            "device": device_name,
            "compute_dtype": engine.compute_mode,
            "layout": args.layout,
            "checkpoint": args.checkpoint,
            "shards": 1,
            "collective_matmul": args.collective_matmul,
            "num_slots": args.num_slots,
            "max_len": args.max_len,
            "prefill_len": args.prefill_len,
            "page_size": None,
            "prefill_chunk": None,
            "prefix_cache": False,
            "temperature": args.temperature,
            "speculative_k": None,
            "speculative_draft": None,
            **report,
        },
        "requests": per_request,
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
