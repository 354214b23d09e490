"""Causal-LM pretraining entry point (port of `cli/lm.py`).

GPT next-token pretraining on the deterministic Markov-chain corpus
(`data/lm.py`; its entropy rate is printed as the loss floor), through
the `Trainer` epoch protocol: with `CausalLMSequenceParallelEngine`
over a (data, seq) mesh of ranks (`torchrun`, one process per GPU as on
the DP CLI: `-b` is the global batch; `--seq-shards S` puts S
consecutive ranks on the columns of each sequence, the reference's
`MeshSpec(data=-1, seq=S)`, and the rest on its rows), or split into
pipeline stages, every stage driven by each rank's one process, with
`LMPipelineEngine`
(`--pipeline-stages S`, `--microbatches`, `--pipeline-schedule
gpipe|1f1b|interleaved`, `--virtual-stages`; the stages attend dense and
causal, so `--attention` is refused there, as in the JAX CLI), whose
data axis spans the ranks in the same way (`MeshSpec(data=-1,
stage=S)`: each rank takes its rows of `-b`, the gradients are averaged
over the ranks, and rank 0 alone prints and writes):

  python -m distributed_model_parallel_tpu_torch.cli.lm \\
      --attention ulysses_flash               # on the GPU (default)
  python -m distributed_model_parallel_tpu_torch.cli.lm --device cpu \\
      --dim 32 --layers 2 --heads 4 --seq-len 32 -b 4 --epochs 2
  torchrun --nproc-per-node 2 -m distributed_model_parallel_tpu_torch.cli.lm \\
      --device cpu --dim 32 --layers 2 --heads 4 --seq-len 32 -b 4 \\
      --epochs 2 --seq-shards 2 --attention ring_flash
  python -m distributed_model_parallel_tpu_torch.cli.lm --device cpu \\
      --dim 32 --layers 4 --heads 4 --seq-len 32 -b 4 --epochs 2 \\
      --pipeline-stages 2 --microbatches 2 --pipeline-schedule 1f1b
  torchrun --nproc-per-node 4 -m distributed_model_parallel_tpu_torch.cli.lm \\
      --device cpu --dim 32 --layers 4 --heads 4 --seq-len 32 -b 4 \\
      --epochs 2 --plan pp2xsp2 --attention ring_flash

The parser keeps the reference's flag surface and adds `--device`
(cuda, the default, or cpu). `--attention ulysses_flash` and
`ring_flash` run the flash-attention kernels. `--remat` checkpoints
each decoder block (the flash forward runs again in the backward pass),
`--steps-per-dispatch N` replays a CUDA graph of the train step N times
a dispatch on the card, `--profile-dir` writes a torch.profiler trace.
`--grad-reduction bucketed|overlapped`, `--bucket-mb`,
`--overlap-stages`, `--dcn-slices` and `--dcn-compression` select the
data-axis gradient reduction (`ops/grad_reduction.py`), with the JAX
CLI's checks, as are `--seq-shards` (`--seq-len` divisible by it, no
`--pipeline-stages` beside it, `--heads` divisible by it under
Ulysses) and `--collective-matmul` (each block's FFN pair on the rings
over the seq ranks, `ops/collective_matmul.py`; it needs `--seq-shards`
>= 2). `--moe-experts E` swaps the FFN of every `--moe-every`-th block
for a routed MoE of E experts and trains under `ExpertParallelLMEngine`
(`parallel/expert_parallel.py`) on `MeshSpec(data=-1,
expert=--expert-shards, dcn=--dcn-slices)`: `--moe-dispatch gspmd` holds
E/N experts on each of the N ranks of an expert group, `hierarchical`
E/S on each data rank with the two-level token exchange
(`ops/expert_dispatch.py`; `--moe-overlap` chunks it, `--dcn-compression`
codes its cross-slice hops), with the JAX CLI's checks
(`cli/common.check_moe_args`). `--plan SPEC` composes the axes through
`parallel/plan.build_plan_engine` on a stage-major plan mesh of ranks
(pipeline stages as ranks of their own beside seq and data ranks), with
the JAX CLI's guards (`cli/common.check_lm_plan_args`). `--auto-tune
search|PLAN.json` lets the tuner pick the knobs of the engine the flags
select, and `--plan auto --auto-tune ...` the plan spec itself
(`tuning/apply.auto_tune_lm`, with the JAX CLI's guards): every rank
searches before the process group starts, and rank 0 prints the
applied plan. The
best-val-acc model is saved to `--checkpoint-dir` with the model's
`gpt_config` in its sidecar (what `cli/serve.py --checkpoint` checks),
and `--resume` continues from it. `--checkpoint-format sharded` writes
the sharded format (`checkpointing/`) and `--async-save` writes it from
a background thread; under `--pipeline-stages` the sharded format is
refused at the first save, as the reference's trainer refuses it for a
restructuring engine.
"""

from __future__ import annotations

import argparse

import torch

from distributed_model_parallel_tpu_torch.cli.common import (
    add_checkpoint_flags,
    add_dispatch_flags,
    add_remat_flag,
    add_grad_reduction_flags,
    add_metrics_out_flag,
    build_optimizer,
    check_batch_divisibility,
    check_lm_args,
    check_moe_experts_divide,
    check_plan_world,
    compute_dtype_from_flag,
    export_metrics_out,
    reducer_mesh,
    refuse_uncapturable,
    set_device_numerics,
    setup_metrics_out,
)
from distributed_model_parallel_tpu_torch.data.lm import (
    LMLoader,
    chain_entropy,
    synthetic_corpus,
)
from distributed_model_parallel_tpu_torch.models.gpt import (
    GPTConfig,
    gpt_lm_model,
    split_stages,
)
from distributed_model_parallel_tpu_torch.parallel.expert_parallel import (
    ExpertParallelLMEngine,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    LMPipelineEngine,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
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
from distributed_model_parallel_tpu_torch.tuning.apply import (
    add_auto_tune_flags,
    auto_tune_lm,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="causal-LM pretraining on "
                                            "PyTorch")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model trains (default cuda; cpu for "
                        "small runs without a GPU)")
    p.add_argument("--vocab-size", default=256, type=int)
    p.add_argument("--dim", default=128, type=int)
    p.add_argument("--layers", default=4, type=int)
    p.add_argument("--heads", default=4, type=int)
    p.add_argument("--ffn-dim", default=None, type=int,
                   help="default 4*dim")
    p.add_argument("--seq-len", default=256, type=int)
    p.add_argument("--dropout", default=0.0, type=float)
    p.add_argument("-b", "--batch-size", default=32, type=int)
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--optimizer", default="adamw", choices=("sgd", "adamw"),
                   help="LM convention: adamw (sgd kept for parity runs)")
    p.add_argument("--wd", "--weight-decay", default=1e-2, type=float,
                   dest="weight_decay")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--corpus-tokens", default=1 << 16, type=int)
    p.add_argument("--corpus-seed", default=0, type=int)
    p.add_argument("--seq-shards", default=1, type=int,
                   help="'seq' mesh axis size (context parallelism: ring "
                        "or Ulysses attention over the ranks of a "
                        "sequence); 1 = plain data parallelism")
    p.add_argument("--pipeline-stages", default=1, type=int,
                   help="split the decoder into S pipeline stages "
                        "(LMPipelineEngine); stage s on the process's "
                        "device s mod the device count")
    p.add_argument("--microbatches", default=1, type=int,
                   help="pipeline microbatches in flight")
    p.add_argument("--pipeline-schedule", default="gpipe",
                   choices=("gpipe", "1f1b", "interleaved"),
                   help="gpipe = fill-drain; 1f1b = one-forward-one-"
                        "backward (O(S) live activations); interleaved = "
                        "Megatron's virtual pipeline (--virtual-stages)")
    p.add_argument("--virtual-stages", default=1, type=int,
                   help="model chunks per stage (interleaved schedule); "
                        "needs --microbatches divisible by the stages")
    p.add_argument("--attention", default="ring",
                   choices=("ring", "ring_flash", "ulysses",
                            "ulysses_flash"),
                   help="attention core; *_flash = the flash-attention "
                        "CUDA kernels (ops/flash_attention.py)")
    p.add_argument("--moe-experts", default=0, type=int,
                   help="Mixture-of-Experts: swap the FFN of every "
                        "--moe-every-th decoder block for a routed MoE "
                        "with this many experts (models/moe.py) and "
                        "train under the expert-parallel LM engine; "
                        "0 = dense (default)")
    p.add_argument("--moe-every", default=2, type=int,
                   help="which decoder blocks are MoE (1 = every "
                        "layer, 2 = every other, ...)")
    p.add_argument("--moe-dispatch", default="gspmd",
                   choices=("gspmd", "hierarchical"),
                   help="MoE token exchange: gspmd = experts sharded "
                        "over an --expert-shards 'expert' mesh axis; "
                        "hierarchical = experts ride the (--dcn-slices "
                        "factored) data fabric through the explicit "
                        "two-level exchange (ops/expert_dispatch.py)")
    p.add_argument("--moe-overlap", action="store_true",
                   help="chunk the hierarchical exchange so expert FFN "
                        "compute on chunk k hides the communication of "
                        "chunk k+1 (requires --moe-dispatch "
                        "hierarchical; same math)")
    p.add_argument("--expert-shards", default=1, type=int,
                   help="'expert' mesh axis size (gspmd dispatch); "
                        "hierarchical dispatch shards experts over the "
                        "data fabric instead and requires 1")
    p.add_argument("--collective-matmul", action="store_true",
                   help="run each block's FFN pair as latency-hiding rings "
                        "over the 'seq' axis (needs --seq-shards >= 2; "
                        "same math)")
    p.add_argument("--plan", default=None, metavar="SPEC|auto",
                   help="composed ParallelPlan spec (parallel/plan.py): "
                        "one declarative mesh factorization over the "
                        "ranks — tokens ppN/spN/dpN/fsdpN joined by 'x', "
                        "e.g. pp2xsp2xdp2 or fsdp4; the pp token takes a "
                        "schedule suffix (pp2-1f1b, pp4-int2 for "
                        "interleaved with V=2 virtual stages; default "
                        "gpipe) — driven through build_plan_engine "
                        "(degenerate specs route to the single-axis "
                        "engines). Replaces the per-axis flags "
                        "(--pipeline-stages, --seq-shards); 'auto' rides "
                        "the tuner (with --auto-tune search or "
                        "--auto-tune PLAN.json)")
    add_grad_reduction_flags(p)
    add_checkpoint_flags(p)
    add_auto_tune_flags(p)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="activation dtype (parameters stay f32)")
    add_remat_flag(p)
    p.add_argument("--steps-per-epoch", default=0, type=int)
    add_dispatch_flags(p)
    p.add_argument("--log-file", default=None)
    p.add_argument("--resume", "-r", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    add_metrics_out_flag(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.auto_tune:
        # Before the CLI's guards, as in the JAX CLI: the tuner writes
        # its knobs onto args, and an inconsistent plan still meets every
        # check. Before the process group too (tuning/apply.py).
        auto_tune_lm(args)
    plan = check_lm_args(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to train on the CPU"
        )
    setup_metrics_out(args.metrics_out)
    cfg = GPTConfig(
        vocab_size=args.vocab_size,
        dim=args.dim,
        num_layers=args.layers,
        num_heads=args.heads,
        ffn_dim=args.ffn_dim or 4 * args.dim,
        max_position=args.seq_len,
        dropout_rate=args.dropout,
        pad_token_id=0,
        num_experts=args.moe_experts,
        moe_every=args.moe_every,
    )
    set_device_numerics()
    cdt = compute_dtype_from_flag(args.dtype)
    if plan is not None:
        # The plan lays its own stage-major mesh over the ranks
        # (runtime/mesh.make_plan_mesh), one rank a device.
        from distributed_model_parallel_tpu_torch.parallel.plan import (
            build_plan_engine,
        )

        device = initialize_backend(args.device, None)
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        check_plan_world(plan, world, args.batch_size, args.seq_len,
                         args.microbatches)
        try:
            engine = build_plan_engine(
                cfg, build_optimizer(args), plan, device=device,
                num_microbatches=(args.microbatches
                                  if args.microbatches != 1 else None),
                attention=args.attention,
                collective_matmul=args.collective_matmul,
                compute_dtype=cdt, remat=args.remat)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--plan {plan.spec}: {e}") from e
        if is_primary():
            print(f"==> plan {plan.spec}: {type(engine).__name__} on "
                  f"{world} rank(s) of {device.type}", flush=True)
    elif args.pipeline_stages > 1:
        # One process drives every stage (runtime/mesh.py); the data
        # axis spans the ranks, as in the reference's MeshSpec(data=-1,
        # stage=S).
        device = initialize_backend(args.device, None)
        mesh = make_mesh(MeshSpec(data=-1, stage=args.pipeline_stages),
                         devices=local_devices(device.type))
        check_batch_divisibility(args.batch_size, mesh,
                                 microbatches=args.microbatches)
        engine = LMPipelineEngine(
            split_stages(args.pipeline_stages * args.virtual_stages, cfg),
            build_optimizer(args), mesh,
            num_microbatches=args.microbatches, compute_dtype=cdt,
            remat=args.remat, schedule=args.pipeline_schedule,
            virtual_stages=args.virtual_stages,
            pad_token_id=cfg.pad_token_id,
        )
    elif args.moe_experts > 0:
        device = initialize_backend(args.device, None)
        mesh = reducer_mesh(args.dcn_slices, expert=args.expert_shards)
        check_batch_divisibility(args.batch_size, mesh)
        if args.moe_dispatch == "hierarchical":
            check_moe_experts_divide(args.moe_experts, mesh)
        engine = ExpertParallelLMEngine(
            gpt_lm_model(cfg, remat=args.remat), build_optimizer(args),
            mesh, compute_dtype=cdt, device=device,
            dispatch=args.moe_dispatch, overlap=args.moe_overlap,
            dcn_compression=args.dcn_compression,
            pad_token_id=cfg.pad_token_id)
    else:
        device = initialize_backend(args.device, None)
        mesh = reducer_mesh(args.dcn_slices, args.seq_shards)
        check_batch_divisibility(args.batch_size, mesh)
        engine = CausalLMSequenceParallelEngine(
            cfg, build_optimizer(args), attention=args.attention,
            compute_dtype=cdt, remat=args.remat, device=device, mesh=mesh,
            grad_reduction=args.grad_reduction, bucket_mb=args.bucket_mb,
            overlap_stages=args.overlap_stages,
            dcn_compression=args.dcn_compression,
            collective_matmul=args.collective_matmul,
        )
    refuse_uncapturable(engine, args.steps_per_dispatch)
    corpus = synthetic_corpus(
        args.vocab_size, args.corpus_tokens, seed=args.corpus_seed
    )
    val_corpus = synthetic_corpus(
        args.vocab_size,
        max(args.corpus_tokens // 8, args.seq_len * args.batch_size),
        seed=args.corpus_seed,              # same chain...
        stream_seed=args.corpus_seed + 1,   # ...another walk
    )
    train = LMLoader(corpus, args.batch_size, args.seq_len,
                     seed=args.corpus_seed)
    val = LMLoader(val_corpus, args.batch_size, args.seq_len,
                   shuffle=False, seed=args.corpus_seed)
    floor = chain_entropy(args.vocab_size, seed=args.corpus_seed)
    if is_primary():
        print(f"corpus loss floor (chain conditional entropy): "
              f"{floor:.4f} nats/token")
    tcfg = TrainerConfig(
        epochs=args.epochs,
        base_lr=args.lr,
        t_max=max(args.epochs - args.epochs // 10, 1),
        warmup_period=max(args.epochs // 10, 1),
        log_file=args.log_file or f"lm_{args.batch_size}.txt",
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        steps_per_epoch=args.steps_per_epoch,
        steps_per_dispatch=args.steps_per_dispatch,
        profile_dir=args.profile_dir,
        checkpoint_format=args.checkpoint_format,
        async_save=args.async_save,
        # Recorded in the checkpoint sidecar so that `cli/serve.py
        # --checkpoint` fails fast, naming the field, when the serve
        # flags disagree with the trained model.
        checkpoint_extra={"gpt_config": {
            "vocab_size": cfg.vocab_size,
            "dim": cfg.dim,
            "num_layers": cfg.num_layers,
            "num_heads": cfg.num_heads,
            "ffn_dim": cfg.ffn_dim,
            "max_position": cfg.max_position,
            "num_experts": cfg.num_experts,
        }},
    )
    trainer = Trainer(engine, train, val, tcfg, seed=0)
    out = trainer.fit()
    out["loss_floor"] = floor
    if is_primary():
        export_metrics_out(args.metrics_out)
    return out


if __name__ == "__main__":
    main()
