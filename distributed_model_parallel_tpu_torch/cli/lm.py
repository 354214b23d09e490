"""Causal-LM pretraining entry point (port of `cli/lm.py`).

GPT next-token pretraining on the deterministic Markov-chain corpus
(`data/lm.py`; its entropy rate is printed as the loss floor), through
`CausalLMSequenceParallelEngine` and the `Trainer` epoch protocol, on
one device:

  python -m distributed_model_parallel_tpu_torch.cli.lm \\
      --attention ulysses_flash               # on the GPU (default)
  python -m distributed_model_parallel_tpu_torch.cli.lm --device cpu \\
      --dim 32 --layers 2 --heads 4 --seq-len 32 -b 4 --epochs 2

The parser keeps the reference's flag surface and adds `--device`
(cuda, the default, or cpu). `--attention ulysses_flash` and
`ring_flash` run the flash-attention kernels. Flags whose features
belong to later port slices (pipeline, sequence shards, MoE, collective
matmul, gradient reducers, remat, the sharded checkpoint format,
multi-step dispatch, profiling, plans and the tuner) are refused with
the slice named (`cli/common.check_lm_args`). The best-val-acc model is
saved to `--checkpoint-dir` with the model's `gpt_config` in its
sidecar (what `cli/serve.py --checkpoint` checks), and `--resume`
continues from it.
"""

from __future__ import annotations

import argparse

import torch

from distributed_model_parallel_tpu_torch.cli.common import (
    add_auto_tune_flags,
    add_checkpoint_flags,
    add_grad_reduction_flags,
    add_metrics_out_flag,
    build_optimizer,
    check_lm_args,
    compute_dtype_from_flag,
    export_metrics_out,
    set_device_numerics,
    setup_metrics_out,
)
from distributed_model_parallel_tpu_torch.data.lm import (
    LMLoader,
    chain_entropy,
    synthetic_corpus,
)
from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
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
                   help="not ported yet (sequence-parallel slice)")
    p.add_argument("--pipeline-stages", default=1, type=int,
                   help="not ported yet (pipeline slice)")
    p.add_argument("--microbatches", default=1, type=int,
                   help="not ported yet (pipeline slice)")
    p.add_argument("--pipeline-schedule", default="gpipe",
                   choices=("gpipe", "1f1b", "interleaved"),
                   help="not ported yet (pipeline slice)")
    p.add_argument("--virtual-stages", default=1, type=int,
                   help="not ported yet (pipeline slice)")
    p.add_argument("--attention", default="ring",
                   choices=("ring", "ring_flash", "ulysses",
                            "ulysses_flash"),
                   help="attention core; *_flash = the flash-attention "
                        "CUDA kernels (ops/flash_attention.py)")
    p.add_argument("--moe-experts", default=0, type=int,
                   help="not ported yet (expert-parallel slice)")
    p.add_argument("--moe-every", default=2, type=int,
                   help="not ported yet (expert-parallel slice)")
    p.add_argument("--moe-dispatch", default="gspmd",
                   choices=("gspmd", "hierarchical"),
                   help="not ported yet (expert-parallel slice)")
    p.add_argument("--moe-overlap", action="store_true",
                   help="not ported yet (expert-parallel slice)")
    p.add_argument("--expert-shards", default=1, type=int,
                   help="not ported yet (expert-parallel slice)")
    p.add_argument("--collective-matmul", action="store_true",
                   help="not ported yet (collective-matmul slice)")
    p.add_argument("--plan", default=None, metavar="SPEC|auto",
                   help="not ported yet (composed-parallel-plan slice)")
    add_grad_reduction_flags(p)
    add_checkpoint_flags(p)
    add_auto_tune_flags(p)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="activation dtype (parameters stay f32)")
    p.add_argument("--remat", action="store_true",
                   help="not ported yet (activation-rematerialization "
                        "slice)")
    p.add_argument("--steps-per-epoch", default=0, type=int)
    p.add_argument("--steps-per-dispatch", default=1, type=int,
                   help="not ported yet (multi-step dispatch slice)")
    p.add_argument("--log-file", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="not ported yet (profiler-capture slice)")
    p.add_argument("--resume", "-r", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    add_metrics_out_flag(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_lm_args(args)
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
    )
    set_device_numerics()
    engine = CausalLMSequenceParallelEngine(
        cfg, build_optimizer(args), attention=args.attention,
        compute_dtype=compute_dtype_from_flag(args.dtype),
        device=args.device,
    )
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
    export_metrics_out(args.metrics_out)
    return out


if __name__ == "__main__":
    main()
