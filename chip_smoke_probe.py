#!/usr/bin/env python3
"""Measurements behind three settings of chip_smoke.py. Run from the
repository root on a machine with a CUDA GPU (about three minutes on an
H100):

    python3 chip_smoke_probe.py          # every part, on the card
    python3 chip_smoke_probe.py fsdp     # only part 3 (or: tally, ep)
    python3 chip_smoke_probe.py --cpu    # part 2 at small widths, gloo
                                         # CPU ranks

1. The profile tally: three BERT_BASE bf16 runs of the DP CLI (`--engine
   tp --model-shards 1`, `--engine gspmd`, `--engine fsdp
   --grad-reduction overlapped`) at phase 12 / 13's flags, then one more
   profiled train step of each (CPU and CUDA activity), read through
   `profile_tally` and through `key_averages()`: the seconds of each
   read and whether the device kernels agree.
2. The int8 dcn bars of phase 16 (c) (S15_INT8_LOSS_REL,
   S15_INT8_PARAM_REL): the phase's gloo-rank runs against N 1 as the
   smoke runs them, then the int8 run again with the dcn stage's decoded
   int8 chunks zeroed (a broken wire), its readings printed rather than
   held.
3. The int8 dcn bars of phase 13 (b) (S12_M2_INT8_LOSS_REL,
   S12_M2_INT8_PARAM_REL): FSDP at N 2 on a dcn 2 mesh with the int8
   wire against N 1 as the smoke runs it, then again with every chunk
   that the weight gather's `coded_ppermute` hops deliver zeroed (a
   broken wire), its readings printed rather than held.
"""

import os
import shutil
import sys
import time

import torch

import chip_smoke as cs

SMALL = ["--device", "cpu", "--vocab-size", "512", "--dim", "64",
         "--heads", "4", "--ffn-dim", "128", "--seq-len", "64", "-b", "8",
         "--layers", "2", "--moe-experts", "8", "--moe-every", "2",
         "--optimizer", "sgd", "--lr", "0.05", "--epochs", "1",
         "--steps-per-epoch", "2"]


def broken_rank(*args, **kw):
    """`chip_smoke.s15_gloo_rank` with every int8 chunk that the
    exchange decodes zeroed."""
    from distributed_model_parallel_tpu_torch.ops import expert_dispatch as xd

    real = xd.wire_decode

    def zeroed(wire, payload, scale, dtype):
        out = real(wire, payload, scale, dtype)
        return torch.zeros_like(out) if wire == "int8" else out

    xd.wire_decode = zeroed
    return cs.s15_gloo_rank(*args, **kw)


def broken_fsdp_rank(*args, **kw):
    """`chip_smoke.s12_gloo_rank` with every chunk that FSDP's coded
    weight gather receives over the cross-slice ring zeroed."""
    from distributed_model_parallel_tpu_torch.parallel import fsdp

    real = fsdp.coded_ppermute

    def zeroed(x, group, perm, wire="none"):
        out = real(x, group, perm, wire)
        return torch.zeros_like(out) if wire == "int8" else out

    fsdp.coded_ppermute = zeroed
    return cs.s12_gloo_rank(*args, **kw)


def fsdp_bars():
    t0 = time.perf_counter()
    cs.s12_fsdp_m2()
    print(f"sound wire: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rank, require = cs.s12_gloo_rank, cs.require
    cs.s12_gloo_rank = broken_fsdp_rank
    cs.require = lambda ok, msg: ok or print("broken wire, not held:",
                                             msg[:3000], flush=True)
    try:
        cs.s12_fsdp_m2()
    finally:
        cs.s12_gloo_rank, cs.require = rank, require
    print(f"broken wire: {time.perf_counter() - t0:.1f} s", flush=True)


def int8_bars(lm, device):
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import ExpertParallelLMEngine

    t0 = time.perf_counter()
    cs.s15_m2(lm, ExpertParallelLMEngine, device)
    print(f"sound wires: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs, rank, require = cs.S15_M2_RUNS, cs.s15_gloo_rank, cs.require
    cs.S15_M2_RUNS = runs[-1:]
    cs.s15_gloo_rank = broken_rank
    cs.require = lambda ok, msg: ok or print("broken wire, not held:",
                                             msg[:2000], flush=True)
    try:
        cs.s15_m2(lm, ExpertParallelLMEngine, device)
    finally:
        cs.S15_M2_RUNS, cs.s15_gloo_rank, cs.require = runs, rank, require
    print(f"broken wire: {time.perf_counter() - t0:.1f} s", flush=True)


def tally_timing():
    from torch.profiler import ProfilerActivity, profile

    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    runs = (("bert_tp_bf16", cs.S11_BERT + cs.S11_ENGINES[0][1],
             cs.S11_STEPS),
            ("bert_gspmd_bf16", cs.S11_BERT + cs.S11_ENGINES[1][1],
             cs.S11_STEPS),
            ("bert_fsdp_overlapped_bf16", cs.S12_BERT + [
                "--engine", "fsdp", "--grad-reduction", "overlapped"],
             cs.S12_STEPS))
    with cs.bert_made_once(), cs.without_saves():
        for name, flags, steps in runs:
            row, _, seen = cs.s10_run(
                data_parallel.main, flags + [
                    "--dtype", "bfloat16", "--checkpoint-dir",
                    cs.scratch_dir(name)], dp_mod._DataParallel, name, steps)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                seen["engine"].train_step(seen["state"], *seen["batch"],
                                          seen["lr"])
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fast, calls = cs.profile_tally(prof)
            t1 = time.perf_counter()
            slow = cs.device_kernels_averaged(prof)
            t2 = time.perf_counter()
            cs.emit({"tally_timing": name, "tally_s": t1 - t0,
                     "key_averages_s": t2 - t1, "device_kernels": len(fast),
                     "kernels_equal": sorted(fast) == sorted(slow),
                     "host_cuda_calls": calls,
                     "step_loss": row["step_loss"]})
            del seen
    torch.distributed.destroy_process_group()


def main() -> int:
    from distributed_model_parallel_tpu_torch.cli import lm

    cpu = "--cpu" in sys.argv[1:]
    parts = [a for a in sys.argv[1:] if a != "--cpu"] or ["tally", "ep",
                                                         "fsdp"]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        with cs.lm_corpus_made_once():
            if cpu:
                cs.S15_M2 = SMALL
                int8_bars(lm, "cpu")
                return 0
            cs.require(torch.cuda.is_available(), "no CUDA GPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if "tally" in parts:
                tally_timing()
            if "ep" in parts:
                int8_bars(lm, "cuda")
            if "fsdp" in parts:
                fsdp_bars()
    finally:
        for directory in cs.SCRATCH:
            shutil.rmtree(directory, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
