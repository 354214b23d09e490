#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`distributed_model_parallel_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU (an H100):

    python3 chip_smoke.py

Phases; any failure exits non-zero (nothing is caught and passed over):

1. Device: require CUDA, print the card's name and power limit
   (nvidia-smi). TF32 is switched off for matmuls and cuDNN, so every
   f32 product on the card is a full-precision one.
2. Build: compile `csrc/int8_matmul.cu` and `csrc/flash_attention.cu`
   with nvcc for sm_90a, one process each, started together, and print
   the build times and each kernel's ptxas registers and spills; the
   flash kernels at their default tiles (K3 at Dh 64) and the int8
   kernel must not spill.
3. Kernel vs plain version on the card, at the four GPT-2-small decode
   projection shapes with M = 8 slots, plus M = 3 and M = 256: identical
   int8 activation codes, scales and outputs (torch.equal); per shape
   the kernel's, the plain version's and `torch.matmul`'s (f32, same
   (M,K)x(K,N); an unquantized product, not the kernel's function, and
   a yardstick the port never calls) times, CUDA events and profiler
   device time, the device time of `torch._int_mm` on the same codes
   (cuBLASLt s8 x s8 -> s32 with M padded to 32: the integer product
   alone, not K4's function, never called by the port), and the bound
   (bytes over 3.35 TB/s vs int8 ops over 1,979 TOP/s).
4. Serving: the port's serve CLI (`cli/serve.py` main) at the full
   width of `GPTConfig()` (vocab 50257, dim 768, 12 layers, 12 heads,
   ffn 3072, 1024 positions; random weights from seed 0): 8 slots,
   prefill_len 128, 16 requests of 16-128 prompt tokens, 32 new tokens
   each, greedy — once f32, once int8. The int8 run must launch the
   kernel 48 times (4 projections x 12 layers) per decode step. Then
   the first decode step at full width, f32 and int8, on the card and
   on the CPU (plain versions) with the same weights and inputs: the
   int8 engine's logits must equal those it gives with the plain GEMM
   swapped in; int8 must lie within INT8_LOGIT_REL of f32 on both; f32
   on the card must match the CPU within F32_CARD_VS_CPU; int8 card and
   CPU codes may differ only by rounding ties that start from f32
   noise, and their logits by less than int8 differs from f32. A small
   model's logits on the card must match the CPU's tightly.
   The flash-attention kernels K1-K3 (`csrc/flash_attention.cu`) are
   checked against their plain versions, f32 and bf16, at the training
   path's shape (B 8, T 1024, H 12, Dh 64, causal, all-true key mask),
   at T 1000 (a ragged tile) and with a batch row whose keys are all
   masked, K3 at every tile `TILES` lists; at the path shape each is
   timed (CUDA events and profiler),
   beside its plain version, SDPA (forward; forward + backward, and the
   backward's device time, which computes dq, dk and dv together; a
   yardstick the port never calls), its bound (f32 67 / bf16 989
   TFLOP/s vs 3.35 TB/s) and a sweep over every tile `TILES` lists.
5. LM training: the port's LM CLI (`cli/lm.py` main) at GPT-2-small
   width (vocab 50257, dim 768, 12 layers, 12 heads, ffn 3072, T 1024,
   batch 8; random weights from seed 0), 4 train steps and 1 validation
   batch, `--attention ulysses_flash` in f32 and bf16, then a 2-layer
   `--attention ring_flash` run (the external-LSE entry points). Exact
   launch counts (K1 = layers x (steps + val batches), K2 = K3 = layers
   x steps), finite losses, per-step loss and ms, tokens/s, and one
   profiled step's device idle share and per-kernel device time. Then
   one train step of a small GPT on the card against the CPU (loss and
   every gradient leaf), and at full width the kernels against the
   plain attention swapped in on the card.
6. Data-parallel training: the port's DP CLI (`cli/data_parallel.py`
   main) on MobileNetV2 (the CIFAR `CFG` widths, about 2.2 M
   parameters), global batch 512, SyntheticTextures (50,000 train and
   10,000 val images at CIFAR-10's shapes, made once for the three
   runs), lr 0.4, `-j 8`, 30 train steps and the validation pass, as
   `--engine ddp` f32, `--engine ddp --dtype bfloat16` and `--engine
   gspmd` f32, on a world of one NCCL rank. cudnn.benchmark stays off
   (the default). Per run one JSON line: synchronized ms/step (mean
   over steps 6-30), images/s, the trainer's wall time and data wait
   per batch, the native augment's host ms per batch, one profiled
   step's device busy ms, idle share, kernels a step and top five
   kernel families, the peak of `torch.cuda.max_memory_allocated`, the
   first and last train loss. Checks: the process group is NCCL at
   world 1 and the gradient all-reduce ran once a step; the native
   augment built and made every train batch; losses finite and falling.
   Then, f32 and bf16, the forward + backward device ms a step of each
   layer kind at batch 512, each layer alone (depthwise convs, other
   convs, the port's BN, cuDNN's fused BN as a yardstick), and one
   tinycnn DDP step on the card against the CPU (loss and every
   parameter, rtol 1e-5, TF32 off). No TPU kernel lies on this
   path: convolutions are cuDNN's, the all-reduce NCCL's.
7. Checkpoint and resume (every CLI run of phases 5-7 writes its
   checkpoints under one temporary directory in the working directory,
   deleted at the end):
   (a) the f32 determinism probe: a MobileNetV2 DDP step at batch 512,
   the same batches twice with cuDNN free to choose its algorithms and
   twice with `cudnn.deterministic` (the CLIs' setting), per-step
   losses, ms a step and the convolution kernels of each, then one step
   under `torch.use_deterministic_algorithms(True, warn_only=True)`;
   the deterministic runs must be equal. Then the DP CLI, MobileNetV2
   f32, two epochs of 60 steps: `--engine ddp` twice and `--engine
   gspmd` once (equal per-step losses), one epoch then `--resume` to
   two (the straight run's losses and epoch-1 record), each epoch's
   validation on 10,000 images, save / restore ms and file bytes.
   (b) the LM CLI at GPT-2-small width, `ulysses_flash` f32, 2 + 2
   steps across `--resume` against 4 straight: equal per-step losses,
   exact K1-K3 launches, save / restore ms and bytes.
   (c) `serve --checkpoint` on (b)'s directory, f32 and int8 (K4 48
   times a decode step), and the first decode step's int8-vs-f32 logits
   on those trained weights.
8. One `{"kernels": [...]}` JSON line (int8_matmul, flash_fwd,
   flash_bwd_dq, flash_bwd_dkv; `launches_slice6` counts phase 7's
   runs), then the nvidia-smi line, then the last line `{"ok": true,
   "device": {...}}`. Each phase prints its seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
DECODE_SHAPES = (  # (name, K, N) of one GPT-2-small decoder block
    ("attn.qkv", 768, 2304), ("attn.out", 768, 768),
    ("ffn.in", 768, 3072), ("ffn.out", 3072, 768),
)
EXTRA_SHAPES = ((3, 768, 768), (256, 768, 3072))
SLOTS = 8
SERVE_FLAGS = [
    "--device", "cuda", "--vocab-size", "50257", "--dim", "768",
    "--layers", "12", "--heads", "12", "--ffn-dim", "3072",
    "--num-slots", str(SLOTS), "--max-len", "1024", "--prefill-len", "128",
    "--num-requests", "16", "--prompt-len-min", "16",
    "--prompt-len-max", "128", "--max-new-tokens", "32", "--seed", "0",
]
LAYERS = 12
DEPTHS = (1, 2, 4, 8)  # cut depths for the int8-vs-f32 gap, beside LAYERS
# Ceiling on the first decode step's int8-vs-f32 logit gap, as
# max|int8 - f32| / max|f32| at full width, on the card and on the CPU.
# It is set from this script's readings, not from a reference bar (the
# full-width step fails both of the reference's: the single-GEMM 2e-2
# of tests/test_quant_matmul.py:142 and the elementwise decode-logit
# check of tests/test_serving.py, rtol 5e-2 atol 1e-2; both are printed).
# On one H100 the gap read 2.457e-2 on the card and 2.398e-2 on the CPU,
# and f32 rounding noise alone moved int8 logits by 1.62e-2 of max|logit|
# between card and CPU; the ceiling is the card reading plus that move.
# The gap is the reference's own: the JAX engine reads 2.2251e-2 against
# the port's 2.2250e-2 on the same CPU-drawn weights (int8_gap_vs_jax.py).
INT8_LOGIT_REL = 4.1e-2
# f32 logits on the card against the port's CPU run at full width: read
# 3.2e-6 (prefill) and 2.6e-6 (decode) on one H100; ten times that.
F32_CARD_VS_CPU = 3e-5
# Relative input difference that still counts as f32 rounding noise:
# card and CPU int8 GEMM inputs read up to 5.3e-7 before the first
# flipped code.
F32_NOISE_REL = 2e-6


# Checkpoints the CLI runs write (they save the best-val-acc model by
# default) go under one temporary directory in the working directory,
# deleted when the script ends.
SCRATCH = []


def scratch_dir(name: str) -> str:
    if not SCRATCH:
        SCRATCH.append(tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                        dir=os.getcwd()))
    return os.path.join(SCRATCH[0], name)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(m: int, k: int, n: int):
    """Least time for y(M,N) f32 = int8 GEMM of x(M,K) f32 against a
    prepared (N,K) int8 weight + (N,) f32 scales: each input read once,
    the output written once, against 2*M*N*K int8 operations."""
    nbytes = 4 * m * k + n * k + 4 * n + 4 * m * n
    ops = 2 * m * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, ops


def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time per call over `iters` calls cycling through
    `arg_sets` (copies whose weights together exceed the 50 MB L2, so
    each call finds its weight in HBM as a decode step does)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, iters: int, key="int8_matmul_kernel"):
    """Mean device time per call of the device kernels whose name holds
    `key` (of every kernel `fn` launches when `key` is None), from
    torch.profiler's CUDA activity: the part of `time_ms` that is not
    host launch overhead. A profile that records no such kernel (seen
    now and then on the card) is taken again, twice at most; None if
    none records one."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        total_us = sum(t for t, _, name in device_kernels(prof)
                       if key is None or key in name)
        if total_us:
            return total_us / iters / 1e3
    return None


def copies_for(nbytes: int) -> int:
    return max(2, min(400, math.ceil(120e6 / nbytes)))


def check_shape(qm, m, k, n, seed):
    """Phase 3 at one shape: codes, scales and outputs vs the plain
    version, then the four timings."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = 0.02 * torch.randn((k, n), generator=g, device="cuda")
    wq_t, wscale = qm.prepare_weight(w)
    y, codes, scales = qm.int8_matmul(x, wq_t, wscale, return_codes=True)
    torch.cuda.synchronize()
    ref_codes, ref_scales = qm.quantize_rows(x)
    ref = qm.int8_matmul_plain(x, wq_t, wscale)
    require(torch.equal(codes, ref_codes),
            f"int8 codes differ from the plain version at {(m, k, n)}")
    require(torch.equal(scales, ref_scales),
            f"activation scales differ at {(m, k, n)}")
    err = float((y - ref).abs().max())
    require(torch.equal(y, ref), f"int8 outputs differ from the plain "
            f"version at {(m, k, n)} by up to {err:.3e}")
    kcopies = [(x, *qm.prepare_weight(w.roll(i, 1)))
               for i in range(copies_for(n * k))]
    fcopies = [(x, w.roll(i, 1)) for i in range(copies_for(4 * n * k))]
    kernel_ms = time_ms(qm.int8_matmul, kcopies, 300)
    kernel_device_ms = device_ms(qm.int8_matmul, kcopies, 60)
    plain_ms = time_ms(qm.int8_matmul_plain, kcopies, 30)
    library_ms = time_ms(torch.matmul, fcopies, 300)
    library_device_ms = device_ms(torch.matmul, fcopies, 60, None)
    int_mm_device_ms = None
    if k % 8 == 0 and n % 8 == 0:  # cuBLASLt's shape rule for _int_mm
        padded = torch.zeros((max(32, m), k), dtype=torch.int8,
                             device="cuda")
        padded[:m] = codes
        icopies = [(padded, wq.t()) for _, wq, _ in kcopies]
        int_mm_device_ms = device_ms(torch._int_mm, icopies, 60, None)
    bound_ms, bound_by, nbytes, ops = bound(m, k, n)
    return {"M": m, "K": k, "N": n, "kernel_ms": kernel_ms,
            "kernel_device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "int_mm_device_ms": int_mm_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "max_abs_err": err}


def serve_run(serve, flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(flags)
    return out


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def first_step(eng, p, prompts, tokens):
    """Prefill every slot, then one decode step with `tokens` fed in:
    (prefill next-token logits (slots, vocab), decode logits (slots,
    vocab)), both on the host."""
    cache = eng.init_cache()
    rows = []
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, nl = eng.prefill(p, cache, ids, length, slot)
        rows.append(nl)
    active = torch.ones(len(prompts), dtype=torch.bool, device=eng.device)
    logits = eng.decode_step(p, cache, tokens.to(eng.device), active)[1]
    return torch.stack(rows).cpu(), logits.cpu()


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def plain_gemm(qm):
    """Route the engine's int8 GEMM through the plain version
    (`quant_matmul` looks `int8_matmul` up in its module)."""
    return patched(qm, "int8_matmul",
                   lambda x, wq_t, ws: qm.int8_matmul_plain(x, wq_t, ws))


def recording_gemm(qm, inputs):
    """Record, as (M, K) host copies, the input of every projection the
    int8 policy runs."""
    call = qm.QuantMatmul.__call__

    def recorded(self, h, w, b):
        inputs.append(h.detach().reshape(-1, h.shape[-1]).cpu())
        return call(self, h, w, b)
    return patched(qm.QuantMatmul, "__call__", recorded)


def int8_vs_f32(got, ref):
    """max|int8 - f32| / max|f32|, and the reference's elementwise
    decode-logit check (tests/test_serving.py: assert_allclose rtol 5e-2,
    atol 1e-2) as its worst excess over that allowance (<= 0 passes)."""
    diff = (got - ref).abs()
    excess = float((diff - (1e-2 + 5e-2 * ref.abs())).max())
    return {"rel": float(diff.max() / ref.abs().max()),
            "max_abs": float(diff.max()),
            "max_abs_f32_logit": float(ref.abs().max()),
            "reference_allclose_excess": excess,
            "passes_reference_allclose": excess <= 0}


def code_flips(qm, card_inputs, cpu_inputs):
    """Per int8 GEMM of one decode step (layer-major: qkv, out, ffn.in,
    ffn.out), the card's input against the CPU's: the input's relative
    difference and how many activation codes differ, and by how much."""
    rows = []
    for i, (xg, xc) in enumerate(zip(card_inputs, cpu_inputs)):
        dq = (qm.quantize_rows(xg)[0].int()
              - qm.quantize_rows(xc)[0].int()).abs()
        rows.append({"call": i,
                     "x_rel_diff": float((xg - xc).abs().max()
                                         / xc.abs().max()),
                     "flipped_codes": int((dq > 0).sum()),
                     "max_code_diff": int(dq.max())})
    return rows


def first_step_readings(serve, engine_cls, cfg_cls, qm):
    """The first decode step at full width, on the same weights, prompts
    and fed tokens: f32 and int8 engines on the card and on the CPU (the
    plain versions), the int8 engine on the card once more with the
    plain GEMM swapped in, and the int8-vs-f32 gap on the card at cut
    depths. Readings are printed before they are checked."""
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    cfg = cfg_cls(vocab_size=50257, dim=768, num_layers=LAYERS,
                  num_heads=12, ffn_dim=3072, max_position=1024,
                  dropout_rate=0.0, pad_token_id=0)
    kw = dict(num_slots=SLOTS, max_len=1024, prefill_len=128)
    prompts = [r.prompt for r in serve.synthetic_trace(args)[:SLOTS]]
    engines = {(mode, dev): engine_cls(cfg, compute_dtype=mode, device=dev,
                                       **kw)
               for mode in ("f32", "int8") for dev in ("cuda", "cpu")}
    host = tree_to(engines["f32", "cuda"].init_params(0), "cpu")
    params = {key: eng.place_params(host) for key, eng in engines.items()}

    def run(mode, dev, tokens):
        return first_step(engines[mode, dev], params[mode, dev], prompts,
                          tokens)

    pre_f32, f32 = run("f32", "cuda", torch.zeros(SLOTS, dtype=torch.int64))
    tokens = pre_f32.argmax(-1)
    f32 = run("f32", "cuda", tokens)[1]
    card_inputs, cpu_inputs = [], []
    with recording_gemm(qm, card_inputs):
        i8 = run("int8", "cuda", tokens)[1]
    with plain_gemm(qm):
        i8_plain = run("int8", "cuda", tokens)[1]
    cpu_pre_f32, cpu_f32 = run("f32", "cpu", tokens)
    with recording_gemm(qm, cpu_inputs):
        cpu_i8 = run("int8", "cpu", tokens)[1]

    by_depth = {}
    for depth in DEPTHS:
        cut = dataclasses.replace(cfg, num_layers=depth)
        sub = dict(host, blocks={str(i): host["blocks"][str(i)]
                                 for i in range(depth)})
        got = []
        for mode in ("f32", "int8"):
            eng = engine_cls(cut, compute_dtype=mode, device="cuda", **kw)
            got.append(first_step(eng, eng.place_params(sub), prompts,
                                  tokens)[1])
        by_depth[depth] = int8_vs_f32(got[1], got[0])["rel"]

    flips = code_flips(qm, card_inputs, cpu_inputs)
    first = next((r for r in flips if r["flipped_codes"]), None)
    readings = {
        "int8_vs_f32_card": int8_vs_f32(i8, f32),
        "int8_vs_f32_cpu": int8_vs_f32(cpu_i8, cpu_f32),
        "int8_vs_f32_card_rel_by_depth": by_depth,
        "kernel_vs_plain_engine_max_abs": float((i8 - i8_plain).abs().max()),
        "card_vs_cpu_max_abs": {
            "f32_prefill": float((pre_f32 - cpu_pre_f32).abs().max()),
            "f32_decode": float((f32 - cpu_f32).abs().max()),
            "int8_decode": float((i8 - cpu_i8).abs().max()),
        },
        "card_vs_cpu_int8_gemm_inputs": {
            "gemms": len(flips),
            "gemms_with_flipped_codes": sum(bool(r["flipped_codes"])
                                            for r in flips),
            "flipped_codes": sum(r["flipped_codes"] for r in flips),
            "codes": sum(x.numel() for x in cpu_inputs),
            "first_flipped": first,
            "per_gemm": flips,
        },
    }
    emit({"first_decode_step_full_width": readings})

    require(i8.shape == (SLOTS, 50257) and bool(torch.isfinite(i8).all())
            and bool(torch.isfinite(f32).all()),
            "first decode step logits not finite / wrong shape")
    require(len(flips) == 4 * LAYERS, f"{len(flips)} int8 GEMMs recorded")
    kp = readings["kernel_vs_plain_engine_max_abs"]
    require(kp <= 1e-5, f"int8 engine logits with the kernel differ from "
            f"those with the plain GEMM by {kp:.3e}")
    for where in ("card", "cpu"):
        rel = readings[f"int8_vs_f32_{where}"]["rel"]
        require(rel <= INT8_LOGIT_REL, f"int8 first-step logits on the "
                f"{where} off by {rel:.3e} of max|logit| (ceiling "
                f"{INT8_LOGIT_REL})")
    cvc = readings["card_vs_cpu_max_abs"]
    for key in ("f32_prefill", "f32_decode"):
        require(cvc[key] <= F32_CARD_VS_CPU, f"{key} logits on the card "
                f"differ from the CPU's by {cvc[key]:.3e} (tolerance "
                f"{F32_CARD_VS_CPU})")
    # The int8 card and CPU runs quantize f32 inputs that differ by f32
    # rounding; a code whose x / scale sits within that noise of a
    # half-integer rounds the other way. Such flips must start from f32
    # noise (the first flipped GEMM's inputs agree to F32_NOISE_REL and
    # its codes move by one), and the logits they move must stay inside
    # the int8 contract's own gap to f32.
    require(first is None or (first["x_rel_diff"] <= F32_NOISE_REL
                              and first["max_code_diff"] == 1),
            f"first card-vs-CPU code flip is not a rounding tie: {first}")
    gap = readings["int8_vs_f32_card"]["max_abs"]
    require(cvc["int8_decode"] <= gap, f"int8 logits on the card differ "
            f"from the CPU's by {cvc['int8_decode']:.3e}, more than int8 "
            f"differs from f32 ({gap:.3e})")
    breakdown = {
        name: decode_breakdown(engines[name, "cuda"], params[name, "cuda"],
                               tokens.cuda(), torch.ones(
                                   SLOTS, dtype=torch.bool, device="cuda"),
                               prompts)
        for name in ("f32", "int8")}
    return readings, breakdown


def device_kernels(prof):
    """(device us, launches, name) of every device kernel a profile
    holds. Device-side entries only: a CPU op's own entry repeats the
    device time of the kernels it launched."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0
            and getattr(e, "device_type", None) == DeviceType.CUDA]


def decode_breakdown(eng, p, tokens, active, prompts, steps=10):
    """Where one decode step's time goes at full width, all slots
    active: host wall time per step (synchronized), device busy time per
    step and the int8 kernel's part of it (torch.profiler), and the
    number of device kernels per step."""
    from torch.profiler import ProfilerActivity, profile

    cache = eng.init_cache()
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, _ = eng.prefill(p, cache, ids, length, slot)
    eng.decode_step(p, cache, tokens, active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode_step(p, cache, tokens, active)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.decode_step(p, cache, tokens, active)
        torch.cuda.synchronize()
    by_kernel = device_kernels(prof)
    busy = sum(t for t, _, _ in by_kernel)
    launches = sum(n for _, n, _ in by_kernel)
    kernel = sum(t for t, _, key in by_kernel if "int8_matmul_kernel" in key)
    busy_ms = busy / steps / 1e3
    top = [{"kernel": key[:80], "ms_per_step": t / steps / 1e3,
            "launches_per_step": n / steps}
           for t, n, key in sorted(by_kernel, reverse=True)[:8]]
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy else None,
            "int8_kernel_ms_per_step": kernel / steps / 1e3,
            "device_kernels_per_step": launches / steps,
            "top_device_kernels": top}


def small_model_matches_cpu(engine_cls, cfg_cls, init_params):
    """A small GPT on the card vs the port's CPU run (plain versions):
    prefill + 3 lockstep decode steps, f32 at 1e-4 and int8 at 5e-3."""
    cfg = cfg_cls(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                  ffn_dim=256, max_position=32, dropout_rate=0.0,
                  pad_token_id=0)
    host = init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 97, (n,), generator=g).numpy()
               for n in (3, 7, 5, 12)]
    worst = {}
    for mode, tol in (("f32", 1e-4), ("int8", 5e-3)):
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = engine_cls(cfg, num_slots=4, max_len=32, prefill_len=16,
                             compute_dtype=mode, device=dev)
            p = eng.place_params(host)
            cache = eng.init_cache()
            rows = []
            for slot, prompt in enumerate(prompts):
                ids, length = eng.pad_prompt(prompt)
                cache, nl = eng.prefill(p, cache, ids, length, slot)
                rows.append(nl.cpu())
            runs[dev] = (eng, p, cache, torch.stack(rows))
        err = float((runs["cuda"][3] - runs["cpu"][3]).abs().max())
        tokens = runs["cpu"][3].argmax(-1)
        active = torch.ones(4, dtype=torch.bool)
        for _ in range(3):
            out = {}
            for dev, (eng, p, cache, _) in runs.items():
                _, lg = eng.decode_step(p, cache, tokens.to(dev),
                                        active.to(dev))
                out[dev] = lg.cpu()
            err = max(err, float((out["cuda"] - out["cpu"]).abs().max()))
            tokens = out["cpu"].argmax(-1)
        require(err <= tol, f"small {mode} model: GPU vs CPU logits differ "
                            f"by {err:.3e} (tolerance {tol})")
        worst[mode] = err
    return worst


# ---------------------------------------------------------------------
# Flash attention (K1-K3) and LM training


F32_OPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# How each flash kernel is built (the kernels line's "design").
FLASH_DESIGN = {
    "flash_fwd": "bf16: mma.sync m16n8k16 (q fragments resident, p fed "
                 "back in registers); f32: FFMA on 4 x keys/8 register "
                 "tiles; cp.async 2-stage K/V ring",
    "flash_bwd_dq": "bf16: mma.sync m16n8k16 (q, dO fragments resident, "
                    "dS fed back in registers); f32: FFMA on 4 x keys/8 "
                    "register tiles; cp.async 2-stage K/V ring",
    "flash_bwd_dkv": "bf16: mma.sync m16n8k16, 16 keys a warp (K, V "
                     "fragments resident to Dh 64), S^T/dP^T in registers, "
                     "P^T and dS^T fed back as A operands of dV and dK; "
                     "f32: FFMA on 4-key x rows/8 register tiles; cp.async "
                     "2-stage q/dO ring with LSE/delta, heaviest key tiles "
                     "first",
}
INT8_DESIGN = ("a cluster of 2 (K <= 1024) or 8 blocks splits K for 64 "
               "columns x 8 rows (row absmax and int32 partial sums meet "
               "in distributed shared memory), 16-byte weight loads "
               "issued first, x quantized once per cluster, __dp4a")
FLASH_KERNELS = (  # wrapper, device kernel name, TPU kernel it replaces
    ("flash_fwd", "flash_fwd_kernel",
     "distributed_model_parallel_tpu/ops/pallas_attention.py:260"),
    ("flash_bwd_dq", "flash_bwd_dq_kernel",
     "distributed_model_parallel_tpu/ops/pallas_attention.py:420"),
    ("flash_bwd_dkv", "flash_bwd_dkv_kernel",
     "distributed_model_parallel_tpu/ops/pallas_attention.py:459"),
)
# (name, B, T, H, Dh, mask kind): the training path's shape (GPT-2-small
# width, batch 8, all-true key mask from pad_token_id=0, causal), a
# length that is a multiple of 8 but not of the tile, and a batch row
# whose keys are all masked.
FLASH_CASES = (
    ("path", 8, 1024, 12, 64, "all"),
    ("ragged_tile", 2, 1000, 12, 64, "random"),
    ("masked_row", 2, 256, 12, 64, "row"),
)
# Kernel vs plain version on the card, causal, same inputs. Both sum
# f32 products in another order; f32: rtol 1e-4, atol 2e-5 (the worst
# reading on one H100 was 2.9e-6, dk/dv). bf16: outputs are rounded to
# bf16 (2**-8 relative), and p / dS values an f32 ulp apart may round to
# neighbouring bf16 values before their products: rtol/atol 2e-2 (worst
# reading 7.8e-3, one bf16 ulp of a value near 2). LSE is f32 in both
# dtypes: 1e-5 (worst reading 2.4e-6).
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LM_BASE = [
    "--device", "cuda", "--vocab-size", "50257", "--dim", "768",
    "--heads", "12", "--ffn-dim", "3072", "--seq-len", "1024", "-b", "8",
]
LM_FLAGS = LM_BASE + ["--epochs", "1", "--steps-per-epoch", "4"]
LM_RUNS = (  # (name, layers, extra flags)
    ("f32", 12, ["--attention", "ulysses_flash", "--dtype", "float32"]),
    ("bf16", 12, ["--attention", "ulysses_flash", "--dtype", "bfloat16"]),
    ("ring_flash_f32", 2, ["--attention", "ring_flash",
                           "--dtype", "float32"]),
)
LM_STEPS, LM_VAL_BATCHES, LM_TOKENS = 4, 1, 8 * 1024
# One train step, f32, as max|d|/max|ref| over the loss and every
# compared gradient leaf. A small GPT on the card (kernels) against the
# CPU (plain versions) read 1.0e-7 (loss) and 7.1e-7 (worst leaf) on one
# H100; the full-width step with the kernels against the plain attention
# on the card read 0.0 (loss) and 1.3e-6 (worst attention projection
# gradient). Both bars are about ten times the worst reading: f32 sums in
# another order, nothing else differs.
SMALL_CARD_VS_CPU = 1e-5
FULL_KERNEL_VS_PLAIN = 1e-5


def flash_inputs(b, t, h, dh, kind, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, h, dh), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
    if kind == "random":
        mask = torch.rand((b, t), generator=g, device="cuda") > 0.2
        mask[:, 0] = True
    elif kind == "row":
        mask[1] = False
    return q, k, v, do, mask


def visible_pairs(mask, h) -> int:
    """Causal (q, k) pairs with a valid key, over batch and heads: the
    work this run's data needs."""
    t = mask.shape[1]
    tri = torch.ones((t, t), dtype=torch.bool, device=mask.device).tril()
    per_b = (tri[None] & mask[:, None, :]).sum()
    return int(per_b) * h


def flash_bound(kind, b, t, h, dh, dtype, pairs):
    """Least time of one launch: each input read once, each output
    written once, against its flops (4, 6 or 8 x Dh per visible pair)
    at the dtype's peak."""
    act = b * t * h * dh * (4 if dtype == torch.float32 else 2)
    stats, maskb = b * h * t * 4, b * t
    nbytes, per_pair = {
        "flash_fwd": (4 * act + maskb + stats, 4),
        "flash_bwd_dq": (5 * act + maskb + 2 * stats, 6),
        "flash_bwd_dkv": (6 * act + maskb + 2 * stats, 8),
    }[kind]
    ops = per_pair * dh * pairs
    peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def flash_case(fa, case, dtype):
    """K1 (with and without LSE), K2 and K3 against their plain versions
    at one case; returns the max errors per kernel and the tensors the
    timings reuse."""
    name, b, t, h, dh, kind = case
    q, k, v, do, mask = flash_inputs(b, t, h, dh, kind, dtype, seed=t + dh)
    kw = dict(scale=1.0 / math.sqrt(dh), causal=True)
    out, lse = fa.flash_fwd(q, k, v, mask, need_lse=True, **kw)
    out_nolse, none = fa.flash_fwd(q, k, v, mask, **kw)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, mask, need_lse=True, **kw)
    delta = fa.flash_delta(do, ref_out)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, mask, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, mask, **kw)
    torch.cuda.synchronize()
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, mask, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            mask, **kw)
    # K3 at every tile it is built for (the default's result is dk, dv)
    dkv_tiles = {tile: fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, mask,
                                        tile=tile, **kw)
                 for tile in fa.TILES["flash_bwd_dkv"][dh]}
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]

    def err(a, r):
        fin = torch.isfinite(r)
        require(bool((torch.isfinite(a) == fin).all())
                and bool((a[~fin] == r[~fin]).all()),
                f"{name} {dtype}: non-finite values differ from the plain "
                f"version's")
        return float((a.float() - r.float())[fin].abs().max())

    errs = {"flash_fwd": max(err(out, ref_out), err(out_nolse, ref_out)),
            "flash_fwd_lse": err(lse, ref_lse),
            "flash_bwd_dq": err(dq, ref_dq),
            "flash_bwd_dkv": max(err(dk, ref_dk), err(dv, ref_dv))}
    by_tile = {tile_key(tl): max(err(x, ref_dk), err(y, ref_dv))
               for tl, (x, y) in dkv_tiles.items()}
    errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], *by_tile.values())
    emit({"flash_check": name, "dtype": str(dtype).split(".")[-1],
          "shape": [b, t, h, dh], "max_abs_err": errs,
          "flash_bwd_dkv_by_tile": by_tile})
    require(none is None, "flash_fwd returned an LSE it was not asked for")
    pairs = [(out, ref_out), (out_nolse, ref_out), (dq, ref_dq),
             (dk, ref_dk), (dv, ref_dv)]
    for tk, tv in dkv_tiles.values():
        pairs += [(tk, ref_dk), (tv, ref_dv)]
    for got, want in pairs:
        torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    if kind == "row":
        require(bool((out[1] == 0).all()) and bool(torch.isinf(lse[1]).all())
                and bool((dq[1] == 0).all())
                and all(bool((x[1] == 0).all())
                        for pair in [(dk, dv), *dkv_tiles.values()]
                        for x in pair),
                "a row with no valid key must give out 0, LSE +inf and "
                "zero gradients")
    return errs, (q, k, v, do, mask, ref_lse, delta, kw)


def flash_timings(fa, dtype, tensors):
    """At the path shape: per kernel the CUDA-event time per launch
    (host launch included), its device time (profiler), the plain
    version's time and the bound; SDPA (forward; forward + backward; the
    backward's device time) as the library yardstick the port never
    calls; the sweep over every tile TILES lists at Dh 64."""
    import torch.nn.functional as F

    q, k, v, do, mask, lse, delta, kw = tensors
    b, t, h, dh = q.shape
    pairs = visible_pairs(mask, h)
    calls = {
        "flash_fwd": lambda **x: fa.flash_fwd(q, k, v, mask, need_lse=True,
                                              **kw, **x),
        "flash_bwd_dq": lambda **x: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                    mask, **kw, **x),
        "flash_bwd_dkv": lambda **x: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, mask, **kw, **x),
    }
    plains = {
        "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, mask, need_lse=True,
                                                **kw),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      mask, **kw),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, mask, **kw),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    fq, fk, fv = (x.clone().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
            (qg, kg, vg), dot)

    def flash_fwd_bwd():
        fa.flash_attention(fq, fk, fv, mask, causal=True).backward(do)

    rows = {}
    for name, dev_key, _ in FLASH_KERNELS:
        bound_ms, bound_by, nbytes, ops = flash_bound(name, b, t, h, dh,
                                                      dtype, pairs)
        sweep = {tile_key(tile): device_ms(
            lambda: calls[name](tile=tile), [()], 10, dev_key)
            for tile in fa.TILES[name][dh]}
        rows[name] = {
            "ms": time_ms(calls[name], [()], 20),
            "device_ms": device_ms(calls[name], [()], 10, dev_key),
            "plain_ms": time_ms(plains[name], [()], 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": ops, "visible_pairs": pairs,
            "tile": tile_key(fa.DEFAULT_TILE[name][dtype][dh]),
            "tile_sweep_device_ms": sweep,
        }
    fwd_dev = device_ms(sdpa_fwd, [()], 10, None)
    both_dev = device_ms(sdpa_fwd_bwd, [()], 10, None)
    rows["flash_fwd"]["library_ms"] = time_ms(sdpa_fwd, [()], 20)
    rows["flash_fwd"]["library_device_ms"] = fwd_dev
    yard = {"sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, [()], 10),
            # SDPA's backward alone: dq, dk and dv together in one call
            "sdpa_bwd_device_ms": None if None in (fwd_dev, both_dev)
            else both_dev - fwd_dev,
            "flash_attention_fwd_bwd_ms": time_ms(flash_fwd_bwd, [()], 10)}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["library_ms"] = None  # no one PyTorch call computes it
        rows[name].update(yard)
    emit({"flash_timings": str(dtype).split(".")[-1], "shape": [b, t, h, dh],
          **rows})
    return rows


def tile_key(tile) -> str:
    """"64x64" for a (rows, keys) tile, "64" for K3's."""
    return "x".join(map(str, tile)) if isinstance(tile, tuple) else str(tile)


def flash_phase(fa):
    errs, timings = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            e, tensors = flash_case(fa, case, dtype)
            for key, val in e.items():
                errs[key] = max(errs.get(key, 0.0), val)
            if case[0] == "path":
                timings[dtype] = flash_timings(fa, dtype, tensors)
            del tensors
    return errs, timings


def reset_counts(fa, qm) -> None:
    for name, _, _ in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    qm.int8_matmul.launches = 0


def counts(fa) -> dict:
    return {name: getattr(fa, name).launches for name, _, _ in FLASH_KERNELS}


def recorded_run(main, flags, cls):
    """`main(flags)`, its stdout captured, with `cls.train_step` timed
    (synchronized) and each step's loss recorded: (result, steps, the
    engine, state, batch and lr of the last step)."""
    steps, seen = [], {}
    train_step = cls.train_step

    def recorded(self, ts, *batch_lr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = train_step(self, ts, *batch_lr)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": float(m["loss_sum"] / m["count"])})
        seen.update(engine=self, state=ts, batch=batch_lr[:-1],
                    lr=batch_lr[-1])
        return ts, m

    with patched(cls, "train_step", recorded), \
            contextlib.redirect_stdout(io.StringIO()):
        out = main(flags)
    return out, steps, seen


def lm_run(lm, engine_cls, fa, qm, name, layers, extra):
    """One training run through the port's LM CLI (`cli/lm.py` main);
    each train step is timed (synchronized) and its loss recorded."""
    directory = scratch_dir(f"lm_{name}")
    reset_counts(fa, qm)
    out, steps, seen = recorded_run(
        lm.main, LM_FLAGS + ["--layers", str(layers)] + extra + [
            "--checkpoint-dir", directory], engine_cls)
    got = counts(fa)
    shutil.rmtree(directory)  # its best-acc checkpoint is not needed
    want = {"flash_fwd": layers * (LM_STEPS + LM_VAL_BATCHES),
            "flash_bwd_dq": layers * LM_STEPS,
            "flash_bwd_dkv": layers * LM_STEPS}
    require(got == want, f"LM run {name}: kernel launches {got}, want {want}")
    require(qm.int8_matmul.launches == 0, f"LM run {name} launched int8")
    hist = out["history"][0]
    losses = [s["loss"] for s in steps] + [hist["train"]["loss"],
                                           hist["val"]["loss"]]
    require(len(steps) == LM_STEPS and all(map(math.isfinite, losses)),
            f"LM run {name}: {len(steps)} steps, losses {losses}")
    warm = steps[1:]
    ms = sum(s["ms"] for s in warm) / len(warm)
    row = {"lm_run": name, "layers": layers, "flags": extra,
           "launches": got, "step_ms": [s["ms"] for s in steps],
           "step_loss": [s["loss"] for s in steps],
           "ms_per_step": ms, "tokens_per_s": LM_TOKENS / ms * 1e3,
           "train_loss": hist["train"]["loss"],
           "val_loss": hist["val"]["loss"], "loss_floor": out["loss_floor"]}
    row.update(step_breakdown(seen, ms))
    emit(row)
    return row


def profiled_step(seen):
    """`device_kernels` of one more train step of the engine, state,
    batch and lr a recorded run last saw, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seen["engine"].train_step(seen["state"], *seen["batch"], seen["lr"])
        torch.cuda.synchronize()
    return device_kernels(prof)


def step_breakdown(seen, wall_ms):
    """One more train step under torch.profiler: device busy time, the
    idle share against the unprofiled step wall time, and each flash
    kernel's device ms within the step."""
    top = profiled_step(seen)
    busy = sum(t for t, _, _ in top)
    per_kernel = {dev_key: sum(t for t, _, key in top if dev_key in key)
                  for _, dev_key, _ in FLASH_KERNELS}
    busy_ms = busy / 1e3
    return {"device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "flash_kernel_device_ms": {k: v / 1e3
                                       for k, v in per_kernel.items()},
            "flash_share_of_busy": sum(per_kernel.values()) / busy
            if busy else None,
            "top_device_kernels": [
                {"kernel": key[:70], "ms": t / 1e3, "launches": n}
                for t, n, key in sorted(top, reverse=True)[:8]]}


def rel_diff(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def training_card_vs_cpu(fa, engine_cls, cfg_cls, init_params, optim, lm):
    """(a) A small GPT, same weights and batch: one train step's loss and
    every gradient leaf on the card (kernels) against the CPU (plain
    versions). (b) At full width on the card: the kernels against the
    plain attention swapped in, loss and the attention projections'
    gradients."""
    small = cfg_cls(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.0,
                    pad_token_id=0)
    host = init_params(small, 0, device="cpu")
    ids = lm.synthetic_corpus(97, 4 * 64, seed=3).reshape(4, 64)
    res = {}
    for dev in ("cuda", "cpu"):
        eng = engine_cls(small, optim.SGD(), attention="ulysses_flash",
                         device=dev)
        ts = eng.state_from_params(host)
        m, g = eng.grads(ts, *eng.shard_batch(ids))
        res[dev] = (m["loss_sum"] / m["count"],
                    dict(zip(leaf_names(g), optim.tree_leaves(g))))
    small_loss = rel_diff(res["cuda"][0].cpu(), res["cpu"][0])
    small_grads = {n: rel_diff(res["cuda"][1][n].cpu(), res["cpu"][1][n])
                   for n in res["cpu"][1]}

    full = cfg_cls(dropout_rate=0.0, pad_token_id=0)
    eng = engine_cls(full, optim.SGD(), attention="ulysses_flash",
                     device="cuda")
    ts = eng.state_from_params(init_params(full, 0, device="cuda"))
    ids = lm.synthetic_corpus(50257, LM_TOKENS, seed=0).reshape(8, 1024)
    batch = eng.shard_batch(ids)
    m_k, g_k = eng.grads(ts, *batch)
    with patched(fa, "flash_fwd", fa.flash_fwd_plain), \
            patched(fa, "flash_bwd_dq", fa.flash_bwd_dq_plain), \
            patched(fa, "flash_bwd_dkv", fa.flash_bwd_dkv_plain):
        m_p, g_p = eng.grads(ts, *batch)
    gk = dict(zip(leaf_names(g_k), optim.tree_leaves(g_k)))
    gp = dict(zip(leaf_names(g_p), optim.tree_leaves(g_p)))
    attn = [n for n in gp if "/attn/" in n]
    full_loss = rel_diff(m_k["loss_sum"] / m_k["count"],
                         m_p["loss_sum"] / m_p["count"])
    full_grads = {n: rel_diff(gk[n], gp[n]) for n in attn}
    readings = {
        "small_loss_rel": small_loss,
        "small_grad_rel_max": max(small_grads.values()),
        "small_grad_rel_worst_leaf": max(small_grads, key=small_grads.get),
        "full_loss_rel": full_loss,
        "full_attn_grad_rel_max": max(full_grads.values()),
        "full_attn_grad_rel_worst_leaf": max(full_grads, key=full_grads.get),
        "full_loss": float(m_k["loss_sum"] / m_k["count"]),
    }
    emit({"training_card_vs_cpu": readings})
    require(len(small_grads) == 27 and len(full_grads) == 48,
            f"compared {len(small_grads)} / {len(full_grads)} leaves")
    require(max(small_loss, readings["small_grad_rel_max"])
            <= SMALL_CARD_VS_CPU, f"small GPT train step on the card "
            f"differs from the CPU's: {readings}")
    require(max(full_loss, readings["full_attn_grad_rel_max"])
            <= FULL_KERNEL_VS_PLAIN, f"full-width step with the kernels "
            f"differs from the plain attention's: {readings}")
    return readings


def leaf_names(tree, prefix=""):
    """Leaf paths of a nested dict, in `tree_leaves` (sorted) order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def kernel_label(mangled: str) -> str:
    """flash_fwd_kernel<bf16,Dh=64,rows=64,keys=64> (K1/K2),
    flash_bwd_dkv_kernel<f32,Dh=64,keys=64,rows=64> (K3) or
    int8_matmul_kernel<V=4,S=2> (K4: V 4-byte words a weight load, S
    blocks a cluster) from a mangled entry name."""
    import re

    k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I"
                  r"(f|13__nv_bfloat16)((?:Li\d+E)+)", mangled)
    if not k:
        i8 = re.search(r"int8_matmul_kernelILi(\d+)ELi(\d+)E", mangled)
        return (f"int8_matmul_kernel<V={i8.group(1)},S={i8.group(2)}>"
                if i8 else mangled)
    ints = re.findall(r"Li(\d+)E", k.group(3))
    names = (("Dh", "keys", "rows") if k.group(1) == "flash_bwd_dkv_kernel"
             else ("Dh", "rows", "keys"))
    dtype = "f32" if k.group(2) == "f" else "bf16"
    return (f"{k.group(1)}<{dtype},"
            + ",".join(f"{n}={v}" for n, v in zip(names, ints)) + ">")


def ptxas_summary(report: str):
    """(one line per kernel of a ptxas -v report: registers and spills;
    {kernel label: spill store bytes})."""
    import re

    name, out, spills = None, [], {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"ptxas: {name}: {line.split(':', 1)[-1].strip()}")
            st = re.search(r"(\d+) bytes spill stores", line)
            if st:
                spills[name] = int(st.group(1))
    return out, spills


def flash_entry(name, replaces, lm_rows, errs, times):
    """A flash kernel's entry of the kernels line: launches over the LM
    training runs, the worst error against the plain version over every
    check, and the f32 times at the path shape (bf16 beside them)."""
    f32, bf16 = times[torch.float32][name], times[torch.bfloat16][name]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tile", "tile_sweep_device_ms")
    extra = ("library_device_ms", "sdpa_fwd_bwd_ms", "sdpa_bwd_device_ms",
             "flash_attention_fwd_bwd_ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "distributed_model_parallel_tpu_torch/csrc/"
                  "flash_attention.cu",
        "replaces": replaces,
        "design": FLASH_DESIGN[name],
        "launches": sum(r["launches"][name] for r in lm_rows),
        "launches_by_run": {r["lm_run"]: r["launches"][name]
                            for r in lm_rows},
        "max_abs_err": max(errs[name], errs["flash_fwd_lse"])
        if name == "flash_fwd" else errs[name],
        # One launch at the path shape (B 8, T 1024, H 12, Dh 64, causal,
        # all-true key mask), f32; "bf16" holds the same in bf16.
        **{k: f32[k] for k in keys + extra if k in f32},
        "bf16": {k: bf16[k] for k in keys + extra if k in bf16},
    }


DP_STEPS = 30
DP_TIMED_FROM = 5  # steps 6-30 are timed
DP_BATCH = 512
DP_FLAGS = [
    "--device", "cuda", "--model", "mobilenetv2", "--dataset-type",
    "SyntheticTextures", "-b", str(DP_BATCH), "--val-batch-size", "1000",
    "--lr", "0.4", "-j", "8", "--epochs", "1",
    "--steps-per-epoch", str(DP_STEPS),
]
DP_RUNS = (  # (name, extra flags)
    ("ddp_f32", ["--engine", "ddp"]),
    ("ddp_bf16", ["--engine", "ddp", "--dtype", "bfloat16"]),
    ("gspmd_f32", ["--engine", "gspmd"]),
)
# One tinycnn DDP step, card against CPU, f32 with TF32 off: rtol 1e-5
# (the repo's f32 bar; cuDNN and the CPU sum in another order).
DP_CARD_VS_CPU = 1e-5


def kernel_family(name: str) -> str:
    """A device kernel's name without its template and argument lists."""
    import re

    return re.sub(r"^void\s+", "", name).split("<")[0].split("(")[0]


def dp_breakdown(seen, wall_ms):
    """One more train step under torch.profiler: device busy ms, the idle
    share against the synchronized step wall, kernels a step and the top
    five kernel families by device time."""
    kernels = profiled_step(seen)
    busy_ms = sum(t for t, _, _ in kernels) / 1e3
    families = {}
    for t, n, name in kernels:
        fam = families.setdefault(kernel_family(name), [0.0, 0])
        fam[0] += t / 1e3
        fam[1] += n
    top = sorted(families.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_step": sum(n for _, n, _ in kernels),
            "top_kernel_families": [
                {"family": f[:80], "ms": ms, "launches": n}
                for f, (ms, n) in top]}


def dp_run(dp_cli, dp_mod, native, name, extra):
    """One run of the DP CLI; each train step is timed (synchronized),
    each native augment call timed on the host."""
    import torch.distributed as dist

    augment_ms = []
    augment = native.augment_normalize

    def timed_augment(*args, **kw):
        t0 = time.perf_counter()
        out = augment(*args, **kw)
        augment_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    torch.cuda.reset_peak_memory_stats()
    with patched(native, "augment_normalize", timed_augment):
        out, steps, seen = recorded_run(
            dp_cli.main, DP_FLAGS + extra + [
                "--checkpoint-dir", scratch_dir(f"dp_{name}")],
            dp_mod._DataParallel)
    peak = torch.cuda.max_memory_allocated()
    backend, world = dist.get_backend(), dist.get_world_size()
    grad_reductions = seen["engine"].grad_reductions
    hist = out["history"][0]
    losses = [s["loss"] for s in steps]
    require(len(steps) == DP_STEPS and all(map(math.isfinite, losses))
            and math.isfinite(hist["val"]["loss"]),
            f"DP run {name}: {len(steps)} steps, losses {losses}")
    require(sum(losses[-5:]) < sum(losses[:5]),
            f"DP run {name}: the train loss did not fall: {losses}")
    require(backend == "nccl" and world == 1,
            f"DP run {name}: process group {backend} at world {world}, "
            "want nccl at 1")
    require(grad_reductions == DP_STEPS,
            f"DP run {name}: {grad_reductions} gradient all-reduces in "
            f"{DP_STEPS} steps")
    require(native.available() and len(augment_ms) >= DP_STEPS,
            f"DP run {name}: the native augment made {len(augment_ms)} "
            f"batches for {DP_STEPS} steps")
    timed = steps[DP_TIMED_FROM:]
    ms = sum(s["ms"] for s in timed) / len(timed)
    row = {"dp_run": name, "flags": extra, "ms_per_step": ms,
           "images_per_s": DP_BATCH / ms * 1e3,
           "trainer_batch_time_ms": hist["train"]["batch_time"] * 1e3,
           "trainer_data_wait_ms": hist["train"]["data_time"] * 1e3,
           "native_augment_ms_per_batch":
               sum(augment_ms) / len(augment_ms),
           "native_augment_batches": len(augment_ms),
           "step_ms": [s["ms"] for s in steps],
           "first_train_loss": losses[0], "last_train_loss": losses[-1],
           "epoch_train_loss": hist["train"]["loss"],
           "val_loss": hist["val"]["loss"], "val_acc1": hist["val"]["acc1"],
           "max_memory_allocated_gib": peak / 2 ** 30,
           "backend": backend, "grad_allreduces": grad_reductions}
    row.update(dp_breakdown(seen, ms))
    emit(row)
    return row


def dp_card_vs_cpu():
    """One tinycnn DDP step (per-replica BN, 16 images of 8x8) on the
    card, world 1 on NCCL, against the same step on the CPU with no
    process group: loss and every parameter leaf."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    rng = np.random.RandomState(0)
    images = rng.randn(16, 8, 8, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    res = {}
    for dev, mesh in (("cuda", None), ("cpu", Mesh(1, None))):
        eng = DDPEngine(tiny_cnn(10), SGD(), mesh=mesh, device=dev)
        ts, m = eng.train_step(eng.init_state(0),
                               *eng.shard_batch(images, labels), 0.1)
        res[dev] = (m["loss_sum"] / m["count"],
                    dict(zip(leaf_names(ts.params),
                             tree_leaves(ts.params))))
    loss = rel_diff(res["cuda"][0].cpu(), res["cpu"][0])
    params = {n: rel_diff(res["cuda"][1][n].detach().cpu(),
                          res["cpu"][1][n].detach())
              for n in res["cpu"][1]}
    readings = {"loss_rel": loss, "param_rel_max": max(params.values()),
                "param_rel_worst_leaf": max(params, key=params.get),
                "leaves": len(params)}
    emit({"dp_card_vs_cpu": readings})
    require(max(loss, readings["param_rel_max"]) <= DP_CARD_VS_CPU,
            f"tinycnn DDP step on the card differs from the CPU's: "
            f"{readings}")
    return readings


def dp_conv_shapes():
    """(input NCHW shape, weight shape, stride, padding, groups) of every
    convolution of MobileNetV2 at batch DP_BATCH, read off one CPU
    forward at batch 1. Every one of them feeds a BN layer."""
    import torch.nn.functional as F

    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )

    shapes, conv = [], F.conv2d

    def recording(x, w, stride=1, padding=0, groups=1):
        shapes.append(((DP_BATCH, *x.shape[1:]), tuple(w.shape), stride,
                       padding, groups))
        return conv(x, w, stride=stride, padding=padding, groups=groups)

    model = mobilenet_v2(10)
    params, state = model.init(torch.Generator())
    with patched(F, "conv2d", recording), torch.no_grad():
        model.apply(params, state, torch.zeros(1, 32, 32, 3), L.Context())
    return shapes


def dp_layer_times(dtype, iters=3):
    """Forward + backward device ms a step of MobileNetV2's layer kinds
    at batch DP_BATCH, each layer alone on channels-last tensors with a
    ones cotangent (torch.profiler device time of the kernels, summed
    over the model's layers; host gaps between launches are not
    counted): the depthwise 3x3 convs, the other convs, the port's BN
    (the reference's arithmetic), and cuDNN's fused BN (`F.batch_norm`,
    a yardstick the port never calls: Welford statistics, not the
    reference's E[x²] - E[x]²)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from distributed_model_parallel_tpu_torch.models import layers as L

    def timed(calls):
        for fn, args in calls:
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for fn, args in calls:
                    fn(*args)
            torch.cuda.synchronize()
        return sum(t for t, _, _ in device_kernels(prof)) / iters / 1e3

    def leaf(shape, leaf_dtype):
        t = torch.randn(shape, device="cuda").to(leaf_dtype)
        return t.contiguous(memory_format=torch.channels_last
                            ).requires_grad_(True)

    def conv_step(x, w, stride, padding, groups):
        y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding,
                     groups=groups)
        y.backward(torch.ones_like(y))

    def port_bn_step(x, p, s):
        y, _ = L.batchnorm2d(x.shape[1]).apply(p, s, x, L.Context(train=True))
        y.backward(torch.ones_like(y))

    def cudnn_bn_step(x, p, s):
        y = F.batch_norm(x, s["mean"].clone(), s["var"].clone(), p["scale"],
                         p["bias"], training=True)
        y.backward(torch.ones_like(y))

    calls = {"depthwise_conv_ms": [], "other_conv_ms": [],
             "bn_port_ms": [], "bn_cudnn_fused_ms": []}
    for in_shape, w_shape, stride, padding, groups in dp_conv_shapes():
        x, w = leaf(in_shape, dtype), leaf(w_shape, torch.float32)
        key = "depthwise_conv_ms" if groups > 1 else "other_conv_ms"
        calls[key].append((conv_step, (x, w, stride, padding, groups)))
        with torch.no_grad():
            y = F.conv2d(x, w.to(dtype), stride=stride, padding=padding,
                         groups=groups)
        c = y.shape[1]
        p = {"scale": torch.ones(c, device="cuda", requires_grad=True),
             "bias": torch.zeros(c, device="cuda", requires_grad=True)}
        st = {"mean": torch.zeros(c, device="cuda"),
              "var": torch.ones(c, device="cuda")}
        bn_args = (y.requires_grad_(True), p, st)
        calls["bn_port_ms"].append((port_bn_step, bn_args))
        calls["bn_cudnn_fused_ms"].append((cudnn_bn_step, bn_args))
    return {key: timed(kind) for key, kind in calls.items()}


def dp_phase():
    """The data-parallel phase: the three DP CLI runs on one dataset made
    once, then the card-vs-CPU step."""
    from distributed_model_parallel_tpu_torch import native
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    t0 = time.perf_counter()
    data = datasets.DatasetCollection("SyntheticTextures").init()
    print(f"data-parallel: SyntheticTextures made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(native.available(), "the native augment library did not build")
    rows = []
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        for name, extra in DP_RUNS:
            rows.append(dp_run(data_parallel, dp_mod, native, name, extra))
    for dtype in (torch.float32, torch.bfloat16):
        emit({"dp_layer_times": str(dtype).split(".")[-1],
              **dp_layer_times(dtype)})
    dp_card_vs_cpu()
    torch.distributed.destroy_process_group()
    return rows, data


# ---------------------------------------------------------------------
# Checkpoint and resume (slice 6)

CK_DP_STEPS = 60  # train steps an epoch of the phase-7 DP runs
CK_DP_FLAGS = DP_FLAGS[:DP_FLAGS.index("--epochs")] + [
    "--steps-per-epoch", str(CK_DP_STEPS)]
CK_LM_FLAGS = LM_BASE + ["--layers", str(LAYERS), "--attention",
                         "ulysses_flash", "--dtype", "float32",
                         "--steps-per-epoch", "2"]
CK_PROBE_STEPS = 12  # steps of each determinism probe run
CK_PROBE_TIMED_FROM = 3  # steps 4-12 are timed
# Kernel names a profiled DP step shows for its convolutions (cuDNN's
# and the CUTLASS-style sm90 kernels it dispatches to).
CONV_KERNEL_KEYS = ("conv", "wgrad", "dgrad", "fprop", "xmma", "implicit",
                    "cudnn", "sm90_")


@contextlib.contextmanager
def checkpoint_timing(records):
    """Time the Trainer's checkpoint I/O, synchronized: a save is the
    device-to-host copy of the state (`train_state_to_jax`) plus the
    file write (`save_checkpoint`); a restore is the file read
    (`restore_checkpoint`) plus the host-to-device copy
    (`train_state_from_jax`). Each record has the op, its ms and the
    npz bytes."""
    from distributed_model_parallel_tpu_torch.training import trainer

    def timed(name, op):
        fn = getattr(trainer, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec = {"op": op, "part": name,
                   "ms": (time.perf_counter() - t0) * 1e3}
            if name == "save_checkpoint":
                rec["bytes"] = os.path.getsize(out)
            records.append(rec)
            return out
        return patched(trainer, name, run)

    with timed("train_state_to_jax", "save"), \
            timed("save_checkpoint", "save"), \
            timed("restore_checkpoint", "restore"), \
            timed("train_state_from_jax", "restore"):
        yield


def io_summary(records):
    """Checkpoint I/O ms by part (each entry one call: a state's
    device-to-host copy, one file's write, one file's read, the
    host-to-device copy) and the largest file written. A save is one
    copy and one write; an epoch that writes 'ckpt' and 'last' writes
    one copy twice."""
    out = {f"{part}_ms": [r["ms"] for r in records if r["part"] == part]
           for part in ("train_state_to_jax", "save_checkpoint",
                        "restore_checkpoint", "train_state_from_jax")}
    out["file_bytes"] = max((r["bytes"] for r in records if "bytes" in r),
                            default=None)
    return out


def epoch_numbers(history):
    """An epoch record without its timings."""
    return [{"epoch": h["epoch"], "best_acc": h["best_acc"],
             **{f"{part}_{k}": v for part in ("train", "val")
                for k, v in h[part].items() if not k.endswith("_time")}}
            for h in history]


def determinism_probe(data):
    """C.1 on the card: a MobileNetV2 DDP f32 step at batch 512, the same
    CK_PROBE_STEPS batches twice with cuDNN free to pick its algorithms
    and twice with `cudnn.deterministic` (the CLIs' setting): per-step
    losses, whether the runs' parameters are equal, synchronized ms a
    step (steps 2 on), and the convolution kernels of one profiled step
    in each mode; then one step under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, whose
    warnings name any op with no deterministic implementation."""
    import warnings

    from distributed_model_parallel_tpu_torch.data.datasets import (
        CIFAR10_MEAN,
        CIFAR10_STD,
    )
    from distributed_model_parallel_tpu_torch.data.loader import Loader
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    loader = Loader(data[0], DP_BATCH, augment=True, mean=CIFAR10_MEAN,
                    std=CIFAR10_STD, workers=8)
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == CK_PROBE_STEPS:
            break

    def run():
        eng = DDPEngine(mobilenet_v2(10), SGD(), device="cuda")
        ts = eng.init_state(0)
        losses, ms = [], []
        for images, labels in batches:
            placed = eng.shard_batch(images, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = eng.train_step(ts, *placed, 0.04)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss_sum"] / m["count"]))
        params = [t.detach().clone() for t in tree_leaves(ts.params)]
        seen = {"engine": eng, "state": ts, "batch": placed, "lr": 0.04}
        kernels = profiled_step(seen)
        convs = sorted({kernel_family(name)[:90] for _, _, name in kernels
                        if any(k in name.lower()
                               for k in CONV_KERNEL_KEYS)})
        busy = sum(t for t, _, _ in kernels) / 1e3
        return losses, params, ms[CK_PROBE_TIMED_FROM:], (convs, busy), seen

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # In turns (free, deterministic, deterministic, free), so that host
    # noise spreads over both modes.
    runs = {False: [], True: []}
    try:
        for det in (False, True, True, False):
            torch.backends.cudnn.deterministic = det
            runs[det].append(run())
        modes = {}
        for det, ((l1, p1, ms1, (convs, busy1), _),
                  (l2, p2, ms2, (_, busy2), _)) in runs.items():
            modes["deterministic" if det else "free"] = {
                "losses": [l1, l2], "params_equal": same(p1, p2),
                "losses_equal": l1 == l2,
                "ms_per_step": sum(ms1 + ms2) / len(ms1 + ms2),
                "device_busy_ms": [busy1, busy2],
                "conv_kernels": convs}
        seen = runs[True][1][4]
        torch.backends.cudnn.deterministic = True
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                seen["engine"].train_step(seen["state"], *seen["batch"],
                                          seen["lr"])
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        torch.backends.cudnn.deterministic = True
    reading = {"steps": CK_PROBE_STEPS, **modes,
               "nondeterministic_op_warnings": sorted(
                   {str(w.message)[:200] for w in caught
                    if "deterministic" in str(w.message)})}
    emit({"c1_determinism_probe": reading})
    d = modes["deterministic"]
    require(d["losses_equal"] and d["params_equal"],
            f"DDP f32 with cudnn.deterministic is not deterministic: {d}")
    return reading


def checkpoint_dp_phase(dp_cli, dp_mod, data):
    """7(a): MobileNetV2 f32 through the DP CLI, two epochs of
    CK_DP_STEPS steps. `--engine ddp` straight twice and `--engine gspmd`
    straight once must give the same per-step losses (C.1: at world 1
    the engines compute the same step); one epoch then `--resume` to two
    must give the straight run's epoch-1 record and step losses."""
    from distributed_model_parallel_tpu_torch.data import datasets

    runs, io_records = {}, []
    plan = (("ddp_a", ["--engine", "ddp", "--epochs", "2"], "ddp_a"),
            ("ddp_b", ["--engine", "ddp", "--epochs", "2"], "ddp_b"),
            ("gspmd", ["--engine", "gspmd", "--epochs", "2"], "gspmd"),
            ("split_1", ["--engine", "ddp", "--epochs", "1"], "split"),
            ("split_2", ["--engine", "ddp", "--epochs", "2", "--resume"],
             "split"))
    with patched(datasets.DatasetCollection, "init", lambda self: data), \
            checkpoint_timing(io_records):
        for name, extra, directory in plan:
            out, steps, _ = recorded_run(
                dp_cli.main, CK_DP_FLAGS + extra + [
                    "--checkpoint-dir", scratch_dir(f"ck_dp_{directory}")],
                dp_mod._DataParallel)
            runs[name] = {"history": epoch_numbers(out["history"]),
                          "losses": [st["loss"] for st in steps],
                          "ms": [st["ms"] for st in steps]}
    torch.distributed.destroy_process_group()
    a, b, g = runs["ddp_a"], runs["ddp_b"], runs["gspmd"]
    split_losses = runs["split_1"]["losses"] + runs["split_2"]["losses"]
    reading = {
        "steps_per_epoch": CK_DP_STEPS,
        "ddp_twice_losses_equal": a["losses"] == b["losses"],
        "ddp_twice_epochs_equal": a["history"] == b["history"],
        "gspmd_vs_ddp_losses_equal": g["losses"] == a["losses"],
        "gspmd_vs_ddp_max_abs_loss_diff": max(
            abs(x - y) for x, y in zip(g["losses"], a["losses"])),
        "resume_losses_equal": split_losses == a["losses"],
        "resume_epoch1_equal": runs["split_2"]["history"]
        == a["history"][1:],
        "epochs": a["history"],
        "ddp_ms_per_step": sum(a["ms"][5:]) / len(a["ms"][5:]),
        "first_last_loss": [a["losses"][0], a["losses"][-1]],
        **io_summary(io_records),
    }
    emit({"dp_checkpoint_resume": reading})
    require(len(a["losses"]) == 2 * CK_DP_STEPS
            and len(split_losses) == 2 * CK_DP_STEPS,
            f"DP resume runs took {len(a['losses'])} / "
            f"{len(split_losses)} steps")
    require(reading["ddp_twice_losses_equal"]
            and reading["ddp_twice_epochs_equal"],
            "two ddp f32 runs with the same seeds differ (C.1)")
    require(reading["gspmd_vs_ddp_losses_equal"],
            "gspmd and ddp differ at world 1 (C.1): "
            f"{reading['gspmd_vs_ddp_max_abs_loss_diff']}")
    require(reading["resume_losses_equal"] and reading["resume_epoch1_equal"],
            "DP one epoch + --resume differs from two epochs straight")
    return reading


def checkpoint_lm_phase(lm, engine_cls, fa, qm):
    """7(b): the LM CLI at GPT-2-small width, `ulysses_flash` f32, two
    epochs of 2 steps straight against one epoch then `--resume` to two:
    equal per-step losses and epoch-1 record, and exact K1-K3 launches
    in each run. The runs also write `last` every epoch
    (`TrainerConfig.save_last`), so that they resume whatever the
    validation accuracy of a random-weight epoch. Returns (reading, the
    straight run's directory)."""
    import functools

    val_batches = LM_VAL_BATCHES
    runs, io_records, launches = {}, [], {}
    plan = (("straight", ["--epochs", "2"], "straight", 4, 2),
            ("split_1", ["--epochs", "1"], "split", 2, 1),
            ("split_2", ["--epochs", "2", "--resume"], "split", 2, 1))
    with checkpoint_timing(io_records), patched(
            lm, "TrainerConfig",
            functools.partial(lm.TrainerConfig, save_last=True)):
        for name, extra, directory, steps, epochs in plan:
            reset_counts(fa, qm)
            out, rec, _ = recorded_run(
                lm.main, CK_LM_FLAGS + extra + [
                    "--checkpoint-dir", scratch_dir(f"ck_lm_{directory}")],
                engine_cls)
            got = counts(fa)
            want = {"flash_fwd": LAYERS * (steps + val_batches * epochs),
                    "flash_bwd_dq": LAYERS * steps,
                    "flash_bwd_dkv": LAYERS * steps}
            require(got == want, f"LM resume run {name}: kernel launches "
                    f"{got}, want {want}")
            require(qm.int8_matmul.launches == 0,
                    f"LM resume run {name} launched int8")
            launches[name] = got
            runs[name] = {"history": epoch_numbers(out["history"]),
                          "losses": [st["loss"] for st in rec]}
    straight = runs["straight"]
    split_losses = runs["split_1"]["losses"] + runs["split_2"]["losses"]
    reading = {
        "losses": straight["losses"], "resumed_losses": split_losses,
        "resume_losses_equal": split_losses == straight["losses"],
        "resume_epoch1_equal": runs["split_2"]["history"]
        == straight["history"][1:],
        "launches": launches, **io_summary(io_records),
    }
    emit({"lm_checkpoint_resume": reading})
    require(all(map(math.isfinite, straight["losses"]))
            and len(straight["losses"]) == 4,
            f"LM straight run losses {straight['losses']}")
    require(reading["resume_losses_equal"] and reading["resume_epoch1_equal"],
            "LM 2 + 2 steps across --resume differ from 4 straight")
    return reading, scratch_dir("ck_lm_straight")


def checkpoint_serve_phase(serve, engine_cls, cfg_cls, fa, qm, directory,
                           random_gap):
    """7(c): `serve --checkpoint` on 7(b)'s directory, f32 and int8 (K4
    48 times a decode step), then the first decode step's int8-vs-f32
    logits on those trained weights beside the random weights' gap."""
    outs, launches = {}, {}
    for mode in ("f32", "int8"):
        reset_counts(fa, qm)
        outs[mode] = serve_run(serve, SERVE_FLAGS + [
            "--compute-dtype", mode, "--checkpoint", directory])
        launches[mode] = qm.int8_matmul.launches
        require(not any(counts(fa).values()),
                "serving a checkpoint launched flash kernels")
    steps = outs["int8"]["serving"]["decode_steps"]
    require(launches["f32"] == 0 and steps > 0
            and launches["int8"] == 4 * LAYERS * steps,
            f"serve --checkpoint int8 launched the kernel "
            f"{launches['int8']} times over {steps} decode steps")
    for mode, out in outs.items():
        s = out["serving"]
        require(s["checkpoint"] == directory and s["requests"] == 16
                and s["generated_tokens"] == 16 * 32,
                f"serve --checkpoint {mode}: {s['requests']} requests, "
                f"{s['generated_tokens']} tokens")
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    cfg = cfg_cls(vocab_size=50257, dim=768, num_layers=LAYERS,
                  num_heads=12, ffn_dim=3072, max_position=1024,
                  dropout_rate=0.0, pad_token_id=0)
    prompts = [r.prompt for r in serve.synthetic_trace(args)[:SLOTS]]
    with contextlib.redirect_stdout(io.StringIO()):
        host = serve.load_checkpoint_params(
            directory, serve.newest_checkpoint_name(directory), cfg, 0,
            "cuda")
    kw = dict(num_slots=SLOTS, max_len=1024, prefill_len=128)
    engines = {mode: engine_cls(cfg, compute_dtype=mode, device="cuda", **kw)
               for mode in ("f32", "int8")}
    params = {mode: eng.place_params(host) for mode, eng in engines.items()}
    pre, _ = first_step(engines["f32"], params["f32"], prompts,
                        torch.zeros(SLOTS, dtype=torch.int64))
    tokens = pre.argmax(-1)
    f32 = first_step(engines["f32"], params["f32"], prompts, tokens)[1]
    i8 = first_step(engines["int8"], params["int8"], prompts, tokens)[1]
    pairs = [(x, y) for ra, rb in zip(outs["f32"]["requests"],
                                      outs["int8"]["requests"])
             for x, y in zip(ra["tokens"], rb["tokens"])]
    reading = {"int8_launches": launches["int8"], "decode_steps": steps,
               "launches_per_step": launches["int8"] / steps,
               "int8_vs_f32_trained": int8_vs_f32(i8, f32),
               "int8_vs_f32_random_weights_rel": random_gap,
               "greedy_token_agreement_int8_vs_f32":
                   sum(x == y for x, y in pairs) / len(pairs),
               "tokens_per_s": {m: o["serving"]["tokens_per_s"]
                                for m, o in outs.items()}}
    emit({"serve_checkpoint": reading})
    require(bool(torch.isfinite(i8).all()) and bool(torch.isfinite(f32).all())
            and reading["int8_vs_f32_trained"]["rel"] <= INT8_LOGIT_REL,
            f"int8 first-step logits on trained weights: "
            f"{reading['int8_vs_f32_trained']}")
    return reading


def main() -> int:
    # cuBLAS reads this when it first starts: the determinism probe's
    # torch.use_deterministic_algorithms needs it (phase 7).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        return smoke()
    finally:
        for directory in SCRATCH:
            shutil.rmtree(directory, ignore_errors=True)


def smoke() -> int:
    phase_t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0:.1f} s", flush=True)
        phase_t0 = now

    # ---- 1. device -------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is "
            "false: this smoke run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False

    from distributed_model_parallel_tpu_torch.cli import lm, serve
    from distributed_model_parallel_tpu_torch.data import lm as lm_data
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        init_params,
    )
    from distributed_model_parallel_tpu_torch.ops import _cuda
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from distributed_model_parallel_tpu_torch.training import optim
    phase_done("device")

    # ---- 2. build: both sources at once, one nvcc each ----------------
    t0 = time.perf_counter()
    for source in ("int8_matmul.cu", "flash_attention.cu"):
        # a library left by an earlier run would give no ptxas report
        _cuda.library_path(source).unlink(missing_ok=True)
    _cuda.build(["int8_matmul.cu", "flash_attention.cu"])
    qm._library()
    fa._library()
    print(f"build: both sources in {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    spills = {}
    for source in ("int8_matmul.cu", "flash_attention.cu"):
        build_s, report = _cuda.build_info[source]
        print(f"build: {source} in {build_s:.2f} s", flush=True)
        lines, found = ptxas_summary(report)
        spills.update(found)
        for line in lines:
            print(line, flush=True)
    must_not_spill = [f"int8_matmul_kernel<V={v},S={s}>"
                      for v in (1, 4) for s in (2, 8)]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dtype, tiles in fa.DEFAULT_TILE[name].items():
            for dh, (t0, t1) in tiles.items():
                if name == "flash_bwd_dkv" and dh != 64:
                    continue  # K3: the path's Dh (Dh 128 is printed)
                names = ("keys", "rows") if name == "flash_bwd_dkv" \
                    else ("rows", "keys")
                must_not_spill.append(
                    f"{name}_kernel<"
                    f"{'f32' if dtype == torch.float32 else 'bf16'},"
                    f"Dh={dh},{names[0]}={t0},{names[1]}={t1}>")
    for label in must_not_spill:
        require(spills.get(label) == 0,
                f"{label}: ptxas spill stores {spills.get(label)}")
    phase_done("build")

    # ---- 3. kernel vs plain version ---------------------------------
    shapes = []
    for i, (name, k, n) in enumerate(DECODE_SHAPES):
        r = check_shape(qm, SLOTS, k, n, seed=i)
        r["projection"] = name
        shapes.append(r)
        emit({"int8_matmul_shape": r})
    for i, (m, k, n) in enumerate(EXTRA_SHAPES):
        r = check_shape(qm, m, k, n, seed=10 + i)
        shapes.append(r)
        emit({"int8_matmul_shape": r})
    max_err = max(r["max_abs_err"] for r in shapes)
    phase_done("int8 kernel vs plain")
    flash_errs, flash_times = flash_phase(fa)
    phase_done("flash kernels vs plain")

    # ---- 4. serving at full width (a main path) ----------------------
    reset_counts(fa, qm)
    out_f32 = serve_run(serve, SERVE_FLAGS + ["--compute-dtype", "f32"])
    require(qm.int8_matmul.launches == 0,
            "the f32 run launched the int8 kernel")
    reset_counts(fa, qm)
    out_i8 = serve_run(serve, SERVE_FLAGS + ["--compute-dtype", "int8"])
    launches = qm.int8_matmul.launches
    require(not any(counts(fa).values()), "serving launched flash kernels")
    steps = out_i8["serving"]["decode_steps"]
    require(steps > 0 and launches == 4 * LAYERS * steps,
            f"int8 run launched the kernel {launches} times over {steps} "
            f"decode steps; want {4 * LAYERS} per step")
    for name, out in (("f32", out_f32), ("int8", out_i8)):
        s = out["serving"]
        require(s["requests"] == 16 and s["generated_tokens"] == 16 * 32,
                f"{name} run finished {s['requests']} requests / "
                f"{s['generated_tokens']} tokens")
        emit({"serve": name, "device": s["device"],
              "tokens_per_s": s["tokens_per_s"],
              "decode_p50_ms": s["decode_p50_ms"],
              "decode_p99_ms": s["decode_p99_ms"],
              "ttft_p50_ms": s["prefill_p50_ms"],
              "ttft_p99_ms": s["ttft_p99_ms"],
              "decode_steps": s["decode_steps"],
              "mean_batch_occupancy": s["mean_batch_occupancy"]})
    pairs = [(a, b) for ra, rb in zip(out_f32["requests"],
                                      out_i8["requests"])
             for a, b in zip(ra["tokens"], rb["tokens"])]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    readings, breakdown = first_step_readings(serve, ServingEngine,
                                              GPTConfig, qm)
    small = small_model_matches_cpu(ServingEngine, GPTConfig, init_params)
    emit({"int8_kernel_launches": launches, "decode_steps": steps,
          "launches_per_step": launches / steps,
          "greedy_token_agreement_int8_vs_f32": agree,
          "int8_vs_f32_card_rel": readings["int8_vs_f32_card"]["rel"],
          "int8_vs_f32_cpu_rel": readings["int8_vs_f32_cpu"]["rel"],
          "card_vs_cpu_max_abs": readings["card_vs_cpu_max_abs"],
          "small_model_gpu_vs_cpu_max_abs_err": small,
          "decode_step_breakdown": breakdown})
    phase_done("serving")

    # ---- 5. LM training at GPT-2-small width (a main path) -----------
    lm_rows = [lm_run(lm, CausalLMSequenceParallelEngine, fa, qm, *run)
               for run in LM_RUNS]
    phase_done("LM training")
    training_card_vs_cpu(fa, CausalLMSequenceParallelEngine, GPTConfig,
                         init_params, optim, lm_data)
    phase_done("training card vs CPU")

    # ---- 6. data-parallel MobileNetV2 training (a main path) ----------
    reset_counts(fa, qm)
    _, dp_data = dp_phase()
    require(not any(counts(fa).values()) and qm.int8_matmul.launches == 0,
            "data-parallel training launched a K1-K4 kernel")
    phase_done("data-parallel training")

    # ---- 7. checkpoint and resume (the slice-6 paths) -----------------
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    determinism_probe(dp_data)
    reset_counts(fa, qm)
    checkpoint_dp_phase(data_parallel, dp_mod, dp_data)
    require(not any(counts(fa).values()) and qm.int8_matmul.launches == 0,
            "data-parallel resume launched a K1-K4 kernel")
    del dp_data
    phase_done("checkpoint and resume: data-parallel")
    lm_resume, lm_dir = checkpoint_lm_phase(
        lm, CausalLMSequenceParallelEngine, fa, qm)
    phase_done("checkpoint and resume: LM")
    serve_ckpt = checkpoint_serve_phase(
        serve, ServingEngine, GPTConfig, fa, qm, lm_dir,
        readings["int8_vs_f32_card"]["rel"])
    phase_done("checkpoint and resume: serve --checkpoint")
    slice6 = {name: sum(r[name] for r in lm_resume["launches"].values())
              for name, _, _ in FLASH_KERNELS}
    slice6["int8_matmul"] = serve_ckpt["int8_launches"]

    # ---- 8. kernels line, card line, last line -----------------------
    decode = [r for r in shapes if r["M"] == SLOTS]
    step = {key: None if any(r[key] is None for r in decode)
            else LAYERS * sum(r[key] for r in decode)
            for key in ("kernel_ms", "kernel_device_ms", "plain_ms",
                        "library_ms", "library_device_ms",
                        "int_mm_device_ms", "bound_ms", "bytes", "ops")}
    emit({"kernels": [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": "distributed_model_parallel_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "distributed_model_parallel_tpu/ops/quant_matmul.py:190",
        "design": INT8_DESIGN,
        "launches": launches,
        # serve --checkpoint int8 (phase 7), counted apart
        "launches_slice6": slice6["int8_matmul"],
        "max_abs_err": max_err,
        # Times of one decode step's 48 launches (12 layers x the four
        # projection shapes at M = 8), each shape timed in phase 3.
        "ms": step["kernel_ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": ("bytes" if step["bytes"] / HBM_BYTES_PER_S
                     >= step["ops"] / INT8_OPS_PER_S else "operations"),
        "library_ms": step["library_ms"],
        # Device time (profiler) of the same 48 launches, and of the f32
        # torch.matmul yardstick: an unquantized product, not the
        # kernel's function.
        "device_ms": step["kernel_device_ms"],
        "library_device_ms": step["library_device_ms"],
        # cuBLASLt's s8 x s8 -> s32 (torch._int_mm, M padded to 32) on the
        # same codes: the integer product alone, not K4's function.
        "int_mm_device_ms": step["int_mm_device_ms"],
        "per_shape": shapes,
    }] + [dict(flash_entry(name, replaces, lm_rows, flash_errs,
                           flash_times), launches_slice6=slice6[name])
          for name, _, replaces in FLASH_KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
