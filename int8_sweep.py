#!/usr/bin/env python3
"""Sweep the int8 decode GEMM's compile-time constants on one CUDA GPU.

Run from the repository root on a machine with an H100 and nvcc:

    python3 int8_sweep.py                      # the default variants
    python3 int8_sweep.py 1024,64,8 0,32,4     # kSplitSmallK,kCols,kLoads

Each variant is a copy of `csrc/int8_matmul.cu` with `kSplitSmallK` (K up
to which a cluster has 2 blocks, else 8), `kCols` (output columns a
cluster) and `kLoads` (weight loads in flight a thread) replaced; the
copies are built at once (one nvcc each) under the package's gitignored
build directory. At the four GPT-2-small decode shapes (M = 8) and at
M = 256, every variant's output must equal the plain version's
(torch.equal); then its device time a launch (torch.profiler, weights
cycled past the 50 MB L2 as in chip_smoke.py) is printed beside the
committed kernel's, with the sum over one layer's four decode shapes.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

import chip_smoke as cs
from distributed_model_parallel_tpu_torch.ops import _cuda
from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm

DEFAULT_VARIANTS = ("1024,64,8", "1024,32,4", "1024,32,8", "1024,16,4",
                    "4096,32,8", "512,32,8", "0,64,8")
KNOBS = ("kSplitSmallK", "kCols", "kLoads")


def build(variants):
    """{variant: ctypes library}, all built at once."""
    src = (_cuda.CSRC / "int8_matmul.cu").read_text()
    out_dir = _cuda.BUILD / "int8_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        text = src
        for name, val in zip(KNOBS, v):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {val};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found once in the source")
        path = out_dir / ("v_" + "_".join(map(str, v)) + ".cu")
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(path)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    lib)
    libs = {}
    for v, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores", out)
        print(f"built {v}: registers {regs}, spill stores {spills}",
              flush=True)
        handle = ctypes.CDLL(str(lib))
        handle.dmp_int8_matmul.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        handle.dmp_int8_matmul.restype = ctypes.c_int
        libs[v] = handle
    return libs


def runner(handle):
    def run(x, wq_t, wscale):
        m, k = x.shape
        n = wq_t.shape[0]
        out = torch.empty((m, n), device=x.device)
        rc = handle.dmp_int8_matmul(
            x.data_ptr(), wq_t.data_ptr(), wscale.data_ptr(), out.data_ptr(),
            None, None, None, m, n, k, qm.ABSMAX_FLOOR,
            torch.cuda.current_stream().cuda_stream)
        cs.require(rc == 0, f"launch failed: cudaError {rc}")
        return out
    return run


def main(argv) -> int:
    cs.require(torch.cuda.is_available(), "needs a CUDA GPU")
    variants = [tuple(int(x) for x in v.split(","))
                for v in (argv or DEFAULT_VARIANTS)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; variants as ({', '.join(KNOBS)})", flush=True)
    libs = build(variants)
    layer = {v: 0.0 for v in ["committed", *variants]}
    shapes = [(cs.SLOTS, k, n) for _, k, n in cs.DECODE_SHAPES]
    for m, k, n in shapes + [(256, 768, 3072)]:
        g = torch.Generator(device="cuda").manual_seed(k + n)
        x = torch.randn((m, k), generator=g, device="cuda")
        w = 0.02 * torch.randn((k, n), generator=g, device="cuda")
        ref = qm.int8_matmul_plain(x, *qm.prepare_weight(w))
        copies = [(x, *qm.prepare_weight(w.roll(i, 1)))
                  for i in range(cs.copies_for(n * k))]
        row = {"committed": cs.device_ms(qm.int8_matmul, copies, 60)}
        for v, handle in libs.items():
            run = runner(handle)
            y = run(x, *copies[0][1:])
            torch.cuda.synchronize()
            cs.require(torch.equal(y, ref), f"variant {v} differs at "
                                            f"{(m, k, n)}")
            row[v] = cs.device_ms(run, copies, 60)
        if m == cs.SLOTS:
            for v, t in row.items():
                layer[v] += t
        print(f"shape {(m, k, n)} device us a launch: "
              + " | ".join(f"{v}: {t * 1e3:.2f}" for v, t in row.items()),
              flush=True)
    print("one layer's four decode shapes, device us: "
          + " | ".join(f"{v}: {t * 1e3:.2f}" for v, t in layer.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
