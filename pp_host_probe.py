#!/usr/bin/env python3
"""Where a pipeline step's host time goes on the card, without the CLI's
loader: MobileNetV2 at batch 512, four stages on one GPU, M = 8, f32,
under gpipe, 1f1b (reference split) and interleaved (V = 2). Per
schedule: the synchronized ms a step over five steps after three warm
ones, then the top functions of two more steps under cProfile. Run
from the repository root on a machine with a CUDA GPU:

    python3 pp_host_probe.py
"""

import cProfile
import io
import pstats
import subprocess
import time

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.cli.common import (
    set_device_numerics,
)
from distributed_model_parallel_tpu_torch.models import mobilenetv2
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    PipelineEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import SGD

RUNS = (  # (schedule, chunks, boundaries, virtual stages)
    ("gpipe", 4, [3, 9, 15], 1),
    ("1f1b", 4, [3, 9, 15], 1),
    ("interleaved", 8, None, 2),
)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pp_host_probe.py needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    set_device_numerics()
    cuda = torch.device("cuda")
    rng = np.random.RandomState(0)
    images = rng.randn(512, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 512)
    for schedule, chunks, boundaries, v in RUNS:
        eng = PipelineEngine(
            mobilenetv2.split_stages(chunks, 10, boundaries=boundaries),
            SGD(), Mesh(1, None, 4, (cuda,)), num_microbatches=8,
            schedule=schedule, virtual_stages=v)
        ts = eng.init_state(0)
        batch = eng.shard_batch(images, labels)
        for _ in range(3):
            ts, _ = eng.train_step(ts, *batch, 0.04)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            ts, _ = eng.train_step(ts, *batch, 0.04)
        torch.cuda.synchronize()
        print(f"{schedule} ms/step "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.1f}", flush=True)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2):
            ts, _ = eng.train_step(ts, *batch, 0.04)
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(8)
        print(out.getvalue(), flush=True)


if __name__ == "__main__":
    main()
