"""Epoch-driver trainer (port of `training/trainer.py`).

The reference's observable training behaviour, for an engine exposing
`init_state`, `shard_batch`, `train_step` and `eval_step`: a per-batch
loop with batch_time / data_time averages, a progress print every
`print_freq` batches, loss / acc1 / acc5 from metric sums, a cosine LR
with linear-warmup dampening stepped once per epoch, and a per-epoch
txt line with its JSONL twin. The host-phase spans (`fetch`, `step`,
`sync`) and the `train_fetch_s` / `train_step_s` histograms come from the
port's `observability/`, off by default.

Timing: PyTorch launches kernels asynchronously, so the epoch wall
clock closes on a value fetch of the summed metrics (`.item()`), which
cannot return before every step that fed the sum has run.

Ranks (`runtime/dist.py`): every rank runs the loop over its own
loaders; the metric sums are the engine's, already summed over the
ranks; only rank 0 prints and writes the epoch log.

Left to later slices, and refused rather than skipped: checkpoint
writing (`save_best` is False here; best_acc still records the best
validation acc1) and `resume`, `steps_per_dispatch > 1`, `profile_dir`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Iterable, Optional

from distributed_model_parallel_tpu_torch.observability.metrics import (
    get_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (
    get_tracer,
)
from distributed_model_parallel_tpu_torch.runtime.dist import is_primary
from distributed_model_parallel_tpu_torch.training.optim import (
    cosine_warmup_schedule,
)

CHECKPOINT_SLICE = "the checkpointing slice"
MULTISTEP_SLICE = "the multi-step dispatch slice"
PROFILE_SLICE = "the profiler-capture slice"


@dataclasses.dataclass
class EpochStats:
    """What the reference logs per epoch."""

    loss: float = 0.0
    acc1: float = 0.0
    acc5: float = 0.0
    batch_time: float = 0.0  # avg seconds per batch, data included
    data_time: float = 0.0   # avg seconds waiting on the input pipeline
    count: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TrainerConfig:
    """Trainer hyperparameters, the reference's fields. The checkpoint,
    dispatch-grouping and profiler fields exist so a configuration
    crosses between the packages; their non-default values are refused
    until their slices land."""

    epochs: int = 100
    base_lr: float = 0.1
    t_max: int = 90
    warmup_period: int = 10
    print_freq: int = 30
    log_dir: str = "./log"
    log_file: Optional[str] = None      # txt epoch log (e.g. "512.txt")
    save_best: bool = False
    resume: bool = False
    # Truncate each training epoch to N batches (0 = full epoch).
    steps_per_epoch: int = 0
    steps_per_dispatch: int = 1
    profile_dir: Optional[str] = None


def _refused(knob: str, later: str) -> ValueError:
    return ValueError(
        f"TrainerConfig.{knob} is not ported to the PyTorch package yet: "
        f"it belongs to {later} (ROADMAP.md)"
    )


def _add(sums: Optional[dict], m: dict) -> dict:
    return dict(m) if sums is None else {k: sums[k] + m[k] for k in sums}


class Trainer:
    """Drives an engine through the reference's epoch protocol."""

    def __init__(self, engine: Any, train_loader: Iterable,
                 val_loader: Optional[Iterable], config: TrainerConfig,
                 seed: int = 0):
        for knob, bad, later in (
            ("save_best", config.save_best, CHECKPOINT_SLICE),
            ("resume", config.resume, CHECKPOINT_SLICE),
            ("steps_per_dispatch", config.steps_per_dispatch != 1,
             MULTISTEP_SLICE),
            ("profile_dir", config.profile_dir is not None, PROFILE_SLICE),
        ):
            if bad:
                raise _refused(knob, later)
        self.engine = engine
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.lr_fn = cosine_warmup_schedule(
            config.base_lr, config.t_max, config.warmup_period
        )
        self.state = engine.init_state(seed)
        self.best_acc = 0.0
        self.history: list = []

    # ------------------------------------------------------------- loops

    def train_epoch(self, epoch: int) -> EpochStats:
        cfg = self.config
        tracer = get_tracer()
        mx = get_metrics()
        lr = self.lr_fn(epoch)
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(epoch)
        it = iter(self.train_loader)
        n_avail = (len(self.train_loader)
                   if hasattr(self.train_loader, "__len__") else None)
        if cfg.steps_per_epoch:
            n_avail = (min(n_avail, cfg.steps_per_epoch)
                       if n_avail else cfg.steps_per_epoch)
        sums = None
        n_batches = 0
        data_time = 0.0

        def fetch(n_done: int):
            """The next batch on the device, or None when the epoch (or
            its steps_per_epoch budget) is done."""
            nonlocal data_time
            if cfg.steps_per_epoch and n_done >= cfg.steps_per_epoch:
                return None
            with tracer.span("fetch", want=1):
                t0 = time.perf_counter()
                tm0 = tracer.now() if mx.enabled else 0.0
                batch = next(it, None)
                data_time += time.perf_counter() - t0
                if batch is None:
                    return None
                if mx.enabled:
                    mx.observe("train_fetch_s", tracer.now() - tm0)
                return self.engine.shard_batch(*batch)

        epoch_start = time.perf_counter()
        t_boundary = tracer.now() if mx.enabled else None
        printable = None
        placed = fetch(0)
        while placed is not None:
            with tracer.span("step", n=1):
                self.state, metrics = self.engine.train_step(
                    self.state, *placed, lr)
            prev = n_batches
            n_batches += 1
            # The next batch's host load and copy overlap the step the
            # device is still running.
            placed = fetch(n_batches)
            sums = _add(sums, metrics)
            if mx.enabled:
                t_now = tracer.now()
                if t_boundary is not None:
                    mx.observe("train_step_s", t_now - t_boundary)
                mx.inc("train_batches_total", 1)
                t_boundary = t_now
            if cfg.print_freq and (
                n_batches // cfg.print_freq > prev // cfg.print_freq
            ):
                # Print the PREVIOUS step's metrics: a newer step already
                # runs behind them, so reading them does not stall on it.
                snap_n, snap = (printable if printable is not None
                                else (n_batches, metrics))
                with tracer.span("sync"):
                    m = {k: float(v) for k, v in snap.items()}
                self._log_print(
                    f"Epoch: [{epoch}]"
                    f"[{snap_n}/{n_avail if n_avail is not None else '?'}]"
                    f"\tLoss {m['loss_sum'] / m['count']:.4e}"
                    f"\tAcc@1 {100.0 * m['correct1'] / m['count']:.3f}"
                    f"\tTime {(time.perf_counter() - epoch_start) / n_batches:.3f}"
                )
            printable = (n_batches, metrics)
        if sums is not None:
            with tracer.span("sync", epoch=epoch):
                sums = {k: float(v) for k, v in sums.items()}
        wall = time.perf_counter() - epoch_start
        return self._finalize(sums, n_batches, wall, data_time)

    def validate(self, epoch: int) -> EpochStats:
        sums = None
        n_batches = 0
        data_time = 0.0
        epoch_start = time.perf_counter()
        it = iter(self.val_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            data_time += time.perf_counter() - t0
            if batch is None:
                break
            placed = self.engine.shard_batch(*batch)
            sums = _add(sums, self.engine.eval_step(self.state, *placed))
            n_batches += 1
        if sums is not None:
            sums = {k: float(v) for k, v in sums.items()}
        wall = time.perf_counter() - epoch_start
        return self._finalize(sums, n_batches, wall, data_time)

    def fit(self) -> dict:
        """Train, validate and log each epoch."""
        cfg = self.config
        for epoch in range(cfg.epochs):
            train_stats = self.train_epoch(epoch)
            val_stats = (self.validate(epoch) if self.val_loader is not None
                         else EpochStats())
            if self.val_loader is not None:
                self.best_acc = max(self.best_acc, val_stats.acc1)
            self._append_epoch_log(epoch, train_stats, val_stats)
        return {"best_acc": self.best_acc, "epochs": cfg.epochs,
                "history": self.history}

    # ----------------------------------------------------------- helpers

    @staticmethod
    def _finalize(sums, n_batches: int, wall: float,
                  data_time: float) -> EpochStats:
        if sums is None or n_batches == 0:
            return EpochStats()
        count = sums["count"]
        return EpochStats(
            loss=sums["loss_sum"] / count,
            acc1=100.0 * sums["correct1"] / count,
            acc5=100.0 * sums["correct5"] / count,
            batch_time=wall / n_batches,
            data_time=data_time / n_batches,
            count=int(count),
        )

    def _append_epoch_log(self, epoch: int, train: EpochStats,
                          val: EpochStats) -> None:
        """One txt line per epoch (the reference's fields) plus a JSONL
        twin."""
        record = {"epoch": epoch, "train": train.as_dict(),
                  "val": val.as_dict(), "best_acc": self.best_acc}
        self.history.append(record)
        cfg = self.config
        line = (
            f"epoch {epoch} "
            f"train_loss {train.loss:.4f} train_acc1 {train.acc1:.3f} "
            f"val_loss {val.loss:.4f} val_acc1 {val.acc1:.3f} "
            f"time_per_batch {train.batch_time:.4f} "
            f"time_load_perbatch {train.data_time:.4f}"
        )
        self._log_print(line)
        if cfg.log_file and is_primary():
            os.makedirs(cfg.log_dir, exist_ok=True)
            with open(os.path.join(cfg.log_dir, cfg.log_file), "a") as f:
                f.write(line + "\n")
            jsonl = os.path.splitext(cfg.log_file)[0] + ".jsonl"
            with open(os.path.join(cfg.log_dir, jsonl), "a") as f:
                f.write(json.dumps(record) + "\n")

    @staticmethod
    def _log_print(msg: str) -> None:
        if is_primary():
            print(msg, flush=True)


__all__ = ["EpochStats", "Trainer", "TrainerConfig"]
