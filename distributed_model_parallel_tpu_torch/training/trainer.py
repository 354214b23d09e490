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
ranks; only rank 0 prints and writes the epoch log and the checkpoints.

Checkpoints (`training/checkpoint.py`, the JAX package's legacy format):
`save_best` writes `ckpt` after each epoch whose validation acc1 beats
the best so far, `save_last` writes `last` after every epoch (its `acc`
is the best so far), and `resume` restores the newer of the two by
recorded epoch and continues from the epoch after it. A save is timed
by the `checkpoint_blocked` span and the `train_checkpoint_blocked_s`
histogram.

Left to later slices, and refused rather than skipped: the sharded
checkpoint format and `async_save`, `steps_per_dispatch > 1`,
`profile_dir`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Iterable, Optional

from distributed_model_parallel_tpu_torch.models.convert import (
    train_state_from_jax,
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.observability.metrics import (
    get_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (
    get_tracer,
)
from distributed_model_parallel_tpu_torch.runtime.dist import is_primary
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    SHARDED_SLICE,
    newest_checkpoint_name,
    restore_checkpoint,
    save_checkpoint,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    cosine_warmup_schedule,
)

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
    """Trainer hyperparameters, the reference's fields. The sharded
    checkpoint, dispatch-grouping and profiler fields exist so a
    configuration crosses between the packages; their non-default values
    are refused until their slices land."""

    epochs: int = 100
    base_lr: float = 0.1
    t_max: int = 90
    warmup_period: int = 10
    print_freq: int = 30
    log_dir: str = "./log"
    log_file: Optional[str] = None      # txt epoch log (e.g. "512.txt")
    checkpoint_dir: str = "./checkpoint"
    save_best: bool = True
    resume: bool = False
    # Truncate each training epoch to N batches (0 = full epoch).
    steps_per_epoch: int = 0
    steps_per_dispatch: int = 1
    profile_dir: Optional[str] = None
    # Also write a 'last' checkpoint at the end of every epoch; resume
    # prefers it over the best-acc 'ckpt' when it is newer.
    save_last: bool = False
    checkpoint_format: str = "legacy"
    async_save: bool = False
    # JSON-able fields added to the checkpoint sidecar (the LM CLI
    # records its GPTConfig, which `cli/serve.py --checkpoint` checks).
    checkpoint_extra: Optional[dict] = None


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
            ("checkpoint_format", config.checkpoint_format != "legacy",
             SHARDED_SLICE),
            ("async_save", config.async_save, SHARDED_SLICE),
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
        self.start_epoch = 0
        if config.resume:
            self._resume()
        self.history: list = []

    def _resume(self) -> None:
        """Restore the newer of 'last' and 'ckpt' (rank 0 reads, the
        others receive it) and continue from the epoch after it."""
        cfg = self.config
        name = newest_checkpoint_name(cfg.checkpoint_dir)
        tree, self.best_acc, last_epoch = restore_checkpoint(
            cfg.checkpoint_dir, train_state_spec(self.state), name=name)
        self.state = train_state_from_jax(tree, self.state)
        self.start_epoch = last_epoch + 1
        self._log_print(f"==> Resumed from checkpoint: epoch {last_epoch}, "
                        f"best acc {self.best_acc:.3f}")
        if self.start_epoch >= cfg.epochs:
            # As in the JAX package (and unlike the reference, which
            # trains `epochs` further epochs): fit() runs
            # range(start_epoch, epochs), so say that it will do nothing.
            self._log_print(
                f"==> WARNING: checkpoint is at epoch {last_epoch} but "
                f"--epochs is {cfg.epochs}; fit() will train 0 epochs. "
                "Raise --epochs to continue training.")

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
        """Train, validate, checkpoint and log each epoch from
        `start_epoch`."""
        cfg = self.config
        for epoch in range(self.start_epoch, cfg.epochs):
            train_stats = self.train_epoch(epoch)
            val_stats = (self.validate(epoch) if self.val_loader is not None
                         else EpochStats())
            is_best = (cfg.save_best and self.val_loader is not None
                       and val_stats.acc1 > self.best_acc)
            if is_best or cfg.save_last:
                # Once an epoch; rank 0 alone writes.
                payload = (train_state_to_jax(self.state) if is_primary()
                           else None)
            if is_best:
                self.best_acc = val_stats.acc1
                self._log_print("Saving..")
                self._write_checkpoint(payload, "ckpt", epoch)
            if cfg.save_last:
                # acc is the best so far: this epoch's would let a resume
                # lower best_acc and a worse model overwrite 'ckpt'.
                self._write_checkpoint(payload, "last", epoch)
            self._append_epoch_log(epoch, train_stats, val_stats)
        return {"best_acc": self.best_acc, "epochs": cfg.epochs,
                "history": self.history}

    def _write_checkpoint(self, payload, name: str, epoch: int) -> None:
        """One save, timed by the `checkpoint_blocked` span and the
        `train_checkpoint_blocked_s` histogram: how long it holds the
        epoch loop."""
        cfg = self.config
        tracer = get_tracer()
        mx = get_metrics()
        t0 = tracer.now() if mx.enabled else None
        try:
            with tracer.span("checkpoint_blocked", snapshot=name,
                             epoch=epoch, format=cfg.checkpoint_format):
                save_checkpoint(cfg.checkpoint_dir, payload,
                                acc=self.best_acc, epoch=epoch, name=name,
                                extra=cfg.checkpoint_extra)
        finally:
            if t0 is not None:
                mx.observe("train_checkpoint_blocked_s", tracer.now() - t0)

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
