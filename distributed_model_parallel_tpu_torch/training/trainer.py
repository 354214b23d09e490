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

Checkpoints: `save_best` writes `ckpt` after each epoch whose
validation acc1 beats the best so far, `save_last` writes `last` after
every epoch (its `acc` is the best so far), and `resume` restores the
newer of the two by recorded epoch and continues from the epoch after
it, through the unified reader (`checkpointing/restore.py`: either
format). Two formats, the JAX package's:
* `checkpoint_format="legacy"` (`training/checkpoint.py`): one `.npz`
  written by rank 0; an engine that shards its state
  (`collective_checkpoint = True`) gathers it through `to_canonical` on
  every rank and re-slices a restore through `from_canonical`;
* `"sharded"` (`checkpointing/`): every rank writes the chunks it owns of
  the engine's `to_canonical_sharded` view (a replicated state's view
  for the data-parallel and LM engines), with no collective; an engine
  whose canonical form restructures its state (the pipeline's) is
  refused with the reference's message. `async_save` moves the file I/O
  to a background writer; its errors surface at the next save or when
  `fit()` exits, and `fit()` drains it, on a failure too.
A save is timed by the `checkpoint_blocked` span and the
`train_checkpoint_blocked_s` histogram: the whole write, or only the
snapshot under `async_save`.

Dispatch groups (`training/multistep.py`): with `steps_per_dispatch` k
> 1 the loop pulls k batches a group and runs them in one dispatch (a
CUDA graph replayed k times on the card, k eager steps on the CPU);
an epoch shorter than k clamps k to its length, with a message, and a
short tail group runs step by step. `validate` groups its batches the
same way. `profile_dir` captures a `torch.profiler` trace (Chrome JSON,
CPU and, on the card, CUDA activity) of the whole dispatch groups that
cover three steps, from the first group that starts at or past step 10
(or from the first group, when the epoch is too short): three steps at
k = 1, one group of k steps when k >= 3. It writes the trace into the
directory and prints its path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Iterable, Optional

import torch

from distributed_model_parallel_tpu_torch.checkpointing import (
    AsyncCheckpointer,
    restore_checkpoint,
    save_sharded,
    sharded_state,
)
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
from distributed_model_parallel_tpu_torch.runtime.mesh import mesh_axes
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    newest_checkpoint_name,
    save_checkpoint,
)
from distributed_model_parallel_tpu_torch.training.multistep import (
    add_sums,
    compile_multi_eval,
    compile_multi_step,
    group_batches,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    cosine_warmup_schedule,
)


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
    """Trainer hyperparameters, the reference's fields."""

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
    # Train steps per dispatch (`training/multistep.py`); 1 = off.
    steps_per_dispatch: int = 1
    # Write a torch.profiler trace of the dispatch groups covering three
    # steady-state steps here (one group of k steps when k >= 3).
    profile_dir: Optional[str] = None
    # Also write a 'last' checkpoint at the end of every epoch; resume
    # prefers it over the best-acc 'ckpt' when it is newer.
    save_last: bool = False
    # "legacy": one .npz gathered to rank 0; "sharded": every rank writes
    # its own chunks + a JSON manifest (`checkpointing/`). Restore reads
    # either.
    checkpoint_format: str = "legacy"
    # Move the sharded format's file I/O off the step path.
    async_save: bool = False
    # JSON-able fields added to the checkpoint sidecar (the LM CLI
    # records its GPTConfig, which `cli/serve.py --checkpoint` checks).
    checkpoint_extra: Optional[dict] = None


class Trainer:
    """Drives an engine through the reference's epoch protocol."""

    def __init__(self, engine: Any, train_loader: Iterable,
                 val_loader: Optional[Iterable], config: TrainerConfig,
                 seed: int = 0):
        if config.checkpoint_format not in ("legacy", "sharded"):
            raise ValueError(
                "checkpoint_format must be 'legacy' or 'sharded', got "
                f"{config.checkpoint_format!r}")
        if config.async_save and config.checkpoint_format != "sharded":
            raise ValueError(
                "async_save moves the sharded writer off the step path; "
                "it requires checkpoint_format='sharded' (the legacy "
                "format gathers to host 0 synchronously by design)")
        self._ckpt_writer = AsyncCheckpointer() if config.async_save \
            else None
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
        self._profiled = False
        k = max(1, config.steps_per_dispatch)
        # Built now so that an engine that cannot be captured is refused
        # before the first epoch; rebuilt when an epoch clamps k.
        self._multi = compile_multi_step(engine, k)
        self._multi_eval = compile_multi_eval(engine, k)
        self._multi.k = self._multi_eval.k = k
        #: the path of the profiler trace, once written
        self.profile_path: Optional[str] = None

    def _resume(self) -> None:
        """Restore the newer of 'last' and 'ckpt', of either format (rank
        0 reads, the others receive it; a sharded file saved on another
        mesh is re-sliced for this one) and continue from the epoch
        after it."""
        cfg = self.config
        eng = self.engine
        name = newest_checkpoint_name(cfg.checkpoint_dir)
        sharded = getattr(eng, "collective_checkpoint", False)
        tree, self.best_acc, last_epoch = restore_checkpoint(
            cfg.checkpoint_dir, eng.canonical_spec(self.state) if sharded
            else train_state_spec(self.state), name=name)
        self.state = (eng.from_canonical(tree, self.state) if sharded
                      else train_state_from_jax(tree, self.state))
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

    def _group_fn(self, k: int):
        if getattr(self._multi, "k", None) != k:
            self._multi = compile_multi_step(self.engine, k)
            self._multi.k = k
        return self._multi

    @staticmethod
    def _start_profile():
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the trace starts on an idle card
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, epoch: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        self._profiled = True
        if is_primary():
            os.makedirs(self.config.profile_dir, exist_ok=True)
            path = os.path.join(self.config.profile_dir,
                                f"trace_epoch{epoch}.json")
            prof.export_chrome_trace(path)
            self.profile_path = path
            self._log_print(f"==> wrote profiler trace to {path}")

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
        k = max(1, cfg.steps_per_dispatch)
        if n_avail is not None and k > n_avail:
            # A group larger than the epoch would never fill, and every
            # epoch would run step by step: clamp so that one grouped
            # dispatch runs per epoch.
            if not getattr(self, "_warned_k_clamp", False):
                self._log_print(
                    f"==> steps_per_dispatch {k} exceeds the "
                    f"{n_avail}-batch epoch; clamping to {n_avail}")
                self._warned_k_clamp = True
            k = max(1, n_avail)
        # Profile the whole groups that cover three steps (one group when
        # k >= 3), from the first group that starts at or past
        # step 10 (past the warmup and the graph capture); an epoch too
        # short for that profiles its first dispatch, so the trace is
        # never empty.
        profile_at = None
        if cfg.profile_dir and not self._profiled:
            profile_at = 10 if (n_avail is None or n_avail > 12) else 0
            if profile_at and k > 1:
                ga = ((profile_at + k - 1) // k) * k
                profile_at = ga if (n_avail is None or ga < n_avail) else 0
        prof = None
        sums = None
        n_batches = 0
        data_time = 0.0

        def fetch_group(n_done: int) -> list:
            """The next group (up to k batches) on the device; [] when
            the epoch (or its steps_per_epoch budget) is done."""
            nonlocal data_time
            want = k
            if cfg.steps_per_epoch:
                want = min(k, cfg.steps_per_epoch - n_done)
                if want <= 0:
                    return []
            with tracer.span("fetch", want=want):
                t0 = time.perf_counter()
                tm0 = tracer.now() if mx.enabled else 0.0
                host_batches = group_batches(it, want)
                data_time += time.perf_counter() - t0
                if mx.enabled and host_batches:
                    mx.observe("train_fetch_s",
                               (tracer.now() - tm0) / len(host_batches))
                return [self.engine.shard_batch(*b) for b in host_batches]

        epoch_start = time.perf_counter()
        t_boundary = tracer.now() if mx.enabled else None
        printable = None
        placed = fetch_group(0)
        while placed:
            if profile_at is not None and prof is None \
                    and n_batches >= profile_at:
                prof = self._start_profile()
            with tracer.span("step", n=len(placed)):
                if len(placed) == k and k > 1:
                    self.state, metrics = self._group_fn(k)(
                        self.state, placed, lr)
                else:  # k = 1, or the epoch's short tail
                    metrics = None
                    for b in placed:
                        self.state, m_i = self.engine.train_step(
                            self.state, *b, lr)
                        metrics = add_sums(metrics, m_i)
            prev = n_batches
            n_group = len(placed)
            n_batches += n_group
            # The next group's host load and copy overlap the steps the
            # device is still running.
            placed = fetch_group(n_batches)
            if prof is not None and n_batches >= profile_at + 3:
                self._stop_profile(prof, epoch)
                prof, profile_at = None, None
            sums = add_sums(sums, metrics)
            if mx.enabled:
                t_now = tracer.now()
                if t_boundary is not None:
                    mx.observe("train_step_s",
                               (t_now - t_boundary) / n_group)
                mx.inc("train_batches_total", n_group)
                t_boundary = t_now
            if cfg.print_freq and (
                n_batches // cfg.print_freq > prev // cfg.print_freq
            ):
                # Print the PREVIOUS group's metrics: a newer dispatch
                # already runs behind them, so reading them does not
                # stall on it.
                snap_n, snap = (printable if printable is not None
                                else (n_batches, metrics))
                with tracer.span("sync"):
                    m = {key: float(v) for key, v in snap.items()}
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
                sums = {key: float(v) for key, v in sums.items()}
        if prof is not None:  # the epoch ended inside the capture window
            self._stop_profile(prof, epoch)
        wall = time.perf_counter() - epoch_start
        return self._finalize(sums, n_batches, wall, data_time)

    def validate(self, epoch: int) -> EpochStats:
        """Validation in groups of steps_per_dispatch batches (clamped to
        the loader's length), a short tail batch by batch."""
        sums = None
        n_batches = 0
        data_time = 0.0
        k = max(1, self.config.steps_per_dispatch)
        if hasattr(self.val_loader, "__len__"):
            k = max(1, min(k, len(self.val_loader)))
        if getattr(self._multi_eval, "k", None) != k:
            self._multi_eval = compile_multi_eval(self.engine, k)
            self._multi_eval.k = k
        epoch_start = time.perf_counter()
        it = iter(self.val_loader)
        while True:
            t0 = time.perf_counter()
            host_batches = group_batches(it, k)
            data_time += time.perf_counter() - t0
            if not host_batches:
                break
            placed = [self.engine.shard_batch(*b) for b in host_batches]
            if len(placed) == k and k > 1:
                metrics = self._multi_eval(self.state, placed)
            else:
                metrics = None
                for b in placed:
                    metrics = add_sums(metrics,
                                   self.engine.eval_step(self.state, *b))
            sums = add_sums(sums, metrics)
            n_batches += len(placed)
        if sums is not None:
            sums = {key: float(v) for key, v in sums.items()}
        wall = time.perf_counter() - epoch_start
        return self._finalize(sums, n_batches, wall, data_time)

    def fit(self) -> dict:
        """Train, validate, checkpoint and log each epoch from
        `start_epoch`. On a failure the background writer is drained
        first (a restart reads the directory at once); a write failure
        met there is printed, not raised, so that the training error is
        the one that propagates."""
        try:
            return self._fit()
        except BaseException:
            if self._ckpt_writer is not None:
                try:
                    self._ckpt_writer.wait()
                except Exception as we:  # noqa: BLE001 -- reported below
                    self._log_print(
                        "==> WARNING: background checkpoint write failed "
                        f"during abort: {we!r}")
            raise

    def _fit(self) -> dict:
        cfg = self.config
        for epoch in range(self.start_epoch, cfg.epochs):
            train_stats = self.train_epoch(epoch)
            val_stats = (self.validate(epoch) if self.val_loader is not None
                         else EpochStats())
            is_best = (cfg.save_best and self.val_loader is not None
                       and val_stats.acc1 > self.best_acc)
            if is_best or cfg.save_last:
                payload = self._checkpoint_payload()  # once an epoch
            if is_best:
                self.best_acc = val_stats.acc1
                self._log_print("Saving..")
                self._write_checkpoint(payload, "ckpt", epoch)
            if cfg.save_last:
                # acc is the best so far: this epoch's would let a resume
                # lower best_acc and a worse model overwrite 'ckpt'.
                self._write_checkpoint(payload, "last", epoch)
            self._append_epoch_log(epoch, train_stats, val_stats)
        if self._ckpt_writer is not None:
            # The last point where a background write's error surfaces,
            # and the join that makes the final snapshot durable.
            self._ckpt_writer.wait()
        return {"best_acc": self.best_acc, "epochs": cfg.epochs,
                "history": self.history}

    def _checkpoint_payload(self):
        """What the epoch's saves write: the canonical tree rank 0 writes
        (legacy), or the engine's `to_canonical_sharded` view (sharded),
        a replicated state's own view for an engine without that seam,
        and a refusal for an engine whose canonical form restructures
        its state."""
        if self.config.checkpoint_format == "legacy":
            return self._canonical_payload()
        fn = getattr(self.engine, "to_canonical_sharded", None)
        if fn is not None:
            return fn(self.state)
        if getattr(self.engine, "to_canonical", None) is not None:
            raise ValueError(
                f"{type(self.engine).__name__} defines a RESTRUCTURING "
                "canonical form (to_canonical) without a "
                "to_canonical_sharded seam, so its runtime layout cannot "
                "be written shard-for-shard; use checkpoint_format="
                "'legacy' with this engine")
        mesh = getattr(self.engine, "mesh", None)
        return sharded_state(self.state,
                             mesh_axes=mesh_axes(mesh) if mesh else None)

    def _canonical_payload(self):
        """The canonical tree rank 0 writes (None on the other ranks). An
        engine that shards its state (`collective_checkpoint`: tensor
        parallelism) gathers it on every rank, collectively."""
        if getattr(self.engine, "collective_checkpoint", False):
            tree = self.engine.to_canonical(self.state)
            return tree if is_primary() else None
        return train_state_to_jax(self.state) if is_primary() else None

    def _write_checkpoint(self, payload, name: str, epoch: int) -> None:
        """One save, timed by the `checkpoint_blocked` span and the
        `train_checkpoint_blocked_s` histogram: how long it holds the
        epoch loop (the snapshot only, under `async_save`)."""
        cfg = self.config
        tracer = get_tracer()
        mx = get_metrics()
        t0 = tracer.now() if mx.enabled else None
        try:
            with tracer.span("checkpoint_blocked", snapshot=name,
                             epoch=epoch, format=cfg.checkpoint_format):
                if cfg.checkpoint_format == "legacy":
                    save_checkpoint(cfg.checkpoint_dir, payload,
                                    acc=self.best_acc, epoch=epoch,
                                    name=name, extra=cfg.checkpoint_extra)
                    return
                if self._ckpt_writer is not None:
                    # An earlier epoch's failed background write surfaces
                    # before a new one starts.
                    self._ckpt_writer.check()
                save_sharded(cfg.checkpoint_dir, payload, acc=self.best_acc,
                             epoch=epoch, name=name,
                             extra=cfg.checkpoint_extra,
                             writer=self._ckpt_writer)
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
