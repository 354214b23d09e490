"""Fail-fast + restart-from-checkpoint driver loop, with mesh resize
(port of `training/elastic.py`).

Training runs under a supervisor that catches a failed attempt, rebuilds
the trainer, resumes from the newest checkpoint (`TrainerConfig.
save_last` writes one per epoch), and retries up to `max_restarts` times
with capped exponential backoff. Failures that exhaust the budget
re-raise: fail-fast, never hang.

Elasticity (not only retry) rides the sharded checkpoint format
(`checkpointing/`): when `checkpoint_dir` is given, the supervisor reads
the manifest's saved mesh and hands it to `make_trainer`, which may build
on a RESIZED mesh; the resharding restore re-slices the canonical state
for whatever mesh the new trainer built. A `make_trainer` that accepts
only `(resume)` keeps the retry-only contract.

Over `torch.distributed` a restart inside one launch keeps its world (a
lost rank fails the others' collectives within the process group's
timeout, and that error lands here); a resize is a new launch at another
`--nproc-per-node`, which restores the sharded file at its own N.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Optional, Sequence


def _wants_topology(make_trainer: Callable) -> bool:
    """True when `make_trainer` accepts a second positional parameter
    (the saved-topology dict) — the opt-in for mesh resize."""
    try:
        params = [
            p for p in inspect.signature(make_trainer).parameters.values()
            if p.kind in (
                p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL
            )
        ]
    except (TypeError, ValueError):  # builtins / odd callables
        return False
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    return len(params) >= 2


def backoff_schedule(
    attempt: int,
    backoff_seconds: float,
    max_backoff_seconds: float,
) -> float:
    """Capped exponential: `backoff * 2**(attempt-1)`, clamped to
    `max_backoff_seconds` (attempt counts from 1). Pure so the schedule
    is testable without sleeping."""
    if attempt < 1:
        raise ValueError(f"attempt counts from 1, got {attempt}")
    return min(
        backoff_seconds * (2.0 ** (attempt - 1)), max_backoff_seconds
    )


def elastic_fit(
    make_trainer: Callable[..., Any],
    *,
    max_restarts: int = 2,
    backoff_seconds: float = 1.0,
    max_backoff_seconds: float = 60.0,
    jitter: Optional[Callable[[int], float]] = None,
    retry_on: Sequence[type] = (Exception,),
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_name: str = "last",
) -> dict:
    """Run `make_trainer(resume).fit()` with restart-on-failure.

    `make_trainer(resume: bool)` must build a FRESH trainer; it receives
    resume=False on the first attempt and resume=True afterwards (its
    TrainerConfig should set `resume=resume and a checkpoint exists`, and
    `save_last=True` so restarts lose at most one epoch).

    Accepting a SECOND positional parameter opts into elasticity:
    `make_trainer(resume, topology)` receives the saved mesh
    factorization of the newest checkpoint under `checkpoint_dir`
    (`checkpointing.saved_topology` — a dict with 'mesh_axes',
    'process_count', 'epoch'; None on the first attempt, for legacy
    checkpoints, or when `checkpoint_dir` is not given) and may build
    its engine on a resized mesh; the sharded restore reshards the
    state to fit.

    Backoff before attempt k (k>=1) sleeps
    `min(backoff_seconds * 2**(k-1), max_backoff_seconds)` plus
    `jitter(k)` when a jitter hook is given (thundering-herd spread for
    fleet restarts). KeyboardInterrupt always propagates immediately.

    The returned summary (the final attempt's `fit()` dict) gains an
    `"elastic"` entry recording every restart's exception type and the
    backoff actually applied.
    """
    wants_topology = _wants_topology(make_trainer)
    restarts: list = []
    attempt = 0
    while True:
        topology = None
        if wants_topology and attempt > 0 and checkpoint_dir is not None:
            from distributed_model_parallel_tpu_torch.checkpointing import (
                saved_topology,
            )

            topology = saved_topology(checkpoint_dir, checkpoint_name)
        if wants_topology:
            trainer = make_trainer(attempt > 0, topology)
        else:
            trainer = make_trainer(attempt > 0)
        try:
            result = trainer.fit()
            result["elastic"] = {
                "attempts": attempt + 1,
                "restarts": list(restarts),
            }
            return result
        except KeyboardInterrupt:
            raise
        except tuple(retry_on) as e:  # noqa: BLE001 — policy boundary
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            delay = backoff_schedule(
                attempt, backoff_seconds, max_backoff_seconds
            )
            if jitter is not None:
                delay += float(jitter(attempt))
            restarts.append({
                "attempt": attempt,
                "error_type": type(e).__name__,
                "error": str(e),
                "backoff_s": delay,
            })
            print(
                f"==> attempt {attempt}/{max_restarts} failed with "
                f"{type(e).__name__}: {e}; restarting from checkpoint "
                f"in {delay:.1f}s",
                flush=True,
            )
            time.sleep(delay)


__all__ = ["backoff_schedule", "elastic_fit"]
