"""Background checkpoint writer (port of `checkpointing/writer.py`): file
I/O off the step path.

The save path splits in two exactly once:

  main thread      snapshot: device->host copy of the rank's owned
                   chunks into host buffers (`sharded.local_chunk_data`)
                   + the write plan. This is the only part the train
                   loop waits for; it scales with 1/N of the state.
  writer thread    file I/O: shard npz (tmp + rename), peer-shard wait
                   (multi-rank shared FS), manifest commit, stale-
                   shard GC. Runs while steps N+1, N+2, ... dispatch.

Failure surface — NEVER silent: each job's exception is stored on its
`SaveHandle` and on the checkpointer; `AsyncCheckpointer.check()` (the
trainer calls it at the NEXT save) and `.wait()` (called at `fit()`
exit) re-raise it. A crash mid-write cannot clobber the previous good
checkpoint: shard files carry the new save-id in their names and the
manifest — the commit point — is written last (see manifest.py).

`_write_shard` is module-level so tests can monkeypatch it with an
artificially slow or crashing writer (the not-blocked and mid-write
crash tests in tests/test_torch_port_checkpoint_sharded.py).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, List, Optional

import numpy as np


def _write_shard(path: str, arrays: dict) -> None:
    """One shard npz, atomically (tmp + rename). Monkeypatch target for
    the slow-writer / crash tests."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class SaveHandle:
    """Ticket for one in-flight (or completed) save."""

    def __init__(self, path: str):
        self.path = path            # the manifest path once committed
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    def _finish(self, error: Optional[BaseException]) -> None:
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the write lands; re-raise its failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"checkpoint write to {self.path} still in flight after "
                f"{timeout}s"
            )
        if self._error is not None:
            raise self._error

    def result(self, timeout: Optional[float] = None) -> str:
        self.wait(timeout)
        return self.path


class AsyncCheckpointer:
    """One background thread, jobs in submission order (a 'best' and a
    'last' save of the same epoch must not interleave their renames).
    The thread is a daemon and is also joined explicitly by `wait()` —
    the trainer calls that at `fit()` exit so no write is abandoned."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pending: List[SaveHandle] = []
        self._unraised: Optional[BaseException] = None
        self._reserved_ids: dict = {}  # (directory, name) -> last id

    # ------------------------------------------------------------ worker

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ckpt-writer", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        # Local imports keep this module's surface numpy-only for the
        # monkeypatching tests; tracer and registry are stdlib-only
        # and thread-safe by contract.
        from distributed_model_parallel_tpu_torch.observability.metrics \
            import get_metrics
        from distributed_model_parallel_tpu_torch.observability.trace \
            import get_tracer

        while True:
            item = self._queue.get()
            if item is None:
                return
            job, handle = item
            tracer = get_tracer()
            mx = get_metrics()
            t0 = tracer.now() if mx.enabled else None
            try:
                # The I/O half of a save, on THIS thread — the span the
                # Chrome trace shows running beside the main loop's
                # steps (the step path only paid ckpt_snapshot).
                with tracer.span(
                    "ckpt_background_write", path=handle.path
                ):
                    job()
                if t0 is not None:
                    mx.observe(
                        "ckpt_background_write_s", tracer.now() - t0
                    )
                handle._finish(None)
            except BaseException as e:  # noqa: BLE001 — stored, re-raised
                # Store the checkpointer-level error BEFORE publishing
                # the handle's done event: a waiter unblocking on the
                # event and immediately calling check() must already
                # see the failure (never-silent contract).
                with self._lock:
                    if self._unraised is None:
                        self._unraised = e
                handle._finish(e)

    # ------------------------------------------------------------ public

    def reserve_save_id(
        self, directory: str, name: str, floor: int
    ) -> int:
        """Monotonic save-id reservation across IN-FLIGHT saves of the
        same (directory, name): the on-disk manifest only reflects
        COMMITTED saves, so a snapshot racing a still-writing
        predecessor would otherwise reuse its id — and with it the
        shard filenames whose per-save uniqueness the crash discipline
        rests on (manifest.py)."""
        key = (os.path.abspath(directory), name)
        with self._lock:
            last = self._reserved_ids.get(key)
            sid = floor if last is None else max(floor, last + 1)
            self._reserved_ids[key] = sid
        return sid

    def submit(self, job: Callable[[], None], path: str) -> SaveHandle:
        """Enqueue the I/O half of a save; returns immediately."""
        handle = SaveHandle(path)
        with self._lock:
            self._pending.append(handle)
        self._ensure_thread()
        self._queue.put((job, handle))
        return handle

    def check(self) -> None:
        """Surface (raise) the oldest unsurfaced write failure — the
        trainer calls this at the START of every save so an epoch-N
        failure cannot hide behind epoch N+1's success."""
        with self._lock:
            err, self._unraised = self._unraised, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Drain every pending write, then surface any failure (fit()
        exit). Idempotent."""
        with self._lock:
            pending, self._pending = self._pending, []
        for h in pending:
            h._done.wait()
        self.check()

    def pending(self) -> int:
        with self._lock:
            return sum(1 for h in self._pending if not h.done())


__all__ = ["AsyncCheckpointer", "SaveHandle", "_write_shard"]
