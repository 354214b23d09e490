"""Per-rank sharded input pipeline with prefetch and a native hot loop
(port of `data/loader.py`).

Each rank deterministically owns a disjoint shard of every epoch (the
DistributedSampler the reference lacks) and feeds only that shard to
its engine. Augmentation is the reference's CIFAR train transform:
random crop 32 with padding 4, random horizontal flip, normalize. Two
implementations with identical numerics: a vectorized NumPy path, and
the C++ module (`native/augment.cpp`, std::thread pool, GIL released)
used when it builds. `workers` (the CLI's `-j`) sizes the native thread
pool; `prefetch` batches are staged ahead of the training loop by one
producer thread, so augmentation overlaps the device step.

Batches are bit-identical to the reference Loader's for the same
(seed, epoch, rank, batch), on either backend.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from distributed_model_parallel_tpu_torch import native
from distributed_model_parallel_tpu_torch.data.datasets import ArrayDataset


def _draw_augment(rng: np.random.RandomState, n: int, padding: int):
    ys = rng.randint(0, 2 * padding + 1, size=n)
    xs = rng.randint(0, 2 * padding + 1, size=n)
    flips = rng.rand(n) < 0.5
    return ys, xs, flips


def _crop_flip_numpy(images, ys, xs, flips, padding):
    n, h, w, c = images.shape
    padded = np.pad(
        images,
        ((0, 0), (padding, padding), (padding, padding), (0, 0)),
        mode="constant",
    )
    # (n, 2p+1, 2p+1, c, h, w) view; gather each image's window.
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (h, w), axis=(1, 2)
    )
    out = windows[np.arange(n), ys, xs]          # (n, c, h, w)
    out = np.ascontiguousarray(out.transpose(0, 2, 3, 1))  # NHWC
    out[flips] = out[flips, :, ::-1]
    return out


def normalize(images: np.ndarray, mean: np.ndarray,
              std: np.ndarray) -> np.ndarray:
    return (images.astype(np.float32) / 255.0 - mean) / std


def device_normalizer(mean: np.ndarray, std: np.ndarray):
    """The same `(x / 255 - mean) / std` as a torch function on the
    device, for an engine's `input_transform`; pair with
    `Loader(device_normalize=True)`, whose batches stay uint8 (4x fewer
    host-to-device bytes). Every divisor is a tensor: torch on CUDA turns
    a division by a Python scalar into a multiply by its reciprocal,
    which rounds differently."""
    mean = torch.from_numpy(np.asarray(mean, np.float32))
    std = torch.from_numpy(np.asarray(std, np.float32))
    full = torch.tensor(255.0)

    def transform(images: torch.Tensor) -> torch.Tensor:
        dev = images.device
        return ((images.float() / full.to(dev) - mean.to(dev))
                / std.to(dev))

    return transform


@dataclasses.dataclass
class Loader:
    """Deterministic, rank-sharded batch iterator.

    `process_index` / `process_count` (the rank and the world): after
    the epoch shuffle (seeded by epoch, the same on every rank) each rank
    takes every `process_count`-th index; the order is padded by wrapping
    so every rank's shard has the same length. With `drop_last=False` a
    ragged final batch is padded back to `batch_size` with label -1 rows
    (masked out by the metrics). `batch_size` is this rank's batch.
    Augmentation draws are keyed by (seed, epoch, rank, batch index), so
    batches are identical for every `workers` / `prefetch` setting and
    for both backends (`use_native=None` picks native when it builds).
    `raw=True` ships token-id batches as the dataset holds them."""

    dataset: ArrayDataset
    batch_size: int
    shuffle: bool = True
    augment: bool = False
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    drop_last: bool = True
    workers: int = 1
    prefetch: int = 2
    use_native: Optional[bool] = None  # None = auto-detect
    # Yield augmented uint8 batches; the engine normalizes on the device
    # (`input_transform = device_normalizer(mean, std)`).
    device_normalize: bool = False
    # Yield gathered batches untouched (no augment, no normalize, no
    # dtype cast): non-image data (token ids), where /255 would be
    # nonsense. Ragged-final-batch padding still applies.
    raw: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.device_normalize and self.use_native is True:
            raise ValueError(
                "device_normalize=True conflicts with use_native=True: the "
                "native hot loop is the fused host-side augment+NORMALIZE; "
                "with device-side normalization the augmentation runs the "
                "vectorized NumPy uint8 path"
            )
        if self.use_native is True and self.mean is None:
            raise ValueError("use_native=True requires mean/std (the native "
                             "hot loop is the fused augment+normalize)")
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        # Every rank sees the same padded shard size (ceil(n/P)), so batch
        # counts agree and no rank waits alone in a collective.
        per_host = -(-len(self.dataset) // self.process_count)
        if self.drop_last:
            return per_host // self.batch_size
        return -(-per_host // self.batch_size)

    # ------------------------------------------------------------ batches

    def _native_ok(self) -> bool:
        if self.use_native is False:
            return False
        ok = native.available()
        if self.use_native is True and not ok:
            raise RuntimeError(
                "use_native=True but the native library failed to build"
            )
        return ok

    def _make_batch(self, b: int, idx, use_native: bool):
        """Batch `b` (gather, augment, normalize, pad): a pure function
        of (seed, epoch, rank, b)."""
        images, labels = self.dataset.gather(idx)
        aug_rng = np.random.RandomState(
            ((self.seed + self._epoch) * 1009 + self.process_index) * 7919
            + b
        )
        if self.raw:
            pass  # token ids: ship exactly what the dataset holds
        elif self.device_normalize:
            # Ship the augmented uint8 bytes; the same keyed draws as a
            # host-normalize run of the same (seed, epoch, rank, batch).
            if self.augment:
                ys, xs, flips = _draw_augment(aug_rng, len(images), 4)
                images = _crop_flip_numpy(images, ys, xs, flips, 4)
        elif self.augment:
            ys, xs, flips = _draw_augment(aug_rng, len(images), 4)
            if (use_native and self.mean is not None
                    and images.dtype == np.uint8):
                images = native.augment_normalize(
                    images, ys, xs, flips, 4, self.mean, self.std,
                    workers=self.workers,
                )
            else:
                images = _crop_flip_numpy(images, ys, xs, flips, 4)
                images = self._normalize_np(images)
        elif use_native and self.mean is not None and images.dtype == np.uint8:
            images = native.normalize(images, self.mean, self.std,
                                      workers=self.workers)
        else:
            images = self._normalize_np(images)
        if len(idx) < self.batch_size:
            # Ragged final batch (drop_last=False): pad to the static
            # batch shape with label -1 rows.
            pad_n = self.batch_size - len(idx)
            images = np.concatenate(
                [images, np.zeros((pad_n,) + images.shape[1:], images.dtype)]
            )
            labels = np.concatenate(
                [labels, np.full((pad_n,), -1, labels.dtype)]
            )
        return images, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self._epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        # Pad to a multiple of process_count by wrapping (DistributedSampler
        # semantics) so every rank's strided shard has the same length.
        per_host = -(-n // self.process_count)
        pad = per_host * self.process_count - n
        if pad:
            order = np.concatenate([order, np.tile(order, -(-pad // n))[:pad]])
        mine = order[self.process_index::self.process_count]
        nb = len(self)
        use_native = self._native_ok() and self.mean is not None
        batches = (
            mine[b * self.batch_size:(b + 1) * self.batch_size]
            for b in range(nb)
        )
        indexed = ((b, idx) for b, idx in enumerate(batches) if len(idx) > 0)
        if self.prefetch <= 0:
            for b, idx in indexed:
                yield self._make_batch(b, idx, use_native)
            return
        yield from self._prefetched(indexed, use_native)

    def _normalize_np(self, images):
        if self.mean is not None:
            return normalize(images, self.mean, self.std)
        return images.astype(np.float32) / 255.0

    def _prefetched(self, indexed, use_native: bool):
        """One producer thread keeps up to `prefetch` ready batches in a
        bounded queue; batches are yielded in order. A consumer that
        abandons the iterator early (the Trainer's steps_per_epoch) is
        handled in `finally`: the producer is stopped and joined, so no
        thread or staged batch outlives the epoch."""
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        sentinel = object()
        stop = threading.Event()
        error = []

        def put_until_stop(item) -> bool:
            """Blocking put that gives up once the consumer has stopped.
            The sentinel goes through it too: a dropped sentinel would
            leave the consumer waiting on q.get() forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b, idx in indexed:
                    if stop.is_set():
                        return
                    if not put_until_stop(self._make_batch(b, idx,
                                                           use_native)):
                        return
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                error.append(e)
            finally:
                put_until_stop(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            try:  # unblock a producer stuck on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10)
        if error:
            raise error[0]


__all__ = ["Loader", "device_normalizer", "normalize"]
