"""Device-resident dataset cache (port of `data/device_cache.py`): the
input pipeline for datasets that fit in the card's memory.

The reference's DataLoader ships every batch host -> device each step.
Here the whole uint8 NHWC dataset uploads to the device ONCE (CIFAR-10
train and val: 60,000 x 3,072 B = 184 MB), each step ships only the
batch's int32 index vector, and the gather, the crop / flip
augmentation and the normalize run on the device, inside the engine's
step (`parallel/data_parallel.apply_input_transform`).

* `IndexLoader` reproduces `Loader`'s sampling exactly (the per-epoch
  seeded permutation, the per-rank strided shard, the batching) but
  yields `(indices, labels)`; a ragged final batch pads its indices
  with row 0 and its labels with -1.
* `DeviceDatasetCache.transform()` is an `input_transform` with
  `wants_ctx = True`: engines call it as `tf(indices, step=, train=)`;
  augmentation applies only when `train` is true.
* Augmentation bits. The reference draws its crops and flips with
  `jax.random`, keyed by (seed, step, indices[0]); those bits cannot be
  matched. The port draws them from its counter hash
  (`models/layers.fold_in` / `_mix32`) on the same fold structure:
  key = fold(fold(root_key(seed), step), indices[0]), then one key each
  for the rows, the columns and the flips, and each image's draw a hash
  of its position in the batch. The distribution is the reference's
  (ys, xs uniform in [0, 2p], flips Bernoulli(0.5)), and the bits are
  the same on every device. `step` is the engine state's step: a host
  int, or inside a CUDA graph the device scalar the graph advances, so
  each replay draws its own step's crops.
* Normalize. The reference writes `imgs.astype(f32) / 255.0` and
  `(out - mean) / std`; the port computes exactly that, with tensor
  divisors (on CUDA torch turns a division by a Python scalar into a
  multiply by its reciprocal). Jitted on the CPU, XLA computes
  fma(x, f32(1/255), -mean) * f32(1/std) instead, which moves some
  values by an ulp: the port keeps the written division, as it does for
  the wire codec's `/ 127.0`.

Lazy (disk-backed) datasets and datasets above `max_bytes` (2 GiB) are
refused: they keep the host `Loader` path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.data.datasets import ArrayDataset
from distributed_model_parallel_tpu_torch.data.loader import Loader
from distributed_model_parallel_tpu_torch.models.layers import (
    _mix32,
    fold_in,
    root_key,
)


def _uniform_draws(key, n: int, bound: int, device):
    """n hash draws in [0, bound) from `key` (an int or an int64 device
    scalar), one per batch position."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    k = key.to(device) if torch.is_tensor(key) else key
    return torch.remainder(_mix32(idx ^ k), bound)


class DeviceDatasetCache:
    """Upload `dataset` (uint8 NHWC images) once to `device` and build the
    device-side gather + augment + normalize transform."""

    def __init__(self, dataset, device="cuda", *, augment: bool = False,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, padding: int = 4,
                 augment_seed: int = 0, max_bytes: int = 2 << 30):
        if isinstance(dataset, np.ndarray):
            images = dataset
        elif hasattr(dataset, "images"):
            images = dataset.images
        else:
            raise ValueError(
                f"device cache needs an in-memory dataset (ArrayDataset "
                f"or ndarray); got {type(dataset).__name__} — lazy "
                f"disk-backed datasets (ImageFolder trees) keep the host "
                f"Loader path")
        if images.nbytes > max_bytes:
            raise ValueError(
                f"dataset is {images.nbytes / 1e9:.1f} GB uint8 — beyond "
                f"the device-cache budget ({max_bytes / 1e9:.1f} GB on "
                f"the device). Use the host Loader path.")
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self.augment = augment
        self.padding = padding
        self.augment_seed = augment_seed
        as_tensor = (lambda a: None if a is None else torch.from_numpy(
            np.asarray(a, np.float32)).to(self.device))
        self.mean, self.std = as_tensor(mean), as_tensor(std)
        self._full = torch.tensor(255.0, device=self.device)

    @property
    def nbytes(self) -> int:
        """Bytes the cache holds on the device."""
        return self.images.numel() * self.images.element_size()

    def augment_draws(self, indices: torch.Tensor, step):
        """(ys, xs, flips) of a train batch: crop offsets in [0, 2p] and
        horizontal flips, keyed by (augment_seed, step, indices[0])."""
        key = fold_in(fold_in(root_key(self.augment_seed), step),
                      indices[0].long())
        n, dev, span = indices.shape[0], indices.device, 2 * self.padding + 1
        ys = _uniform_draws(fold_in(key, 0), n, span, dev)
        xs = _uniform_draws(fold_in(key, 1), n, span, dev)
        flips = _uniform_draws(fold_in(key, 2), n, 2, dev) == 1
        return ys, xs, flips

    def transform(self):
        """The engine's `input_transform`: indices -> the normalized f32
        batch, on the device (module docstring); its `cache` attribute is
        this cache."""
        cache, p = self.images, self.padding

        def tf(indices, *, step=None, train=False):
            idx = indices.long()
            imgs = cache[idx]
            if self.augment and train:
                b, h, w = imgs.shape[:3]
                dev = idx.device
                ys, xs, flips = self.augment_draws(idx, step)
                padded = F.pad(imgs, (0, 0, p, p, p, p))
                # One gather: image i's rows ys[i] + [0, h), columns
                # xs[i] + [0, w) of its padded source.
                rows = ys[:, None, None] + torch.arange(h, device=dev)[:, None]
                cols = xs[:, None, None] + torch.arange(w, device=dev)
                batch = torch.arange(b, device=dev)[:, None, None]
                imgs = padded[batch, rows, cols]
                imgs = torch.where(flips[:, None, None, None],
                                   imgs.flip(2), imgs)
            out = imgs.float() / self._full
            if self.mean is not None:
                out = (out - self.mean) / self.std
            return out

        tf.wants_ctx = True
        tf.cache = self
        return tf


def combined_cache(train_ds: ArrayDataset, val_ds: ArrayDataset,
                   device="cuda", *, mean: Optional[np.ndarray] = None,
                   std: Optional[np.ndarray] = None, augment: bool = True,
                   padding: int = 4, augment_seed: int = 0):
    """One cache holding the train AND val images (an engine has one
    `input_transform` for both steps; augmentation applies only under
    train=True). Returns `(transform, val_offset)`: build the val
    `IndexLoader` with `index_offset=val_offset` so that its indices
    address the val block (the cache is `transform.cache`)."""
    for which, ds in (("train", train_ds), ("val", val_ds)):
        if not hasattr(ds, "images"):
            raise ValueError(
                f"device cache needs in-memory datasets; the {which} "
                f"split is a {type(ds).__name__} (lazy disk-backed) — "
                f"use the host Loader path for it")
    cache = DeviceDatasetCache(
        np.concatenate([train_ds.images, val_ds.images]), device,
        augment=augment, mean=mean, std=std, padding=padding,
        augment_seed=augment_seed)
    return cache.transform(), len(train_ds.images)


@dataclasses.dataclass
class IndexLoader(Loader):
    """`Loader` with the pixel work removed: yields `(int32 indices,
    labels)` per batch with `Loader`'s sampling. Ragged final batches pad
    the indices with row 0 and the labels with -1 (the metrics mask the
    row; its gathered pixels are dead). `index_offset` shifts every
    index: the val loader of a `combined_cache` addresses the val
    block."""

    index_offset: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.augment or self.device_normalize or self.mean is not None:
            raise ValueError(
                "IndexLoader yields indices, not pixels: augment/mean/std/"
                "device_normalize have no effect here — configure "
                "augmentation and normalization on DeviceDatasetCache/"
                "combined_cache instead")

    def _make_batch(self, b: int, idx, use_native: bool):
        labels = self.dataset.labels[idx]  # no host-side pixel gather
        indices = np.asarray(idx, np.int32) + self.index_offset
        if len(idx) < self.batch_size:
            pad_n = self.batch_size - len(idx)
            indices = np.concatenate([indices, np.zeros((pad_n,), np.int32)])
            labels = np.concatenate(
                [labels, np.full((pad_n,), -1, labels.dtype)])
        return indices, labels


__all__ = ["DeviceDatasetCache", "IndexLoader", "combined_cache"]
