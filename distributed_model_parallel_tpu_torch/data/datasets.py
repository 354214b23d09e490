"""Datasets (numpy-only port of `data/datasets.py`).

Datasets yield NumPy arrays (NHWC uint8 images or int32 token ids,
int64 labels); placing them on the device is the engine's job.
Bit-identical to the reference: the same RandomState draws in the same
order, the same float64 temporaries, cast where the reference casts.

Types of `DatasetCollection`: 'CIFAR10' (the python-version batches
from disk, or class-structured synthetic data of CIFAR-10's shapes and
sizes when the files are absent), 'Synthetic', 'SyntheticTextures' and
'SyntheticText' (token-id classification for the transformer
classifiers). 'Imagenet', 'Place365' and 'CUB200' are refused by name:
they belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tarfile
from typing import Optional, Tuple

import numpy as np

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Dataset types of later port slices (ROADMAP.md).
LATER_TYPES = {
    "Imagenet": "the image-folder slice",
    "Place365": "the image-folder slice",
    "CUB200": "the image-folder slice",
}


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: images NHWC uint8 (or, for `kind='text'`,
    (N, T) token ids, which the Loader passes through raw), labels
    int64."""

    images: np.ndarray
    labels: np.ndarray
    num_classes: int
    kind: str = "image"  # 'image' | 'text': drives the Loader's mode

    def __len__(self) -> int:
        return len(self.labels)

    def gather(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[idx], self.labels[idx]


def synthetic(num_examples: int = 2048, image_size: int = 32,
              num_classes: int = 10, seed: int = 0) -> ArrayDataset:
    """Noisy copies of one mean image per class. The class means come
    from a fixed rng independent of `seed`, so train and val splits with
    different seeds share one task."""
    class_rng = np.random.RandomState(1234)
    class_means = class_rng.randint(0, 256, size=(num_classes, 1, 1, 3))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=(num_examples,))
    noise = rng.randint(-40, 40, size=(num_examples, image_size,
                                       image_size, 3))
    images = np.clip(class_means[labels] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(images, labels.astype(np.int64), num_classes)


def synthetic_textures(num_examples: int = 2048, image_size: int = 32,
                       num_classes: int = 10, seed: int = 0) -> ArrayDataset:
    """Procedural textures: each class is a family of two sinusoidal
    gratings with class-specific orientations, frequencies and colours;
    every sample draws fresh phases, amplitudes and pixel noise. Class
    parameters come from a fixed rng independent of `seed`."""
    class_rng = np.random.RandomState(977)
    thetas = class_rng.uniform(0, np.pi, size=(num_classes, 2))
    freqs = class_rng.uniform(2.0, 6.0, size=(num_classes, 2))
    colors = class_rng.uniform(0.3, 1.0, size=(num_classes, 2, 3))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=(num_examples,))
    yy, xx = np.meshgrid(
        np.linspace(0, 2 * np.pi, image_size),
        np.linspace(0, 2 * np.pi, image_size),
        indexing="ij",
    )
    images = np.empty((num_examples, image_size, image_size, 3), np.float32)
    # Float64 temporaries per chunk of 4096 images; numpy fills arrays in
    # draw order, so the chunked draws equal full-size ones.
    chunk = 4096
    for g in range(2):  # two gratings per class, summed
        phase = rng.uniform(0, 2 * np.pi, size=(num_examples, 1, 1))
        amp = rng.uniform(0.6, 1.4, size=(num_examples, 1, 1))
        for s in range(0, num_examples, chunk):
            sl = slice(s, min(s + chunk, num_examples))
            lab = labels[sl]
            th = thetas[lab, g][:, None, None]
            fr = freqs[lab, g][:, None, None]
            wave = amp[sl] * np.sin(
                fr * (np.cos(th) * xx[None] + np.sin(th) * yy[None])
                + phase[sl]
            )
            contrib = wave[..., None] * colors[lab, g][:, None, None, :]
            # f64 sum, cast to f32 on assignment
            images[sl] = contrib if g == 0 else images[sl] + contrib
    for s in range(0, num_examples, chunk):
        sl = slice(s, min(s + chunk, num_examples))
        images[sl] += rng.normal(0.0, 1.2, size=images[sl].shape)
    lo, hi = -3.0, 3.0
    np.clip(images, lo, hi, out=images)
    images -= lo
    images /= hi - lo
    images *= 255.0
    return ArrayDataset(images.astype(np.uint8), labels.astype(np.int64),
                        num_classes)


def synthetic_text(num_examples: int = 2048, seq_len: int = 64,
                   num_classes: int = 4, vocab_size: int = 512,
                   seed: int = 0) -> ArrayDataset:
    """Text classification: each class is its own first-order Markov
    chain over tokens [1, vocab) (0 stays the pad id: BERT's attention
    mask is `ids != 0`), so a model can classify by transition
    statistics. The per-class chains come from a fixed rng independent
    of `seed`, so train and val splits share one task."""
    v = vocab_size - 1  # usable tokens 1..vocab-1
    class_rng = np.random.RandomState(4321)
    trans = class_rng.dirichlet(
        np.full(v, 0.05), size=(num_classes, v)
    )  # (C, v, v) rows sum to 1
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=(num_examples,))
    ids = np.empty((num_examples, seq_len), np.int32)
    ids[:, 0] = rng.randint(0, v, size=num_examples)
    # One step for every sequence at a time: inverse-CDF sampling
    # against each row's class-specific transition row.
    cdf = np.cumsum(trans, axis=-1)  # (C, v, v)
    for t in range(1, seq_len):
        u = rng.rand(num_examples, 1)
        row_cdf = cdf[labels, ids[:, t - 1]]  # (N, v)
        # A float cumsum row can top out below 1.0; clip the index.
        ids[:, t] = np.minimum((u > row_cdf).sum(axis=1), v - 1)
    return ArrayDataset(ids + 1, labels.astype(np.int64), num_classes,
                        kind="text")


def _load_cifar10_batches(root: str) -> Optional[Tuple[np.ndarray, ...]]:
    """The python-version CIFAR-10 batches (cifar-10-batches-py, or its
    tar.gz) under `root`, or None. Reads the disk only."""
    d = os.path.join(root, "cifar-10-batches-py")
    tar = os.path.join(root, "cifar-10-python.tar.gz")
    if not os.path.isdir(d) and os.path.isfile(tar):
        with tarfile.open(tar) as tf:
            tf.extractall(root, filter="data")
    if not os.path.isdir(d):
        return None

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            entry = pickle.load(f, encoding="bytes")
        x = entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(entry[b"labels"], np.int64)
        return x, y

    xs, ys = zip(*(read(f"data_batch_{i}") for i in range(1, 6)))
    xt, yt = read("test_batch")
    return np.concatenate(xs), np.concatenate(ys), xt, yt


def cifar10(root: str = "./data", *, fallback_synthetic: bool = True):
    """CIFAR-10 train/val pair from disk; class-structured synthetic data
    of the same shapes and sizes when the files are absent."""
    loaded = _load_cifar10_batches(root)
    if loaded is None:
        if not fallback_synthetic:
            raise FileNotFoundError(f"CIFAR-10 not found under {root}")
        return (synthetic(50_000, 32, 10, seed=1),
                synthetic(10_000, 32, 10, seed=2))
    xtr, ytr, xte, yte = loaded
    return ArrayDataset(xtr, ytr, 10), ArrayDataset(xte, yte, 10)


class DatasetCollection:
    """String-keyed factory, the reference's shape:
    `DatasetCollection(type, path).init() -> (train, val)`. (The
    reference's compose transforms come with the image-folder slice.)"""

    def __init__(self, dataset_type: str, dataset_path: str = "./data"):
        self.dataset_type = dataset_type
        self.dataset_path = dataset_path

    def init(self):
        t = self.dataset_type
        if t == "CIFAR10":
            return cifar10(self.dataset_path)
        if t == "Synthetic":
            return (synthetic(2048, 32, 10, seed=1),
                    synthetic(512, 32, 10, seed=2))
        if t == "SyntheticText":
            return (synthetic_text(4096, 64, 4, seed=1),
                    synthetic_text(1024, 64, 4, seed=2))
        if t == "SyntheticTextures":
            return (synthetic_textures(50_000, 32, 10, seed=1),
                    synthetic_textures(10_000, 32, 10, seed=2))
        if t in LATER_TYPES:
            raise ValueError(
                f"dataset type {t!r} is not ported to the PyTorch package "
                f"yet: it belongs to {LATER_TYPES[t]} (ROADMAP.md)"
            )
        raise ValueError(f"unknown dataset type {t!r}")


__all__ = ["ArrayDataset", "CIFAR10_MEAN", "CIFAR10_STD", "DatasetCollection",
           "IMAGENET_MEAN", "IMAGENET_STD", "LATER_TYPES", "cifar10",
           "synthetic", "synthetic_text", "synthetic_textures"]
