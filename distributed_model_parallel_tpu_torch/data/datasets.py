"""Datasets (numpy-only port of `data/datasets.py`).

Datasets yield NumPy arrays (NHWC uint8 images or int32 token ids,
int64 labels); placing them on the device is the engine's job.
Bit-identical to the reference: the same RandomState draws in the same
order, the same float64 temporaries, cast where the reference casts.

Types of `DatasetCollection`: 'CIFAR10' (the python-version batches
from disk, or class-structured synthetic data of CIFAR-10's shapes and
sizes when the files are absent), 'Synthetic', 'SyntheticTextures',
'SyntheticText' (token-id classification for the transformer
classifiers), 'Imagenet' and 'Place365' (ImageFolder trees,
`image_folder`: `LazyImageFolder` splits that decode per batch) and
'CUB200' (its metadata tables, `cub200`). The image trees decode with
PIL, imported where a file is opened, never when this module is.
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


@dataclasses.dataclass
class LazyImageFolder:
    """A disk-backed ImageFolder split: paths and labels, decoding only the
    rows a batch asks for (`gather`), each image converted to RGB and
    resized to `image_size` square, so the Loader's prefetch thread
    overlaps the decode with the device step."""

    paths: list
    labels: np.ndarray
    num_classes: int
    image_size: int = 224

    def __len__(self) -> int:
        return len(self.labels)

    def gather(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image  # lazy: only image trees need PIL

        images = np.empty(
            (len(idx), self.image_size, self.image_size, 3), np.uint8)
        for row, i in enumerate(np.asarray(idx)):
            with Image.open(self.paths[i]) as im:
                images[row] = np.asarray(
                    im.convert("RGB").resize(
                        (self.image_size, self.image_size)), np.uint8)
        return images, self.labels[idx]


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


# The extensions an ImageFolder tree's files may have (torchvision's
# ImageFolder filter): a stray .DS_Store or checksum file is skipped.
_IMG_EXTS = {
    ".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp", ".ppm", ".pgm",
    ".tif", ".tiff",
}


def image_folder(root: str, split_dirs=("train", "val"),
                 image_size: int = 224, *, lazy: bool = True):
    """An ImageFolder tree ('Imagenet' / 'Place365'): one split per
    directory of `split_dirs` under `root`, one class per sorted
    subdirectory, its files in sorted order. `lazy=True` gives
    `LazyImageFolder` splits that decode per batch; `lazy=False` decodes
    every image into an in-memory `ArrayDataset`."""
    out = []
    for split in split_dirs:
        base = os.path.join(root, split)
        classes = sorted(d for d in os.listdir(base)
                         if os.path.isdir(os.path.join(base, d)))
        paths, labels = [], []
        for label, c in enumerate(classes):
            cdir = os.path.join(base, c)
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() not in _IMG_EXTS:
                    continue
                paths.append(os.path.join(cdir, fname))
                labels.append(label)
        ds = LazyImageFolder(paths, np.asarray(labels, np.int64),
                             len(classes), image_size)
        if not lazy:
            images, lab = ds.gather(np.arange(len(ds)))
            ds = ArrayDataset(images, lab, ds.num_classes)
        out.append(ds)
    return tuple(out)


def cub200(root: str, image_size: int = 224):
    """CUB-200-2011 from its `images.txt`, `train_test_split.txt` and
    `image_class_labels.txt` tables (the join the reference does with
    pandas, without pandas): (train, val) `ArrayDataset`s of 200
    classes, labels 0-based, images decoded and resized."""
    from PIL import Image  # lazy: only image trees need PIL

    def read_table(name):
        with open(os.path.join(root, name)) as f:
            return [line.split() for line in f.read().splitlines() if line]

    paths = {int(i): p for i, p in read_table("images.txt")}
    is_train = {int(i): v == "1"
                for i, v in read_table("train_test_split.txt")}
    label = {int(i): int(c) - 1
             for i, c in read_table("image_class_labels.txt")}
    splits = {True: ([], []), False: ([], [])}
    for i, rel in sorted(paths.items()):
        with Image.open(os.path.join(root, "images", rel)) as im:
            arr = np.asarray(im.convert("RGB").resize(
                (image_size, image_size)), np.uint8)
        imgs, labs = splits[is_train[i]]
        imgs.append(arr)
        labs.append(label[i])
    return tuple(ArrayDataset(np.stack(splits[k][0]),
                              np.asarray(splits[k][1], np.int64), 200)
                 for k in (True, False))


class DatasetCollection:
    """String-keyed factory, the reference's shape:
    `DatasetCollection(type, path).init() -> (train, val)`; `image_size`
    is the side the image trees are resized to. (The reference's compose
    transforms are not ported: the Loader's own augment and normalize
    run.)"""

    def __init__(self, dataset_type: str, dataset_path: str = "./data",
                 image_size: int = 224):
        self.dataset_type = dataset_type
        self.dataset_path = dataset_path
        self.image_size = image_size

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
        if t in ("Imagenet", "Place365"):
            return image_folder(self.dataset_path,
                                image_size=self.image_size)
        if t == "CUB200":
            return cub200(self.dataset_path, image_size=self.image_size)
        raise ValueError(f"unknown dataset type {t!r}")


__all__ = ["ArrayDataset", "CIFAR10_MEAN", "CIFAR10_STD", "DatasetCollection",
           "IMAGENET_MEAN", "IMAGENET_STD", "LazyImageFolder", "cifar10",
           "cub200", "image_folder", "synthetic", "synthetic_text",
           "synthetic_textures"]
