"""The port's image datasets, Loader and native augment held against
the JAX package: every array bit-identical (`np.testing.
assert_array_equal`), for both Loader backends (native C++ and NumPy),
1 and 4 native workers, a world of 1 and of 4 ranks, the prefetch
thread and the synchronous path, and the ragged, padded validation
batch. The device-side normalizer equals the host one bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import native as jnative
from distributed_model_parallel_tpu.data import datasets as jds
from distributed_model_parallel_tpu.data import loader as jloader
from distributed_model_parallel_tpu_torch import native
from distributed_model_parallel_tpu_torch.data import datasets as tds
from distributed_model_parallel_tpu_torch.data import loader as tloader


# ------------------------------------------------------------ datasets


def _same_dataset(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.images.dtype == b.images.dtype == np.uint8
    assert a.labels.dtype == b.labels.dtype == np.int64
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("n,size,seed", [(300, 32, 1), (37, 16, 2)])
def test_synthetic_bit_identical(n, size, seed):
    _same_dataset(tds.synthetic(n, size, 10, seed=seed),
                  jds.synthetic(n, size, 10, seed=seed))


def test_synthetic_textures_bit_identical_across_chunks():
    """4,500 images: two chunks of the float64 temporaries (4,096)."""
    _same_dataset(tds.synthetic_textures(4500, 32, 10, seed=1),
                  jds.synthetic_textures(4500, 32, 10, seed=1))


def test_constants_equal():
    for name in ("CIFAR10_MEAN", "CIFAR10_STD", "IMAGENET_MEAN",
                 "IMAGENET_STD"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name))
        assert getattr(tds, name).dtype == np.float32


def test_cifar10_reads_the_python_batches(tmp_path):
    import pickle

    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {b"data": rng.randint(0, 256, (4, 3072)).astype(np.uint8),
                 b"labels": list(rng.randint(0, 10, 4))}
        (d / name).write_bytes(pickle.dumps(entry))
    for got, want in zip(tds.cifar10(str(tmp_path)),
                         jds.cifar10(str(tmp_path))):
        _same_dataset(got, want)
    with pytest.raises(FileNotFoundError):
        tds.cifar10(str(tmp_path / "absent"), fallback_synthetic=False)


def test_collection_types(monkeypatch):
    """Synthetic equals the reference's; CIFAR10 without files and
    SyntheticTextures make the reference's sizes and seeds; the image-
    folder types read the disk."""
    for got, want in zip(tds.DatasetCollection("Synthetic").init(),
                         jds.DatasetCollection("Synthetic").init()):
        _same_dataset(got, want)
    calls = []
    for fn in ("synthetic", "synthetic_textures"):
        monkeypatch.setattr(tds, fn, lambda *a, _fn=fn, **k: calls.append(
            (_fn, a, k)))
    tds.DatasetCollection("CIFAR10", "/nonexistent").init()
    tds.DatasetCollection("SyntheticTextures").init()
    assert calls == [
        ("synthetic", (50_000, 32, 10), {"seed": 1}),
        ("synthetic", (10_000, 32, 10), {"seed": 2}),
        ("synthetic_textures", (50_000, 32, 10), {"seed": 1}),
        ("synthetic_textures", (10_000, 32, 10), {"seed": 2}),
    ]
    # The image-folder types, refused before their slice was ported, now
    # read their trees under the path (tests/test_torch_port_datasets_disk.py).
    for t, later in (("Imagenet", "image-folder"), ("CUB200", "image-folder"),
                     ("Place365", "image-folder")):
        with pytest.raises(FileNotFoundError, match="/nonexistent"):
            tds.DatasetCollection(t, "/nonexistent").init()
    # SyntheticText, refused before the transformer-classifier slice, is
    # the reference's pair of splits.
    for got, want in zip(tds.DatasetCollection("SyntheticText").init(),
                         jds.DatasetCollection("SyntheticText").init()):
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert (got.num_classes, got.kind) == (want.num_classes, "text")
    with pytest.raises(ValueError, match="unknown dataset type"):
        tds.DatasetCollection("MNIST").init()


# -------------------------------------------------------------- Loader

DS = jds.synthetic(300, 32, 10, seed=3)
PORT_DS = tds.ArrayDataset(DS.images, DS.labels, DS.num_classes)
NORM = dict(mean=tds.CIFAR10_MEAN, std=tds.CIFAR10_STD)


def _batches(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.extend(loader)
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (x, y), (u, v) in zip(got, want):
        assert x.dtype == u.dtype and y.dtype == v.dtype
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("workers,prefetch", [(1, 2), (4, 0)])
@pytest.mark.parametrize("world", [1, 4])
def test_train_loader_bit_identical(use_native, workers, prefetch, world):
    """Augmented, normalized train batches of every rank, two epochs."""
    for rank in range(world):
        kw = dict(batch_size=16, shuffle=True, augment=True, seed=5,
                  process_index=rank, process_count=world, workers=workers,
                  prefetch=prefetch, use_native=use_native, **NORM)
        t = tloader.Loader(PORT_DS, **kw)
        j = jloader.Loader(DS, **kw)
        assert len(t) == len(j)
        _same_batches(_batches(t), _batches(j))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("world", [1, 4])
def test_val_loader_pads_the_ragged_batch(use_native, world):
    """drop_last=False: the last batch is padded with label -1 rows."""
    for rank in range(world):
        kw = dict(batch_size=32, shuffle=False, augment=False,
                  drop_last=False, process_index=rank, process_count=world,
                  use_native=use_native, **NORM)
        got = _batches(tloader.Loader(PORT_DS, **kw), epochs=(0,))
        _same_batches(got, _batches(jloader.Loader(DS, **kw), epochs=(0,)))
        per_rank = -(-300 // world)
        pad = -per_rank % 32
        last = got[-1][1]
        assert (last == -1).sum() == pad and (last[:32 - pad] >= 0).all()


def test_device_normalize_batches_are_uint8_and_identical():
    kw = dict(batch_size=16, augment=True, seed=2, device_normalize=True,
              **NORM)
    got = _batches(tloader.Loader(PORT_DS, **kw))
    _same_batches(got, _batches(jloader.Loader(DS, **kw)))
    assert got[0][0].dtype == np.uint8


def test_device_normalizer_equals_host_normalize():
    images = DS.images[:40]
    want = tloader.normalize(images, *NORM.values())
    got = tloader.device_normalizer(*NORM.values())(torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, jloader.normalize(images, *NORM.values()))


def test_loader_stops_its_producer_when_abandoned():
    before = threading.active_count()
    loader = tloader.Loader(PORT_DS, batch_size=8, augment=True, prefetch=2,
                            **NORM)
    it = iter(loader)
    next(it)
    next(it)
    it.close()  # what an early `break` in the training loop does
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_loader_refuses_bad_settings():
    with pytest.raises(ValueError, match="batch_size"):
        tloader.Loader(PORT_DS, batch_size=0)
    with pytest.raises(ValueError, match="device_normalize"):
        tloader.Loader(PORT_DS, batch_size=4, use_native=True,
                       device_normalize=True, **NORM)
    with pytest.raises(ValueError, match="mean/std"):
        tloader.Loader(PORT_DS, batch_size=4, use_native=True)


# -------------------------------------------------------------- native


def test_native_builds_into_the_port_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.parent.name == "build"
    assert path.parent.parent.name == "distributed_model_parallel_tpu_torch"


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_native_augment_equals_numpy_and_reference(workers):
    rng = np.random.RandomState(workers)
    images = DS.images[:21]
    ys, xs, flips = tloader._draw_augment(rng, len(images), 4)
    got = native.augment_normalize(images, ys, xs, flips, 4,
                                   *NORM.values(), workers=workers)
    want = tloader.normalize(tloader._crop_flip_numpy(images, ys, xs, flips,
                                                      4), *NORM.values())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.augment_normalize(
        images, ys, xs, flips, 4, *NORM.values(), workers=workers))
    np.testing.assert_array_equal(
        native.normalize(images, *NORM.values(), workers=workers),
        tloader.normalize(images, *NORM.values()))


def test_native_refuses_bad_inputs():
    with pytest.raises(ValueError, match="uint8"):
        native.augment_normalize(DS.images[:2].astype(np.float32),
                                 np.zeros(2), np.zeros(2), np.zeros(2), 4,
                                 *NORM.values())
    with pytest.raises(ValueError, match="per image"):
        native.augment_normalize(DS.images[:2], np.zeros(3), np.zeros(2),
                                 np.zeros(2), 4, *NORM.values())
    with pytest.raises(ValueError, match="per channel"):
        native.normalize(DS.images[:2], np.zeros(2), np.ones(3))
