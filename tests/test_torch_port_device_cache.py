"""The port's device-resident dataset cache (`data/device_cache.py`,
`--device-cache`) held against the JAX package's.

* Gather and normalize without augmentation are bit-equal to the JAX
  transform run op by op (as written: `/ 255.0`, then `(x - mean) /
  std`). Jitted on the CPU, XLA computes fma(x, f32(1/255), -mean) *
  f32(1/std) instead, which moves some values by an ulp; the port keeps
  the written division (the wire codec's precedent). They are also bit-equal to the host Loader's normalized
  pixels.
* Every augmented image is a crop (possibly flipped) of its padded
  source (the JAX test `test_cache_augment_is_valid_crop_flip`, ported);
  the same (seed, step, first index) gives the same bits, another step
  other ones, and train=False bypasses augmentation.
* `IndexLoader`'s index vectors equal the JAX `IndexLoader`'s, epoch by
  epoch, per rank, including the padded last batch.
* `--device-cache --engine ddp` trains on 2 gloo ranks, its epoch
  records finite and equal on both ranks, and its first (eval) pass
  equals the host loader's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.data import device_cache as jcache
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_make_mesh
from distributed_model_parallel_tpu_torch.data.datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    ArrayDataset,
    synthetic,
)
from distributed_model_parallel_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
    IndexLoader,
    combined_cache,
)
from distributed_model_parallel_tpu_torch.data.loader import Loader
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import SGD


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])


def _ramp():
    """Every uint8 value in every channel, plus random images."""
    ramp = np.repeat(np.arange(256, dtype=np.uint8).reshape(256, 1, 1, 1),
                     3, axis=3)
    rand = np.random.RandomState(0).randint(0, 256, (16, 4, 4, 3))
    return ramp, rand.astype(np.uint8)


@pytest.mark.parametrize("normalize", [True, False])
def test_gather_normalize_bit_equal_to_jax(normalize, jmesh):
    ramp, rand = _ramp()
    stats = dict(mean=CIFAR10_MEAN, std=CIFAR10_STD) if normalize else {}
    for images, idx in ((ramp, np.arange(256)),
                        (rand, np.array([3, 0, 15, 7, 7, 9, 1, 2]))):
        idx = idx.astype(np.int32)
        want = np.asarray(jcache.DeviceDatasetCache(
            images, jmesh, augment=False, **stats).transform()(
            jnp.asarray(idx), step=jnp.int32(0), train=False))
        got = DeviceDatasetCache(images, "cpu", augment=False,
                                 **stats).transform()(
            torch.from_numpy(idx), step=0, train=False).numpy()
        np.testing.assert_array_equal(got, want)
        if normalize:  # the host Loader's pixels, too
            host = Loader(ArrayDataset(images[idx], np.zeros(len(idx),
                                                              np.int64), 1),
                          batch_size=len(idx), shuffle=False,
                          mean=CIFAR10_MEAN, std=CIFAR10_STD, prefetch=0,
                          use_native=False)
            np.testing.assert_array_equal(got, next(iter(host))[0])


def test_augment_is_valid_crop_flip():
    """Every augmented image is an exact crop (possibly flipped) of the
    padded source: brute force over every (y, x, flip)."""
    ds = synthetic(num_examples=8, num_classes=2, image_size=8, seed=3)
    p = 2
    tf = DeviceDatasetCache(ds, "cpu", augment=True, padding=p).transform()
    idx = torch.arange(8, dtype=torch.int32)
    out = tf(idx, step=7, train=True).numpy()
    padded = np.pad(ds.images, ((0, 0), (p, p), (p, p), (0, 0)))
    seen = set()
    for i in range(8):
        hits = []
        for y in range(2 * p + 1):
            for x in range(2 * p + 1):
                w = padded[i, y:y + 8, x:x + 8].astype(np.float32) / 255.0
                hits += [(y, x, f) for f, c in ((0, w), (1, w[:, ::-1]))
                         if np.array_equal(out[i], c)]
        assert hits, f"image {i} is not a crop/flip of its source"
        seen.update(hits)
    assert len(seen) > 1  # not one offset for the whole batch
    plain = tf(idx, step=7, train=False).numpy()
    np.testing.assert_array_equal(plain,
                                  ds.images.astype(np.float32) / 255.0)


def test_augment_bits_are_keyed():
    """The same (seed, step, indices[0]) gives the same bits; another step
    or another first index other ones; a device-scalar step (as a CUDA
    graph carries) the host int's."""
    ds = synthetic(num_examples=64, num_classes=2, image_size=8, seed=4)
    cache = DeviceDatasetCache(ds, "cpu", augment=True)
    idx = torch.arange(32, dtype=torch.int32)
    draws = [cache.augment_draws(idx, s) for s in (5, 5, 6)]
    draws.append(cache.augment_draws(idx, torch.tensor(5)))
    draws.append(cache.augment_draws(idx + 1, 5))
    for a, b in zip(draws[0], draws[1]):
        assert torch.equal(a, b)
    for a, b in zip(draws[0], draws[3]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(draws[0], draws[2]))
    assert any(not torch.equal(a, b) for a, b in zip(draws[0], draws[4]))
    ys, xs, flips = draws[0]
    assert 0 <= int(ys.min()) and int(ys.max()) <= 8
    assert 0 <= int(xs.min()) and int(xs.max()) <= 8
    assert flips.dtype == torch.bool and 0 < int(flips.sum()) < 32


@pytest.mark.parametrize("drop_last,offset", [(True, 0), (False, 100)])
def test_index_loader_matches_jax(drop_last, offset):
    """Per rank and epoch, the index vectors and labels equal the JAX
    IndexLoader's, the padded ragged last batch included."""
    ds = synthetic(num_examples=90, num_classes=4, image_size=8, seed=4)
    kw = dict(batch_size=16, shuffle=True, seed=9, process_count=2,
              drop_last=drop_last, index_offset=offset)
    for rank in range(2):
        port = IndexLoader(ds, process_index=rank, **kw)
        ref = jcache.IndexLoader(ds, process_index=rank, **kw)
        for epoch in range(2):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for (gi, gl), (wi, wl) in zip(got, want):
                assert gi.dtype == np.int32
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
    if not drop_last:
        assert (got[-1][1] == -1).any() and (got[-1][0] == 0).any()


def test_index_loader_refuses_pixel_knobs():
    ds = synthetic(num_examples=8, num_classes=2, image_size=8, seed=1)
    with pytest.raises(ValueError, match="yields indices, not pixels"):
        IndexLoader(ds, batch_size=4, augment=True)


def test_cache_refusals():
    ds = synthetic(num_examples=8, num_classes=2, image_size=8, seed=1)
    with pytest.raises(ValueError, match="beyond the device-cache budget"):
        DeviceDatasetCache(ds, "cpu", max_bytes=100)
    with pytest.raises(ValueError, match="in-memory dataset"):
        DeviceDatasetCache(object(), "cpu")


def test_cached_eval_equals_host_loader():
    """A DDP engine's eval metrics on the val split through the cache
    (indices, offset into the combined cache) equal the host loader's."""
    train, val = (synthetic(64, 8, 4, seed=1), synthetic(40, 8, 4, seed=2))
    tf, off = combined_cache(train, val, "cpu", mean=CIFAR10_MEAN,
                             std=CIFAR10_STD)
    assert off == 64 and tf.cache.nbytes == 104 * 8 * 8 * 3
    kw = dict(batch_size=16, shuffle=False, drop_last=False)
    eng = {name: DDPEngine(tiny_cnn(4), SGD(), mesh=Mesh(1, None),
                           device="cpu", input_transform=t)
           for name, t in (("cache", tf), ("host", None))}
    ts = eng["host"].init_state(0)
    out = {}
    for name, loader in (
            ("cache", IndexLoader(val, index_offset=off, **kw)),
            ("host", Loader(val, mean=CIFAR10_MEAN, std=CIFAR10_STD,
                            use_native=False, **kw))):
        sums = [eng[name].eval_step(ts, *eng[name].shard_batch(*b))
                for b in loader]
        out[name] = [{k: float(v) for k, v in s.items()} for s in sums]
    assert out["cache"] == out["host"]


def test_device_cache_ddp_on_two_ranks(tmp_path):
    """`--device-cache --engine ddp` on 2 gloo ranks: the epoch records
    are finite and equal on both ranks (metric sums over the world), the
    train loss falls, and rank 0 alone writes."""
    flags = ["--device", "cpu", "--model", "tinycnn", "-type", "Synthetic",
             "-b", "64", "--val-batch-size", "64", "--epochs", "2",
             "--steps-per-epoch", "8", "--engine", "ddp", "--device-cache"]
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    got = ranks.spawn(2, "cli_suite", dict(
        runs=[("data_parallel", flags, 0)], val=128,
        dirs=[[str(d) for d in dirs]]), tmp_path)
    (h0,), (h1,) = got
    assert len(h0) == 2
    for a, b in zip(h0, h1):
        for split in ("train", "val"):
            assert np.isfinite(a[split]["loss"])
            assert a[split]["loss"] == b[split]["loss"]
    assert h0[1]["train"]["loss"] < h0[0]["train"]["loss"]
    assert h0[0]["train"]["count"] == 8 * 64
    assert (dirs[0] / "checkpoint").is_dir()
    assert not (dirs[1] / "checkpoint").exists()
