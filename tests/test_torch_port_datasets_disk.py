"""The port's image-folder datasets (`data/datasets.py`: `image_folder`,
`LazyImageFolder`, `cub200`, the 'Imagenet' / 'Place365' / 'CUB200'
types) held against the JAX package's on trees the tests write with PIL:
three classes of odd-sized PNG and JPEG images, a stray `.DS_Store` and
a checksum file in every class directory, and a small CUB-200 layout of
metadata tables. On each tree the two packages give equal paths, labels
and class counts, and bit-equal gathered arrays, lazy and eager; the
port's Loader and the data-parallel and pipeline CLIs take the trees.
"""

import numpy as np
import pytest
from PIL import Image

from distributed_model_parallel_tpu.data import datasets as jds
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.cli import model_parallel as mp_cli
from distributed_model_parallel_tpu_torch.data import datasets as tds
from distributed_model_parallel_tpu_torch.data.loader import Loader
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

CLASSES = ("cat", "dog", "eel")


def _write_tree(root, splits=(("train", 3), ("val", 2))):
    rng = np.random.RandomState(1)
    for split, n in splits:
        for k, c in enumerate(CLASSES):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                h, w = 7 + i + k, 9 + 2 * i
                arr = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
                ext = "png" if (i + k) % 2 else "JPG"
                Image.fromarray(arr).save(d / f"{i}.{ext}")
            (d / ".DS_Store").write_bytes(b"junk")
            (d / "checksums.txt").write_text("abc")


def _write_cub(root):
    rng = np.random.RandomState(2)
    rows = []
    for i in range(1, 8):
        cls = 1 + (i % 3)
        cdir = f"{cls:03d}.Bird_{cls}"
        (root / "images" / cdir).mkdir(parents=True, exist_ok=True)
        rel = f"{cdir}/img_{i}.jpg"
        arr = rng.randint(0, 256, size=(10 + i, 12, 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / rel)
        rows.append((i, rel, cls, 1 if i % 2 else 0))
    for name, col in (("images.txt", 1), ("image_class_labels.txt", 2),
                      ("train_test_split.txt", 3)):
        with open(root / name, "w") as f:
            f.writelines(f"{r[0]} {r[col]}\n" for r in rows)


@pytest.mark.parametrize("lazy", [True, False])
def test_image_folder_matches_jax(lazy, tmp_path):
    _write_tree(tmp_path)
    got = tds.image_folder(str(tmp_path), image_size=8, lazy=lazy)
    want = jds.image_folder(str(tmp_path), image_size=8, lazy=lazy)
    for g, w in zip(got, want):
        assert g.num_classes == w.num_classes == 3
        np.testing.assert_array_equal(g.labels, w.labels)
        if lazy:
            assert isinstance(g, tds.LazyImageFolder)
            assert g.paths == w.paths
            assert not any(p.endswith((".DS_Store", ".txt"))
                           for p in g.paths)
            idx = np.array([0, len(g) - 1, 2])
            for a, b in zip(g.gather(idx), w.gather(idx)):
                np.testing.assert_array_equal(a, b)
        else:
            assert isinstance(g, tds.ArrayDataset)
            assert g.images.dtype == np.uint8
            np.testing.assert_array_equal(g.images, w.images)
    assert [len(d) for d in got] == [9, 6]


def test_cub200_matches_jax(tmp_path):
    _write_cub(tmp_path)
    got = tds.cub200(str(tmp_path), image_size=8)
    want = jds.cub200(str(tmp_path), image_size=8)
    for g, w in zip(got, want):
        assert g.num_classes == w.num_classes == 200
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.images, w.images)
    assert [len(d) for d in got] == [4, 3]
    via = tds.DatasetCollection("CUB200", str(tmp_path), image_size=8).init()
    np.testing.assert_array_equal(via[0].images, got[0].images)


def test_loader_drives_a_lazy_tree(tmp_path):
    """The Loader gathers, augments and normalizes a lazy split (decoding
    in its prefetch thread); its batches equal the JAX Loader's."""
    from distributed_model_parallel_tpu.data.loader import Loader as JLoader

    _write_tree(tmp_path)
    train, _ = tds.DatasetCollection("Imagenet", str(tmp_path),
                                     image_size=8).init()
    jtrain, _ = jds.image_folder(str(tmp_path), image_size=8)
    kw = dict(batch_size=4, shuffle=True, seed=3, augment=True,
              mean=tds.IMAGENET_MEAN, std=tds.IMAGENET_STD)
    got = list(Loader(train, use_native=False, **kw))
    want = list(JLoader(jtrain, use_native=False, **kw))
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)


def test_clis_train_on_an_image_tree(tmp_path, monkeypatch):
    """`-type Imagenet` (and Place365) reads the tree under --data on the
    data-parallel and pipeline CLIs (images resized to 224), one step
    each, with a finite loss."""
    _write_tree(tmp_path / "data", splits=(("train", 2), ("val", 1)))
    monkeypatch.chdir(tmp_path)
    out = dp_cli.main(["--device", "cpu", "--model", "tinycnn", "-type",
                       "Imagenet", "--data", "data", "-b", "4",
                       "--val-batch-size", "3", "--epochs", "1",
                       "--steps-per-epoch", "1"])
    rec = out["history"][0]
    assert rec["train"]["count"] == 4 and np.isfinite(rec["train"]["loss"])
    assert rec["val"]["count"] == 3
    out = mp_cli.main(["data", "--device", "cpu", "--model", "tinycnn",
                       "-type", "Place365", "-b", "4", "--epochs", "1",
                       "--steps-per-epoch", "1", "--world-size", "2",
                       "--microbatches", "2"])
    assert np.isfinite(out["history"][0]["train"]["loss"])


def test_device_cache_refuses_a_lazy_tree(tmp_path, monkeypatch):
    _write_tree(tmp_path / "data", splits=(("train", 2), ("val", 1)))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="lazy disk-backed"):
        dp_cli.main(["--device", "cpu", "--model", "tinycnn", "-type",
                     "Imagenet", "--data", "data", "-b", "4",
                     "--device-cache"])
