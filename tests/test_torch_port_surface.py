"""The port's public import surface against the JAX package's.

Every name a JAX `__init__.py` re-exports (read from its source by AST)
resolves on the port's subpackage of the same name to the object of the
port module holding its counterpart: the module of the same name, or
`ops/flash_attention.py` for `ops/pallas_attention.py`. No name is left
out. `cache_pspecs` names the same cache dimension and mesh axis a
layout as the reference's PartitionSpec tree. Then the user-style script
of the verify notes, over the port's public imports only, takes two
MobileNetV2 steps on the CPU, and its losses equal the same steps built
from the submodules directly.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_model_parallel_tpu.serving import kv_cache as jkv
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = "distributed_model_parallel_tpu"
PORT_PKG = "distributed_model_parallel_tpu_torch"
# JAX module -> the port module holding its counterpart, where the names
# differ
RENAMED = {
    f"{JAX_PKG}.ops.pallas_attention": f"{PORT_PKG}.ops.flash_attention"}


def _inits():
    """The JAX `__init__.py` files that re-export names."""
    return [p for p in sorted((REPO / JAX_PKG).rglob("__init__.py"))
            if any(True for _ in _reexports(p))]


def _reexports(init: Path):
    """(JAX module, name) for every `from X import name` of `init`."""
    tree = ast.parse(init.read_text())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                node.module or "").startswith(JAX_PKG):
            for alias in node.names:
                yield node.module, alias.name


def _port_module(jax_module: str) -> str:
    return RENAMED.get(jax_module,
                       PORT_PKG + jax_module[len(JAX_PKG):])


def _counterpart(source: str, name: str):
    """The port's submodule `name` of package `source`, or the object
    `name` of module `source`."""
    try:
        return importlib.import_module(f"{source}.{name}")
    except ModuleNotFoundError:
        return getattr(importlib.import_module(source), name)


def _package(init: Path) -> str:
    parts = init.parent.relative_to(REPO).parts
    return ".".join(parts)


@pytest.mark.parametrize("init", _inits(), ids=lambda p: _package(p))
def test_every_reexported_name_resolves_on_the_port(init):
    port_pkg = importlib.import_module(_port_module(_package(init)))
    for jax_module, name in _reexports(init):
        want = _counterpart(_port_module(jax_module), name)
        assert getattr(port_pkg, name) is want, (init, name)
    jax_all = _module_all(init)
    if jax_all is not None:
        assert set(jax_all) <= set(port_pkg.__all__)


def _module_all(init: Path):
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


def test_the_surface_counts_every_name():
    """The eight files the port mirrors re-export ~99 names, and every
    port subpackage with a JAX `__init__.py` exists."""
    names = {(_package(i), n) for i in _inits() for _, n in _reexports(i)}
    for sub in ("", ".runtime", ".models", ".ops", ".parallel", ".serving",
                ".training", ".observability"):
        assert any(pkg == JAX_PKG + sub for pkg, _ in names), sub
    assert len([1 for pkg, _ in names if pkg.split(".")[1:2] in (
        [], ["runtime"], ["models"], ["ops"], ["parallel"], ["serving"],
        ["training"], ["observability"])]) >= 95


@pytest.mark.parametrize("layout", ["replicated", "tp", "sp"])
def test_cache_pspecs_shard_the_reference_dimensions(layout):
    from distributed_model_parallel_tpu_torch.serving import cache_pspecs

    got, want = cache_pspecs(layout), jkv.cache_pspecs(layout)
    assert set(got) == set(want)
    for leaf in want:
        assert got[leaf] == tuple(want[leaf]), leaf
    paged = jkv.paged_pspecs(layout)
    assert tuple(paged["k"]) == got["k"]


def test_the_top_level_loads_the_mesh_on_first_use():
    code = ("import sys\n"
            "import distributed_model_parallel_tpu_torch as pkg\n"
            "assert 'torch' not in sys.modules\n"
            "from distributed_model_parallel_tpu_torch import MeshSpec\n"
            "from distributed_model_parallel_tpu_torch.runtime import mesh\n"
            "assert MeshSpec is mesh.MeshSpec is pkg.MeshSpec\n"
            "try:\n"
            "    pkg.nothing\n"
            "except AttributeError:\n"
            "    pass\n"
            "else:\n"
            "    raise SystemExit('pkg.nothing resolved')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _user_script(seed_batches):
    """The verify notes' skeleton over the port's public imports."""
    from distributed_model_parallel_tpu_torch import MeshSpec, make_mesh
    from distributed_model_parallel_tpu_torch.models import mobilenet_v2
    from distributed_model_parallel_tpu_torch.parallel import (
        DataParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.training import (
        SGD,
        cosine_warmup_schedule,
    )

    mesh = make_mesh(MeshSpec(data=1))
    engine = DataParallelEngine(mobilenet_v2(10), SGD(), mesh, device="cpu")
    ts = engine.init_state(0)
    lr = cosine_warmup_schedule(0.02)
    losses = []
    for images, labels in seed_batches:
        ts, m = engine.train_step(ts, *engine.shard_batch(images, labels),
                                  lr(0))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    return losses


def _submodule_script(seed_batches):
    """The same steps from the submodules that hold each name."""
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        cosine_warmup_schedule,
    )

    engine = DataParallelEngine(mobilenet_v2(10), SGD(),
                                make_mesh(MeshSpec(data=1)), device="cpu")
    ts = engine.init_state(0)
    losses = []
    for images, labels in seed_batches:
        ts, m = engine.train_step(ts, *engine.shard_batch(images, labels),
                                  cosine_warmup_schedule(0.02)(0))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    return losses


def test_user_style_script_runs_on_the_public_imports():
    from distributed_model_parallel_tpu_torch.data.datasets import (
        CIFAR10_MEAN,
        CIFAR10_STD,
        synthetic,
    )
    from distributed_model_parallel_tpu_torch.data.loader import Loader

    loader = Loader(synthetic(16, 32, 10, seed=1), batch_size=8,
                    augment=True, mean=CIFAR10_MEAN, std=CIFAR10_STD)
    loader.set_epoch(0)
    batches = [(np.array(x), np.array(y)) for x, y in loader]
    assert len(batches) == 2
    got = _user_script(batches)
    assert got == _submodule_script(batches)
    assert all(np.isfinite(got)) and got[0] > 0
