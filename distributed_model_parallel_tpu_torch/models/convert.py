"""Weight bridge between the packages' GPT parameter trees.

`from_jax_params` takes the reference's `gpt_lm` pytree as numpy
arrays (`jax.tree.map(np.asarray, params)` on the JAX side; this module
never imports jax) and returns the port's tree: the same nested keys,
each leaf a float32 torch tensor with the same value and layout (linear
weights stay (K, N)). `to_jax_params` is the inverse, for round trips.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_LINEAR = ("w", "b")
_NORM = ("scale", "bias")
_BLOCK = {
    "attn": {"qkv": _LINEAR, "out": _LINEAR},
    "ln1": _NORM,
    "ffn": {"in": _LINEAR, "out": _LINEAR},
    "ln2": _NORM,
}


def _check_keys(tree, spec, path: str) -> None:
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: expected a dict, got {type(tree)}")
    want = set(spec)
    got = set(tree)
    if got != want:
        raise ValueError(
            f"{path}: keys {sorted(got)} differ from the gpt_lm layout "
            f"{sorted(want)}"
        )
    if isinstance(spec, Mapping):
        for k, sub in spec.items():
            _check_keys(tree[k], sub, f"{path}/{k}")


def _check_layout(tree) -> None:
    _check_keys(tree, ("stem", "blocks", "head"), "params")
    _check_keys(tree["stem"], ("word", "position"), "params/stem")
    _check_keys(tree["head"], ("w",), "params/head")
    blocks = tree["blocks"]
    n = len(blocks)
    _check_keys(blocks, tuple(str(i) for i in range(n)), "params/blocks")
    for i in range(n):
        _check_keys(blocks[str(i)], _BLOCK, f"params/blocks/{i}")


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(tree, device="cpu") -> dict:
    """Reference `gpt_lm` tree of numpy arrays -> port tree of f32
    tensors on `device`, values unchanged."""
    _check_layout(tree)
    return _map(
        tree,
        lambda a: torch.from_numpy(
            np.array(a, dtype=np.float32, copy=True)
        ).to(device),
    )


def to_jax_params(params) -> dict:
    """Port tree -> reference layout as numpy float32 arrays (feed to
    the JAX package with `jax.tree.map(jnp.asarray, ...)`)."""
    _check_layout(params)
    return _map(
        params, lambda t: t.detach().to("cpu", torch.float32).numpy()
    )


__all__ = ["from_jax_params", "to_jax_params"]
