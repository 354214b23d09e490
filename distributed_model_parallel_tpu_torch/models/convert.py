"""Weight bridge between the packages' parameter trees.

`from_jax_params` takes a reference pytree as numpy arrays
(`jax.tree.map(np.asarray, params)` on the JAX side; this module never
imports jax) and returns the port's tree: the same nested keys, each
leaf a float32 torch tensor with the same value. `to_jax_params` is the
inverse, for round trips.

Two families:
* the GPT (`gpt_lm`), the default: every leaf keeps its layout (linear
  weights stay (K, N));
* the image models (`models/tinycnn.py`, `mobilenetv2.py`,
  `resnet.py`), selected by passing the port's `model`: its tree gives
  the keys and shapes to check against, and the BN running stats travel
  as a second tree, `state`, beside `params`. One leaf changes layout
  here: a conv weight, the reference's (kh, kw, I/groups, O) HWIO,
  becomes torch's (O, I/groups, kh, kw), stored channels-last (and back
  in `to_jax_params`). Linear weights stay (K, N).

A tree whose keys or shapes differ from the expected layout is refused
with the path of the first difference.

Whole training states cross the same way (`train_state_to_jax`,
`train_state_from_jax`): the JAX package's canonical `TrainState` tree,
`{"params", "model_state", "opt_state": {"momentum"} or {"mu", "nu",
"count"}, "step"}`, with conv leaves (parameters and their moments) in
HWIO, floating leaves f32, the AdamW count and `step` int32 scalars.
That is the tree `training/checkpoint.py` writes, so the port's file
holds the key set, shapes and dtypes the JAX package's holds.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

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
            f"{path}: keys {sorted(got)} differ from the expected layout "
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


def _check_against(tree, spec, path: str, to_port: bool) -> None:
    """Keys as in the port's `spec` tree; each leaf's shape that of the
    spec's leaf in the layout the tree is in."""
    if isinstance(spec, Mapping):
        _check_keys(tree, tuple(spec), path)
        for k in spec:
            _check_against(tree[k], spec[k], f"{path}/{k}", to_port)
        return
    want = tuple(spec.shape)
    if to_port and len(want) == 4:
        o, i, kh, kw = want
        want = (kh, kw, i, o)
    if tuple(tree.shape) != want:
        raise ValueError(f"{path}: shape {tuple(tree.shape)} differs from "
                         f"the expected {want}")


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_port_leaf(a, device) -> torch.Tensor:
    a = np.array(a, dtype=np.float32, copy=True)
    t = torch.from_numpy(a)
    if t.dim() == 4:  # conv weight: HWIO -> OIHW, channels-last memory
        t = t.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    return t.to(device)


def _to_jax_leaf(t) -> np.ndarray:
    t = t.detach().to("cpu", torch.float32)
    if t.dim() == 4:  # conv weight: OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    return np.ascontiguousarray(t.numpy())


def from_jax_params(tree, device="cpu", *, model=None, state=None):
    """Reference tree of numpy arrays -> port tree of f32 tensors on
    `device`. GPT trees by default; an image model's tree when `model`
    (the port's `Layer`) is given, in which case `state` (the BN running
    stats) may be passed too and `(params, state)` is returned."""
    if model is None:
        if state is not None:
            raise ValueError("state= is the image models' BN stats; pass "
                             "the port's model as well")
        _check_layout(tree)
        return _map(tree, lambda a: _to_port_leaf(a, device))
    spec_params, spec_state = model.init(torch.Generator())
    _check_against(tree, spec_params, "params", to_port=True)
    params = _map(tree, lambda a: _to_port_leaf(a, device))
    if state is None:
        return params
    _check_against(state, spec_state, "state", to_port=True)
    return params, _map(state, lambda a: _to_port_leaf(a, device))


def to_jax_params(params, *, model=None, state=None):
    """Port tree -> reference layout as numpy float32 arrays (feed to the
    JAX package with `jax.tree.map(jnp.asarray, ...)`). As
    `from_jax_params`: the GPT by default, an image model (and its
    `state`, returned beside the params) when `model` is given."""
    if model is None:
        if state is not None:
            raise ValueError("state= is the image models' BN stats; pass "
                             "the port's model as well")
        _check_layout(params)
        return _map(params, _to_jax_leaf)
    spec_params, spec_state = model.init(torch.Generator())
    _check_against(params, spec_params, "params", to_port=False)
    out = _map(params, _to_jax_leaf)
    if state is None:
        return out
    _check_against(state, spec_state, "state", to_port=False)
    return out, _map(state, _to_jax_leaf)


# ------------------------------------------------------------ train states


class ShapeDtype(NamedTuple):
    """A leaf's shape and numpy dtype, without its data (a restore
    template)."""

    shape: tuple
    dtype: Any


def _canonical_leaf(t) -> np.ndarray:
    """A state leaf (tensor, or the host int step) in the JAX layout:
    floating leaves f32 (4-D ones HWIO), integer leaves int32."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, np.int32)
    if t.is_floating_point():
        return _to_jax_leaf(t)
    return t.detach().to("cpu", torch.int32).numpy()


def _spec_leaf(t) -> ShapeDtype:
    if not isinstance(t, torch.Tensor):
        return ShapeDtype((), np.dtype(np.int32))
    shape = tuple(t.shape)
    if t.dim() == 4:
        o, i, kh, kw = shape
        shape = (kh, kw, i, o)
    return ShapeDtype(shape, np.dtype(np.float32 if t.is_floating_point()
                                      else np.int32))


def _canonical(ts, leaf) -> dict:
    opt = ts.opt_state
    return {"params": _map(ts.params, leaf),
            "model_state": _map(ts.model_state, leaf),
            "opt_state": {f: _map(getattr(opt, f), leaf)
                          for f in opt._fields},
            "step": leaf(ts.step)}


def params_spec(params) -> dict:
    """A port parameter tree's shapes and dtypes in the JAX layout
    (`ShapeDtype` leaves): a restore template without the data."""
    return _map(params, _spec_leaf)


def train_state_to_jax(ts) -> dict:
    """The port's `TrainState` -> the JAX package's canonical tree, as
    numpy arrays (module docstring)."""
    return _canonical(ts, _canonical_leaf)


def train_state_spec(ts) -> dict:
    """`train_state_to_jax(ts)`'s shapes and dtypes (`ShapeDtype`
    leaves), without copying any data."""
    return _canonical(ts, _spec_leaf)


def _from_canonical(tree, like, path: str):
    if isinstance(like, Mapping):
        _check_keys(tree, tuple(like), path)
        return {k: _from_canonical(tree[k], like[k], f"{path}/{k}")
                for k in like}
    a = np.asarray(tree)
    if not isinstance(like, torch.Tensor):  # the host step
        return int(a)
    src = torch.from_numpy(np.array(a, copy=True))
    if like.dim() == 4:  # HWIO -> OIHW
        src = src.permute(3, 2, 0, 1)
    if tuple(src.shape) != tuple(like.shape):
        raise ValueError(f"{path}: shape {tuple(a.shape)} does not fit the "
                         f"port's {tuple(like.shape)}")
    out = torch.empty_like(like, requires_grad=False)  # like's layout
    out.copy_(src)
    return out


def train_state_from_jax(tree, like):
    """A canonical tree (numpy, JAX layout) -> a `TrainState` of the
    type, devices, dtypes and memory formats of `like` (the port's state,
    e.g. a fresh `engine.init_state()`); parameters require grad."""
    params = _map(_from_canonical(tree["params"], like.params, "params"),
                  lambda t: t.requires_grad_(True))
    opt = like.opt_state
    opt_state = type(opt)(*(
        _from_canonical(tree["opt_state"][f], getattr(opt, f),
                        f"opt_state/{f}") for f in opt._fields))
    return type(like)(
        params,
        _from_canonical(tree["model_state"], like.model_state,
                        "model_state"),
        opt_state,
        _from_canonical(tree["step"], like.step, "step"),
    )


__all__ = ["ShapeDtype", "from_jax_params", "params_spec", "to_jax_params",
           "train_state_from_jax", "train_state_spec", "train_state_to_jax"]
