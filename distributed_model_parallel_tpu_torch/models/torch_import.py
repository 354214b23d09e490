"""Reference torch checkpoints into MobileNetV2 and back (port of
`models/torch_import.py`): the `--finetune` bridge.

The reference's training scripts save torch `state_dict`s wrapped as
`{'net': state_dict, 'acc', 'epoch'}`, with `module.*` key prefixes from
its `nn.DataParallel` wrap. This module maps that layout into the port's
MobileNetV2 trees (`models/mobilenetv2.py`), so a reference user's
`ckpt.pth`, or any torch MobileNetV2 weights of the same layout, carries
over: `--finetune ckpt.pth` on the data-parallel CLI.

Layout mapped (the reference model's `state_dict()` keys):
    conv1/bn1                      -> stem
    layers.{i}.conv1/bn1/conv2/bn2/conv3/bn3 (+shortcut.0/.1)
                                   -> blocks.{i}(.body/.shortcut)
    conv2/bn2/linear               -> head

Conv weights need no transpose here: the port keeps torch's
(O, I/groups, kh, kw) (stored channels-last, as the port's own). Linear
weights go (out, in) -> (in, out); BN weight/bias become the scale/bias
parameters and running_mean/var the state. Unknown and missing keys fail
loudly; a classifier of another class count is left as initialized
(the reference finetunes ImageNet weights onto CIFAR's 10 classes).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from distributed_model_parallel_tpu_torch.models.mobilenetv2 import CFG


def _as_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def normalize_state_dict(obj) -> Dict[str, np.ndarray]:
    """Unwrap the reference's checkpoint: a bare state_dict, the
    `{'net': state_dict, ...}` wrapper, and `module.*`-prefixed keys;
    values become numpy arrays."""
    if isinstance(obj, dict) and "net" in obj and isinstance(obj["net"], dict):
        obj = obj["net"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _as_numpy(v)
    return out


class _Consumer:
    """Records which checkpoint keys were used, so that a schema drift
    fails loudly instead of half-loading."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.used = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"checkpoint is missing expected key {key!r}")
        self.used.add(key)
        return self.sd[key]

    def leftovers(self):
        ignorable = {k for k in self.sd if k.endswith("num_batches_tracked")}
        return sorted(set(self.sd) - self.used - ignorable)


def _put(like: torch.Tensor, value: np.ndarray, key: str) -> torch.Tensor:
    """`value` as a tensor of `like`'s dtype, device and memory format."""
    src = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))
    if tuple(src.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint key {key!r} has shape "
                         f"{tuple(src.shape)}, the model wants "
                         f"{tuple(like.shape)}")
    out = torch.empty_like(like, requires_grad=False)
    out.copy_(src)
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _bn(c: _Consumer, prefix: str, params: dict, state: dict) -> None:
    for tree, name, key in ((params, "scale", "weight"),
                            (params, "bias", "bias"),
                            (state, "mean", "running_mean"),
                            (state, "var", "running_var")):
        tree[name] = _put(tree[name], c.take(f"{prefix}.{key}"),
                          f"{prefix}.{key}")


def _conv(c: _Consumer, key: str, tree: dict) -> None:
    tree["w"] = _put(tree["w"], c.take(key), key)


def _blocks():
    """(block index, stride, in_planes, out_planes) over CFG."""
    in_planes, i = 32, 0
    for _, out_planes, num_blocks, stride in CFG:
        for s in [stride] + [1] * (num_blocks - 1):
            yield i, s, in_planes, out_planes
            in_planes = out_planes
            i += 1


def mobilenetv2_from_torch_state_dict(
    params: Any, state: Any, state_dict: Dict[str, Any], *,
    allow_head_mismatch: bool = True,
) -> Tuple[Any, Any]:
    """A reference-layout torch MobileNetV2 `state_dict` into (params,
    state) shaped like `mobilenet_v2(...).init(...)`'s (same devices and
    memory formats). Returns new trees; the inputs are not changed.
    `allow_head_mismatch=True` keeps the given classifier when the
    checkpoint's `linear` has another class count."""
    c = _Consumer(normalize_state_dict(state_dict))
    params, state = _copy_tree(params), _copy_tree(state)

    _conv(c, "conv1.weight", params["stem"]["conv1"])
    _bn(c, "bn1", params["stem"]["bn1"], state["stem"]["bn1"])
    for i, s, in_planes, out_planes in _blocks():
        src = f"layers.{i}"
        tgt_p, tgt_s = params["blocks"][str(i)], state["blocks"][str(i)]
        has_residual = s == 1
        body_p = tgt_p["body"] if has_residual else tgt_p
        body_s = tgt_s["body"] if has_residual else tgt_s
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"),
                         ("conv3", "bn3")):
            _conv(c, f"{src}.{conv}.weight", body_p[conv])
            _bn(c, f"{src}.{bn}", body_p[bn], body_s[bn])
        if has_residual and in_planes != out_planes:
            # the reference's shortcut is nn.Sequential(conv, bn): .0/.1
            _conv(c, f"{src}.shortcut.0.weight", tgt_p["shortcut"]["conv"])
            _bn(c, f"{src}.shortcut.1", tgt_p["shortcut"]["bn"],
                tgt_s["shortcut"]["bn"])
    _conv(c, "conv2.weight", params["head"]["conv2"])
    _bn(c, "bn2", params["head"]["bn2"], state["head"]["bn2"])
    lin_w, lin_b = c.take("linear.weight"), c.take("linear.bias")
    linear = params["head"]["linear"]
    if lin_w.shape[0] == linear["w"].shape[1]:
        linear["w"] = _put(linear["w"], lin_w.T, "linear.weight")
        linear["b"] = _put(linear["b"], lin_b, "linear.bias")
    elif not allow_head_mismatch:
        raise ValueError(f"checkpoint head has {lin_w.shape[0]} classes, "
                         f"model has {linear['w'].shape[1]}")
    leftovers = c.leftovers()
    if leftovers:
        raise ValueError(
            "checkpoint keys not consumed by the MobileNetV2 schema (wrong "
            f"architecture?): {leftovers[:8]}"
            + ("..." if len(leftovers) > 8 else ""))
    return params, state


def mobilenetv2_to_torch_state_dict(params: Any, state: Any, *,
                                    module_prefix: bool = True
                                    ) -> Dict[str, np.ndarray]:
    """The inverse: a MobileNetV2 (params, state) -> the reference's
    `state_dict` layout as numpy arrays (OIHW convs, `module.*` prefixes
    as `nn.DataParallel` saves them). Round-trips bit-exactly through
    `mobilenetv2_from_torch_state_dict`."""
    sd: Dict[str, np.ndarray] = {}

    def arr(t) -> np.ndarray:
        return np.ascontiguousarray(t.detach().to("cpu", torch.float32)
                                    .numpy())

    def put_bn(prefix, p, s):
        sd[f"{prefix}.weight"] = arr(p["scale"])
        sd[f"{prefix}.bias"] = arr(p["bias"])
        sd[f"{prefix}.running_mean"] = arr(s["mean"])
        sd[f"{prefix}.running_var"] = arr(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    sd["conv1.weight"] = arr(params["stem"]["conv1"]["w"])
    put_bn("bn1", params["stem"]["bn1"], state["stem"]["bn1"])
    for i, s, in_planes, out_planes in _blocks():
        dst = f"layers.{i}"
        src_p, src_s = params["blocks"][str(i)], state["blocks"][str(i)]
        has_residual = s == 1
        body_p = src_p["body"] if has_residual else src_p
        body_s = src_s["body"] if has_residual else src_s
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"),
                         ("conv3", "bn3")):
            sd[f"{dst}.{conv}.weight"] = arr(body_p[conv]["w"])
            put_bn(f"{dst}.{bn}", body_p[bn], body_s[bn])
        if has_residual and in_planes != out_planes:
            sd[f"{dst}.shortcut.0.weight"] = arr(
                src_p["shortcut"]["conv"]["w"])
            put_bn(f"{dst}.shortcut.1", src_p["shortcut"]["bn"],
                   src_s["shortcut"]["bn"])
    sd["conv2.weight"] = arr(params["head"]["conv2"]["w"])
    put_bn("bn2", params["head"]["bn2"], state["head"]["bn2"])
    sd["linear.weight"] = np.ascontiguousarray(
        arr(params["head"]["linear"]["w"]).T)
    sd["linear.bias"] = arr(params["head"]["linear"]["b"])
    if module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd


def save_reference_checkpoint(path: str, params: Any, state: Any, *,
                              acc: float = 0.0, epoch: int = 0) -> str:
    """Write the reference's checkpoint layout `{'net': module.*
    state_dict, 'acc': acc, 'epoch': epoch}` as a torch `.pth`."""
    sd = {k: torch.from_numpy(v) for k, v in
          mobilenetv2_to_torch_state_dict(params, state).items()}
    torch.save({"net": sd, "acc": acc, "epoch": epoch}, path)
    return path


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A torch `.pth`/`.pt` (tensors only, read onto the CPU) or an
    `.npz` checkpoint as a plain dict for
    `mobilenetv2_from_torch_state_dict`."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    return torch.load(path, map_location="cpu", weights_only=True)


__all__ = ["load_torch_checkpoint", "mobilenetv2_from_torch_state_dict",
           "mobilenetv2_to_torch_state_dict", "normalize_state_dict",
           "save_reference_checkpoint"]
