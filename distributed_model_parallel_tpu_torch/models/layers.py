"""Layer primitives of the GPT path and the image models (port of
`models/layers.py`).

The reference's `Layer(init, apply)` pairs become plain functions on
tensors over the same parameter dictionaries (`{"w", "b"}` linears
stored (K, N), `{"scale", "bias"}` norms, `{"mean", "var"}` BN state),
so the parameter tree crosses between the packages unchanged
(`models/convert.py`). The GPT calls the functions directly; the image
models compose `Layer` pairs with `named` / `sequential` / `residual`,
whose trees carry the reference's keys ('0', '1', ..., 'body',
'shortcut', 'conv1', ...).

Image layout: the loader's batches are NHWC, as in the reference. The
model turns one into an NCHW view with `permute(0, 3, 1, 2)` (channels-
last strides, no copy) and every image layer works on that view, so the
activations stay channels-last. Conv weights are stored in torch's
(O, I/groups, kh, kw) shape, in channels-last memory; `models/
convert.py` transposes the reference's HWIO at the boundary.

Initialization is torch's default, U(±1/sqrt(fan_in)) for conv and
linear weights and biases, drawn from a CPU `torch.Generator` so a seed
gives the same weights on every device; it is never used for parity
(parity carries the reference's weights across).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Context:
    """Per-call context threaded through the layers."""

    train: bool = False
    # Activation dtype. None => follow the input dtype; when set, the
    # embedding (a layer whose output dtype comes from params) casts to
    # it and everything downstream follows x.dtype.
    dtype: Optional[torch.dtype] = None
    # Projection policy (`ops/quant_matmul.QuantMatmul`) consumed by
    # `project`; None => every projection is a plain dot.
    matmul: Optional[Any] = None
    # Dropout key (the reference's `rng`): a 32-bit value, a Python int
    # or an int64 0-dim tensor on the activations' device, that the
    # engine folds from the step (`fold_in`). A tensor key is what a
    # captured step carries: its step lives on the device, so a graph
    # replay draws the bits of the step it replays. None => dropout is
    # the identity, as with the reference's rng=None.
    rng: Optional[Any] = None
    # Child indices folded into `rng` by the combinators (`child`), kept
    # on the host and folded once per dropout call.
    rng_path: tuple = ()
    # Process group over which train-mode BatchNorm statistics are
    # averaged (SyncBN; the reference's `bn_axis`). None => statistics
    # of the local batch.
    bn_group: Optional[Any] = None
    # LayerNorm of a (B, T, dim) stream one position t at a time, each
    # (B, dim) slice in a call of its own (serving's speculative verify
    # step): the card's reduction kernels pick their thread layout, and
    # so a row's summation order, by the number of rows, and this keeps
    # every row's statistics those of a (B, 1, dim) decode step.
    norm_per_position: bool = False
    # Process group of the tensor-parallel 'model' axis: `project` wraps
    # 'column' and 'row' projections in Megatron's f and g collectives
    # over it (`parallel/tensor_parallel.py`). None => no model axis.
    model_group: Optional[Any] = None
    # (start, total): the activations' axis 1 holds positions [start,
    # start + T) of `total` (the sequence-sharded residual stream of
    # Megatron-SP, `parallel/tensor_parallel.py`), so dropout draws each
    # element's bit from its index in the whole (B, total, ...) tensor:
    # the masks of the unsharded run. None => the tensor is whole.
    seq_shard: Optional[tuple] = None
    # MoE expert-exchange policy (`ops/expert_dispatch.ExpertDispatch` /
    # `LocalExpertDispatch`, or the expert-group policy of
    # `parallel/expert_parallel.py`): `models/moe.py` hands it the
    # (hidden, dispatch, combine, expert weights) of a layer in place of
    # its dense einsums. None => every expert runs here, dense.
    expert_dispatch: Optional[Any] = None

    def child(self, i: int) -> "Context":
        """Context for the i-th child of a combinator (the reference's
        `child`): sibling stochastic layers draw independent masks."""
        if self.rng is None:
            return self
        return dataclasses.replace(self, rng_path=self.rng_path + (i,))


# The reserved state key under which a layer returns a differentiable
# penalty (`models/moe.py`'s load-balance loss).
AUX_KEY = "moe_aux"


def aux_loss(state):
    """The sum of every `moe_aux` leaf of a post-forward state tree (the
    reference's `parallel/data_parallel.aux_loss`): the engines add it to
    the loss they differentiate; the metrics keep the plain cross-
    entropy. 0.0 (a no-op addend) when the model has no such layer."""
    total = 0.0
    if isinstance(state, dict):
        for key, leaf in state.items():
            if key == AUX_KEY and torch.is_tensor(leaf):
                total = total + leaf
            else:
                total = total + aux_loss(leaf)
    elif isinstance(state, (tuple, list)):
        for leaf in state:
            total = total + aux_loss(leaf)
    return total


# ---------------------------------------------------------------------------
# Dropout bits
# ---------------------------------------------------------------------------
#
# The reference draws dropout masks from jax.random keys folded from the
# step; those bits cannot be matched (parity runs use rate 0). The port's
# bits are a counter-based hash instead: each element's bit is a function
# of (key, the call's child path, its flat index) only, computed with
# int64 tensor arithmetic that is exact on every device. So a block
# recomputed under `remat`, and a step replayed from a CUDA graph, draw
# the masks of the original forward bit for bit, and the card draws the
# CPU's masks. 32-bit values; every product stays below 2**59.

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B


def _mix32(x):
    """A 32-bit integer hash (two multiply-xorshift rounds), on a Python
    int or an int64 tensor holding values in [0, 2**32)."""
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def fold_in(key, data):
    """A new key from `key` and `data` (ints, or int64 tensors on one
    device): the counterpart of `jax.random.fold_in`."""
    return _mix32(key ^ _mix32((data + 0x9E3779B9) & _M32))


def root_key(seed: int = 0) -> int:
    """The key of `seed` (the reference's `PRNGKey(seed)`)."""
    return _mix32(seed & _M32)


def _call_key(ctx: "Context"):
    h = 0
    for i in ctx.rng_path:  # host ints: no device work
        h = fold_in(h, i)
    return fold_in(ctx.rng, h)


@dataclasses.dataclass(frozen=True)
class Layer:
    """init(generator) -> (params, state) on the CPU;
    apply(params, state, x, ctx) -> (y, new_state)."""

    init: Callable[[torch.Generator], tuple]
    apply: Callable[[Any, Any, torch.Tensor, Context], tuple]
    # The stem / blocks / head anatomy (`models/staging.StageParts`) that
    # `staging.staged_model` attaches, which the stagewise backward
    # (`grad_reduction="overlapped"`) cuts into segments; None for other
    # layers. Composition and apply never read it.
    parts: Optional[Any] = None


def layernorm(params, x: torch.Tensor, eps: float = 1e-12, *,
              per_position: bool = False) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (GPT passes 1e-5).
    `per_position`: x is (B, T, dim) and each position is normalized in
    its own call (`Context.norm_per_position`)."""
    if per_position and x.dim() == 3 and x.shape[1] > 1:
        return torch.cat([layernorm(params, x[:, t:t + 1].contiguous(), eps)
                          for t in range(x.shape[1])], dim=1)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, `jax.nn.gelu(approximate=False)`."""
    return F.gelu(x, approximate="none")


def _flat_index(x: torch.Tensor, seq_shard) -> torch.Tensor:
    """Each element's flat index in the tensor x is a part of: x itself,
    or, with `seq_shard` (start, total), the (B, total, ...) tensor whose
    positions [start, start + T) x holds along axis 1."""
    if seq_shard is None:
        return torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    start, total = seq_shard
    b, t = x.shape[:2]
    rest = x[0, 0].numel()

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=x.device)

    pos = start + ar(t)
    return ((ar(b)[:, None, None] * total + pos[None, :, None]) * rest
            + ar(rest)[None, None, :]).reshape(-1)


def dropout(x: torch.Tensor, rate: float, ctx: Context) -> torch.Tensor:
    """Inverted dropout: in training, zero each element with probability
    `rate` and scale the kept ones by 1/(1 - rate). The identity in eval,
    for rate 0, and without a key. An element is kept when the hash of
    (`ctx`'s key and child path, its flat index) falls below
    (1 - rate) * 2**32: the same bits on every device, in a recompute and
    in a graph replay; they cannot match jax.random's, so parity runs
    use rate 0."""
    if not ctx.train or rate == 0.0 or ctx.rng is None:
        return x
    key = _call_key(ctx)
    idx = _flat_index(x, ctx.seq_shard)
    bits = _mix32(idx ^ (key.to(x.device) if torch.is_tensor(key) else key))
    keep = (bits < int(round((1.0 - rate) * 2.0 ** 32))).view(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _CopyToModelParallel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient all-reduced (SUM)
    over the model group backward. It enters a column-parallel
    projection, whose input is replicated and whose weight is a column
    shard: each rank's input gradient is a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModelParallel(torch.autograd.Function):
    """Megatron's g: the output all-reduced (SUM) over the model group
    forward, the identity backward. It closes a row-parallel projection,
    whose per-rank products are partial sums."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _model_parallel(group) -> bool:
    return (group is not None
            and torch.distributed.get_world_size(group) > 1)


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """f over `group`; the identity without a group of two or more."""
    return _CopyToModelParallel.apply(x, group) if _model_parallel(
        group) else x


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """g over `group`; the identity without a group of two or more."""
    return _ReduceFromModelParallel.apply(x, group) if _model_parallel(
        group) else x


def project(h, w, b, ctx: Context, *, role: Optional[str] = None,
            scope: Optional[str] = None):
    """Dense projection `h @ w + b`, or the threaded projection policy's
    `column` / `row` (`ctx.matmul`: the int8 decode policy, the
    collective-matmul rings) unless the policy opts `scope` ("attn" or
    "ffn") out with a false attribute of that name, as the reference's
    `project` reads its policy's flags. `role` is the
    reference's Megatron role: under a model group (`ctx.model_group`), a
    "column" projection (qkv, ffn-in; `w` a column shard) runs on f(h),
    and a "row" projection (attn-out, ffn-out; `w` a row shard) is
    g(h @ w) + b, the bias added once, after the all-reduce. Without one
    both are `h @ w + b`."""
    w = w.to(h.dtype)
    b = b.to(h.dtype)
    mm = ctx.matmul
    if mm is not None and getattr(mm, scope or "", True):
        return (mm.column if role == "column" else mm.row)(h, w, b)
    group = ctx.model_group
    if role == "column":
        h = copy_to_model_parallel(h, group)
    elif role == "row":
        return reduce_from_model_parallel(h @ w, group) + b
    return h @ w + b


# ---------------------------------------------------------------------------
# Conv / Linear / BatchNorm
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (2 * bound) - bound


def conv2d(in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
           padding: int = 0, groups: int = 1, bias: bool = False) -> Layer:
    """2-D convolution on the NCHW view; `groups=channels` gives the
    depthwise conv of the MobileNetV2 block. The weight is (O, I/groups,
    k, k) in channels-last memory, cast to the activation dtype per
    use."""
    wshape = (out_ch, in_ch // groups, kernel, kernel)
    bound = 1.0 / math.sqrt((in_ch // groups) * kernel * kernel)

    def init(gen):
        params = {"w": _uniform(gen, wshape, bound).contiguous(
            memory_format=torch.channels_last)}
        if bias:
            params["b"] = _uniform(gen, (out_ch,), bound)
        return params, {}

    def apply(params, state, x, ctx):
        y = F.conv2d(x, params["w"].to(x.dtype), stride=stride,
                     padding=padding, groups=groups)
        if bias:
            y = y + params["b"].to(y.dtype)[:, None, None]
        return y, state

    return Layer(init, apply)


def linear(in_features: int, out_features: int, *, bias: bool = True) -> Layer:
    """Dense layer, weight stored (K, N), torch-default init."""
    bound = 1.0 / math.sqrt(in_features)

    def init(gen):
        params = {"w": _uniform(gen, (in_features, out_features), bound)}
        if bias:
            params["b"] = _uniform(gen, (out_features,), bound)
        return params, {}

    def apply(params, state, x, ctx):
        y = x @ params["w"].to(x.dtype)
        if bias:
            y = y + params["b"].to(y.dtype)
        return y, state

    return Layer(init, apply)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) that autograd sees: the backward all-reduces the
    cotangent (SUM), as torch's own SyncBatchNorm does. The backward of
    rank r's sum is the sum over ranks of their cotangents, i.e. the
    gradient of the SUM of every rank's loss with respect to rank r's
    input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


def batchnorm2d(num_features: int, *, momentum: float = 0.1,
                eps: float = 1e-5) -> Layer:
    """BatchNorm over (N, H, W) with explicit running-stat state, the
    reference's arithmetic: in f32, var = E[x²] - E[x]² (biased, used to
    normalize), running var updated with the unbiased var n/(n-1), where
    n is the global element count under SyncBN (`ctx.bn_group`: mean and
    mean_sq averaged over the group inside the differentiated function),
    momentum 0.1, eps 1e-5, output cast back to the input dtype."""

    def init(gen):
        params = {"scale": torch.ones(num_features),
                  "bias": torch.zeros(num_features)}
        state = {"mean": torch.zeros(num_features),
                 "var": torch.ones(num_features)}
        return params, state

    def apply(params, state, x, ctx):
        c = (None, slice(None), None, None)  # broadcast over N, H, W
        if ctx.train:
            xf = x.float()
            stats = torch.stack([xf.mean(dim=(0, 2, 3)),
                                 xf.square().mean(dim=(0, 2, 3))])
            n = x.shape[0] * x.shape[2] * x.shape[3]
            if ctx.bn_group is not None:
                world = torch.distributed.get_world_size(ctx.bn_group)
                stats = _AllReduceSum.apply(stats, ctx.bn_group) / world
                # Global element count; the reference divides two
                # integer counts in f32.
                n = n * world
                bessel = float(np.float32(n) / np.float32(max(n - 1, 1)))
            else:
                bessel = n / max(n - 1, 1)
            mean, mean_sq = stats[0], stats[1]
            var = mean_sq - mean.square()
            with torch.no_grad():
                new_state = {
                    "mean": (1 - momentum) * state["mean"] + momentum * mean,
                    "var": (1 - momentum) * state["var"]
                    + momentum * (var * bessel),
                }
        else:
            xf = x.float()
            mean, var = state["mean"], state["var"]
            new_state = state
        inv = torch.rsqrt(var + eps) * params["scale"]
        y = (xf - mean[c]) * inv[c] + params["bias"][c]
        return y.to(x.dtype), new_state

    return Layer(init, apply)


# ---------------------------------------------------------------------------
# Stateless ops as layers
# ---------------------------------------------------------------------------


def _stateless(fn) -> Layer:
    return Layer(init=lambda gen: ({}, {}),
                 apply=lambda params, state, x, ctx: (fn(x), state))


def relu() -> Layer:
    return _stateless(F.relu)


def avg_pool2d(window: int, stride: Optional[int] = None) -> Layer:
    """Windowed mean, no padding (window 4 for the CIFAR heads)."""
    stride = stride or window
    return _stateless(lambda x: F.avg_pool2d(x, window, stride))


def max_pool2d(window: int, stride: Optional[int] = None,
               padding: int = 0) -> Layer:
    stride = stride or window
    return _stateless(lambda x: F.max_pool2d(x, window, stride, padding))


def global_avg_pool() -> Layer:
    return _stateless(lambda x: x.mean(dim=(2, 3)))


def flatten() -> Layer:
    """(N, C, H, W) view -> (N, H*W*C) in the reference's NHWC order."""
    return _stateless(lambda x: x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def reshape_head(pool_window: int = 4) -> Layer:
    """relu -> avgpool(window) -> flatten, the reference's `Reshape1`."""
    return sequential(relu(), avg_pool2d(pool_window), flatten())


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------


def named(pairs: Sequence[tuple]) -> Layer:
    """Layers applied in order; params/state keyed by the given names."""

    def init(gen):
        params, state = {}, {}
        for name, layer in pairs:
            params[name], state[name] = layer.init(gen)
        return params, state

    def apply(params, state, x, ctx):
        new_state = {}
        for i, (name, layer) in enumerate(pairs):
            x, new_state[name] = layer.apply(params[name], state[name], x,
                                             ctx.child(i))
        return x, new_state

    return Layer(init, apply)


def sequential(*layers: Layer) -> Layer:
    """`named` with the keys '0', '1', ..."""
    return named([(str(i), layer) for i, layer in enumerate(layers)])


def residual(body: Layer, shortcut: Optional[Layer] = None) -> Layer:
    """out = body(x) + shortcut(x); shortcut=None means identity."""

    def init(gen):
        bp, bs = body.init(gen)
        params, state = {"body": bp}, {"body": bs}
        if shortcut is not None:
            params["shortcut"], state["shortcut"] = shortcut.init(gen)
        return params, state

    def apply(params, state, x, ctx):
        y, bs = body.apply(params["body"], state["body"], x, ctx.child(0))
        new_state = {"body": bs}
        if shortcut is not None:
            sc, new_state["shortcut"] = shortcut.apply(
                params["shortcut"], state["shortcut"], x, ctx.child(1))
        else:
            sc = x
        return y + sc, new_state

    return Layer(init, apply)


def remat(layer: Layer) -> Layer:
    """Gradient rematerialization (the reference's `L.remat`,
    `jax.checkpoint`): under autograd, `torch.utils.checkpoint` keeps
    only the layer's inputs and re-runs its forward in the backward pass.
    The recompute sees the same parameter, state and input tensors and
    the same dropout key, so it draws the same masks; its outputs are
    thrown away, so the BN running statistics the layer returns are
    those of the first forward, updated once. Without autograd (eval,
    the pipeline's forward ticks) the layer runs as it is."""
    from torch.utils.checkpoint import checkpoint

    def apply(params, state, x, ctx):
        if not torch.is_grad_enabled():
            return layer.apply(params, state, x, ctx)
        return checkpoint(layer.apply, params, state, x, ctx,
                          use_reentrant=False, preserve_rng_state=False)

    return Layer(layer.init, apply)


__all__ = ["AUX_KEY", "Context", "Layer", "aux_loss", "avg_pool2d", "batchnorm2d", "conv2d",
           "copy_to_model_parallel", "dropout", "flatten", "fold_in",
           "gelu", "global_avg_pool", "layernorm", "linear", "max_pool2d",
           "named", "project", "reduce_from_model_parallel", "relu",
           "remat", "reshape_head", "residual", "root_key", "sequential"]
