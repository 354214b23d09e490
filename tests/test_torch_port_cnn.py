"""The port's image layers, models and weight bridge held against the
JAX package.

Inputs are numpy arrays from seeds; the reference's weights cross with
`models/convert.from_jax_params`. Activations enter both packages as
NHWC batches (the port views them as channels-last NCHW).

Tolerances:
* BatchNorm (train and eval) and the primitive layers, f32: rtol 1e-5,
  atol 1e-6 (the repo's f32 bar; sums run in another order). bf16
  input: the output is rounded to bf16 in both, rtol/atol 1e-2 (one
  bf16 ulp is 2**-8 relative).
* tinycnn, one train-mode step: logits, new BN state and every gradient
  leaf at rtol 1e-4, atol 1e-5 (reached: gradients 2.1e-6 of their
  norm).
* MobileNetV2 and ResNet-18 (`tests/test_torch_import.py`'s bar, rtol /
  atol 5e-4): train-mode logits and new BN state; eval-mode gradients of
  every leaf (reached: 1.8e-7 and 1.3e-7 of their norm). Train-mode
  gradients of a deep BN net at random init are chaotic in f32: a ReLU
  input within the rounding difference of zero takes the other branch,
  and the batch statistics spread that one element over the whole
  batch. The JAX package's own gradient moves by 0.6-1.6% of its norm
  when its input moves by 1e-6 relative (the JAX package's MobileNetV2
  engine parity uses atol 2e-3, rtol 5e-2 for the same reason,
  `tests/test_data_parallel.py`). So the train-mode gradients are held,
  as a whole, to within three times that self-movement of the
  reference (reached: MobileNetV2 at batch 4 1.38e-2 of the norm
  against the reference's 1.63e-2; ResNet-18 at batch 2 4.8e-3 against
  5.8e-3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models import layers as JL
from distributed_model_parallel_tpu.models import mobilenet_v2 as j_mobilenet_v2
from distributed_model_parallel_tpu.models import resnet18 as j_resnet18
from distributed_model_parallel_tpu.models import resnet50 as j_resnet50
from distributed_model_parallel_tpu.models import tiny_cnn as j_tiny_cnn
from distributed_model_parallel_tpu.training.metrics import (
    cross_entropy as j_cross_entropy,
)
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import mobilenetv2
from distributed_model_parallel_tpu_torch.models import tinycnn
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import _like
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_map,
)
from _torch_port_ranks import (  # noqa: F401,E402
    default_torch_threads,
    torch_port_worker,
)

resnet = importlib.import_module(

    "distributed_model_parallel_tpu_torch.models.resnet")

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-2)
TINY = dict(rtol=1e-4, atol=1e-5)
DEEP = dict(rtol=5e-4, atol=5e-4)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_trees(got, want, **tol):
    """Same keys; every leaf close. `got` and `want` are reference-layout
    numpy trees."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_g) == len(flat_w)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _norm_rel(got, want) -> float:
    d = sum(float(np.sum((np.asarray(g, np.float64) - w) ** 2))
            for g, w in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)))
    n = sum(float(np.sum(np.asarray(w, np.float64) ** 2))
            for w in jax.tree_util.tree_leaves(want))
    return (d / n) ** 0.5


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(train, dtype):
    """Output, new running stats, and the gradients of sum(y * w) with
    respect to x, scale and bias (train mode: through the batch stats)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 7, 8) * 2.0 + 3.0).astype(np.float32)
    w = rng.randn(6, 5, 7, 8).astype(np.float32)
    params = {"scale": rng.rand(8).astype(np.float32) + 0.5,
              "bias": rng.randn(8).astype(np.float32)}
    state = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.rand(8).astype(np.float32) + 0.5}
    jbn = JL.batchnorm2d(8)
    jdt = jnp.dtype(dtype)

    def jfn(p, xx):
        y, ns = jbn.apply(p, state, xx.astype(jdt), JL.Context(train=train))
        return jnp.sum(y.astype(jnp.float32) * w), (y, ns)

    (_, (jy, jns)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = _nchw(x).requires_grad_(True)
    ty, tns = L.batchnorm2d(8).apply(
        tp, {k: torch.from_numpy(v) for k, v in state.items()},
        tx.to(tdt), L.Context(train=train))
    assert ty.dtype == tdt
    (ty.float() * _nchw(w)).sum().backward()
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy, np.float32), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tns[k].numpy(), jns[k], **F32)
    np.testing.assert_allclose(_nhwc(tx.grad), jgx, **tol)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(tp[k].grad.numpy(), jgp[k],
                                   rtol=tol["rtol"], atol=tol["atol"] * 10)


# --------------------------------------------------- primitive layers


@pytest.mark.parametrize("name,jlayer,tlayer", [
    ("conv3x3", JL.conv2d(4, 6, 3, padding=1, bias=True),
     L.conv2d(4, 6, 3, padding=1, bias=True)),
    ("conv3x3_s2", JL.conv2d(4, 6, 3, stride=2, padding=1),
     L.conv2d(4, 6, 3, stride=2, padding=1)),
    ("conv1x1_s2", JL.conv2d(4, 6, 1, stride=2), L.conv2d(4, 6, 1, stride=2)),
    ("depthwise", JL.conv2d(4, 4, 3, padding=1, groups=4),
     L.conv2d(4, 4, 3, padding=1, groups=4)),
    ("depthwise_s2", JL.conv2d(4, 4, 3, stride=2, padding=1, groups=4),
     L.conv2d(4, 4, 3, stride=2, padding=1, groups=4)),
    ("stem7x7", JL.conv2d(4, 6, 7, stride=2, padding=3),
     L.conv2d(4, 6, 7, stride=2, padding=3)),
    ("avg_pool", JL.avg_pool2d(4), L.avg_pool2d(4)),
    ("max_pool", JL.max_pool2d(3, 2, padding=1), L.max_pool2d(3, 2, padding=1)),
    ("global_avg_pool", JL.global_avg_pool(), L.global_avg_pool()),
    ("flatten", JL.flatten(), L.flatten()),
    ("reshape_head", JL.reshape_head(4), L.reshape_head(4)),
    ("residual", JL.residual(JL.conv2d(4, 4, 3, padding=1),
                             JL.named([("c", JL.conv2d(4, 4, 1))])),
     L.residual(L.conv2d(4, 4, 3, padding=1),
                L.named([("c", L.conv2d(4, 4, 1))]))),
])
def test_layers_match_jax(name, jlayer, tlayer, default_torch_threads):
    """Forward and input gradient of each image layer on the same
    weights; the weight gradients for the convolutions."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    jp, js = jlayer.init(jax.random.PRNGKey(2))
    jp = _np(jp)

    def jfn(p, xx):
        y, _ = jlayer.apply(p, js, xx, JL.Context())
        return jnp.sum(y * jnp.cos(jnp.arange(y.size).reshape(y.shape))), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1),
                                             has_aux=True)(jp, x)
    tp = tree_map(lambda t: t.requires_grad_(True),
                  from_jax_params(jp, model=tlayer))
    tx = _nchw(x).requires_grad_(True)
    ty, _ = tlayer.apply(tp, tlayer.init(torch.Generator())[1], tx,
                         L.Context())
    ty_ref = ty.permute(0, 2, 3, 1) if ty.dim() == 4 else ty
    w = torch.cos(torch.arange(ty_ref.numel(), dtype=torch.float32)
                  ).reshape(ty_ref.shape)
    (ty_ref * w).sum().backward()
    np.testing.assert_allclose(ty_ref.detach().numpy(), jy, **F32)
    np.testing.assert_allclose(_nhwc(tx.grad), jgx, **F32)
    grads = _like(tp, iter(t.grad for t in tree_leaves(tp)))
    _assert_trees(to_jax_params(grads, model=tlayer), _np(jgp), **F32)


def test_linear_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 12).astype(np.float32)
    jp, _ = JL.linear(12, 7).init(jax.random.PRNGKey(0))
    jy, _ = JL.linear(12, 7).apply(jp, {}, x, JL.Context())
    tp = from_jax_params(_np(jp), model=L.linear(12, 7))
    assert tuple(tp["w"].shape) == (12, 7)  # (K, N), as in the reference
    ty, _ = L.linear(12, 7).apply(tp, {}, torch.from_numpy(x), L.Context())
    np.testing.assert_allclose(ty.numpy(), jy, **F32)


# -------------------------------------------------------------- models

MODELS = {  # name: (reference model, port model)
    "tinycnn": (j_tiny_cnn(10), tinycnn.tiny_cnn(10)),
    "mobilenetv2": (j_mobilenet_v2(10), mobilenetv2.mobilenet_v2(10)),
    "resnet18": (j_resnet18(10), resnet.resnet18(10)),
}


def _weights(tm, seed=0):
    """The port's seeded init, with running stats moved off (0, 1), as
    reference-layout numpy trees (any weights will do for parity)."""
    tp, ts = tm.init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    ts = tree_map(lambda t: t + 0.1 * torch.rand(t.shape, generator=g), ts)
    return to_jax_params(tp, model=tm, state=ts)


def _both_steps(name, batch, train, perturb=None, seed=4):
    """One forward + gradient of the mean cross-entropy in each package
    on the same weights and batch: (reference logits, state, grads;
    port's in the reference layout; the reference's grads again on an
    input moved by `perturb` relative)."""
    jm, tm = MODELS[name]
    jp, js = _weights(tm)
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=batch)

    @jax.jit
    def jstep(xx):
        def loss(p):
            logits, ns = jm.apply(p, js, xx, JL.Context(train=train))
            return j_cross_entropy(logits, y), (logits, ns)
        return jax.value_and_grad(loss, has_aux=True)(jp)

    (_, (jlogits, jns)), jg = jstep(x)
    moved = None
    if perturb:
        noise = rng.randn(*x.shape).astype(np.float32)
        moved = _np(jstep(x * (1 + perturb * noise))[1])
    tp, ts = from_jax_params(_np(jp), model=tm, state=_np(js))
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    logits, tns = tm.apply(tp, ts, torch.from_numpy(x),
                           L.Context(train=train))
    g = torch.autograd.grad(cross_entropy(logits, torch.from_numpy(y)),
                            list(tree_leaves(tp)))
    tg, tns = to_jax_params(_like(tp, iter(g)), model=tm, state=tns)
    return ((np.asarray(jlogits), _np(jns), _np(jg)),
            (logits.detach().numpy(), tns, tg), moved)


def test_tinycnn_train_step_matches_jax():
    (jl, jns, jg), (tl, tns, tg), _ = _both_steps("tinycnn", 8, True, seed=0)
    np.testing.assert_allclose(tl, jl, **TINY)
    _assert_trees(tns, jns, **TINY)
    _assert_trees(tg, jg, **TINY)
    assert _norm_rel(tg, jg) < 1e-5


@pytest.mark.parametrize("name,batch", [("mobilenetv2", 4), ("resnet18", 2)])
def test_deep_model_train_step_matches_jax(name, batch):
    """Train mode: logits and new BN state elementwise; the gradient
    within three times the reference's own movement under a 1e-6
    relative input perturbation (module docstring)."""
    (jl, jns, jg), (tl, tns, tg), moved = _both_steps(name, batch, True,
                                                      perturb=1e-6)
    np.testing.assert_allclose(tl, jl, **DEEP)
    _assert_trees(tns, jns, **DEEP)
    own = _norm_rel(moved, jg)
    assert _norm_rel(tg, jg) <= max(3 * own, 1e-5), (_norm_rel(tg, jg), own)


@pytest.mark.parametrize("name", ["mobilenetv2", "resnet18"])
def test_deep_model_eval_gradients_match_jax(name):
    """Eval mode (running stats): every gradient leaf elementwise."""
    (jl, _, jg), (tl, _, tg), _ = _both_steps(name, 4, False)
    np.testing.assert_allclose(tl, jl, **DEEP)
    _assert_trees(tg, jg, **DEEP)


def test_mobilenetv2_widths_and_nobn_variant():
    """The published CFG widths: the same tree and about 2.2 M
    parameters; the no-BN variant keeps the shortcut BN."""
    jp = jax.eval_shape(j_mobilenet_v2(10).init, jax.random.PRNGKey(0))[0]
    tp, _ = mobilenetv2.mobilenet_v2(10).init(torch.Generator())
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(jp))
    assert 2.2e6 < n < 2.3e6
    nobn, _ = mobilenetv2.mobilenet_v2_nobn(10).init(torch.Generator())
    assert "bn1" not in nobn["blocks"]["1"]["body"]
    assert "bn" in nobn["blocks"]["1"]["shortcut"]
    assert "bn1" not in nobn["stem"] and "bn2" not in nobn["head"]


def test_resnet50_tree_crosses_from_jax():
    jp, js = jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(j_resnet50(1000).init, jax.random.PRNGKey(0)))
    tp, ts = from_jax_params(jp, model=resnet.resnet50(1000), state=js)
    assert sum(t.numel() for t in tree_leaves(tp)) == sum(
        a.size for a in jax.tree_util.tree_leaves(jp))
    assert tp["stem"]["conv1"]["w"].shape == (64, 3, 7, 7)


def test_port_init_is_torch_default_and_seeded():
    """U(±1/sqrt(fan_in)) for conv and linear weights, BN at (1, 0) and
    running stats at (0, 1); the same seed gives the same tree."""
    model = tinycnn.tiny_cnn(10)
    p, s = model.init(torch.Generator().manual_seed(5))
    q, _ = model.init(torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p), tree_leaves(q)))
    w = p["blocks"]["0"]["0"]["w"]
    assert w.shape == (16, 16, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert float(w.abs().max()) <= 1 / (16 * 9) ** 0.5
    assert float(w.abs().max()) > 0.9 / (16 * 9) ** 0.5
    assert torch.equal(p["stem"]["1"]["scale"], torch.ones(16))
    assert torch.equal(s["stem"]["1"]["var"], torch.ones(16))


# ------------------------------------------------------------- convert


def test_convert_round_trip_and_layouts():
    model = mobilenetv2.mobilenet_v2(10)
    jp, js = _weights(model, seed=1)
    tp, ts = from_jax_params(jp, model=model, state=js)
    w = tp["blocks"]["3"]["conv2"]["w"]  # depthwise 3x3, stride 2
    assert w.shape == (144, 1, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        w.numpy(), np.transpose(jp["blocks"]["3"]["conv2"]["w"],
                                (3, 2, 0, 1)))
    back_p, back_s = to_jax_params(tp, model=model, state=ts)
    jax.tree.map(np.testing.assert_array_equal, back_p, jp)
    jax.tree.map(np.testing.assert_array_equal, back_s, js)
    assert to_jax_params(tp, model=model)["head"]["linear"]["w"].shape == (
        1280, 10)


def test_convert_refuses_a_wrong_tree():
    model = tinycnn.tiny_cnn(10)
    jp, js = _weights(model)
    with pytest.raises(ValueError, match="params/blocks"):
        from_jax_params({**jp, "blocks": {"0": jp["blocks"]["0"]}},
                        model=model)
    bad = jax.tree.map(lambda a: a, jp)
    bad["head"]["1"]["w"] = np.zeros((16, 11), np.float32)
    with pytest.raises(ValueError, match="params/head/1/w: shape"):
        from_jax_params(bad, model=model)
    with pytest.raises(ValueError, match="state/stem/1"):
        from_jax_params(jp, model=model,
                        state={**js, "stem": {**js["stem"], "1": {}}})
    with pytest.raises(ValueError, match="params"):
        from_jax_params(jp)  # a CNN tree is not the GPT layout
    with pytest.raises(ValueError, match="model"):
        from_jax_params(jp, state=js)
