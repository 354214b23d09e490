"""The PyTorch port's CUDA kernels on the card, against their plain
versions, and the data-parallel step on the card against the CPU. Every
test marked `cuda` needs a CUDA GPU and skips without one; the native
augment's test runs wherever g++ is. The file imports neither jax nor
the JAX package, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch import native
from distributed_model_parallel_tpu_torch.data import loader as dl
from distributed_model_parallel_tpu_torch.data.datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.runtime.dist import (
    initialize_backend,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import (
    SGD,
    tree_leaves,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (8, 768, 2304), (8, 768, 768), (8, 768, 3072), (8, 3072, 768),
    (3, 768, 768), (256, 768, 3072), (1, 4, 1), (9, 36, 33),
    (1, 768, 768),     # M = 1
    (8, 776, 40),      # K % 16 != 0: 4-byte words, and N % 16 != 0
    (8, 3072, 37),     # N that no 16-column tile divides
    (5, 20, 17),       # K shorter than the 8-way K split: empty ranks
    (8, 6144, 64),     # PR 1's largest K
    (2, 16384, 16),    # the kernel's largest K (dmp_int8_matmul_max_k)
])
def test_int8_kernel_matches_plain(cuda, m, k, n):
    """Identical activation codes, scales and outputs (integer sums are
    exact in any order, so the K split changes no bit), one launch
    counted per call."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda)
    w[:, 0] = 0.0  # zero column -> exact zeros
    wq_t, ws = qm.prepare_weight(w)
    before = qm.int8_matmul.launches
    y, q, s = qm.int8_matmul(x, wq_t, ws, return_codes=True)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 1
    rq, rs = qm.quantize_rows(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(y, qm.int8_matmul_plain(x, wq_t, ws))
    assert bool((y[:, 0] == 0).all())


@pytest.mark.cuda
def test_int8_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn((8, 30), device=cuda)  # K not a multiple of 4
    wq_t, ws = qm.prepare_weight(torch.randn((30, 16), device=cuda))
    with pytest.raises(ValueError, match="multiple of 4"):
        qm.int8_matmul(x, wq_t, ws)
    with pytest.raises(ValueError, match="different devices"):
        qm.int8_matmul(x.cpu(), wq_t, ws)


# ------------------------------------------------ flash attention K1-K3

from distributed_model_parallel_tpu_torch.ops import flash_attention as fa  # noqa: E402

# Kernel vs plain version on the card. f32: both sum f32 products, in
# another order, over up to T terms: rtol 1e-4, atol 2e-5. bf16: out,
# dq, dk and dv are rounded to bf16 (one bf16 ulp is 2**-8 relative),
# and p or dS values an f32 ulp apart can round to neighbouring bf16
# values before their products: rtol/atol 2e-2.
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
FLASH_CASES = [  # (B, T, H, Dh, causal, mask kind)
    (2, 128, 3, 64, True, "all"),     # the path's case, cut down
    (2, 40, 2, 64, True, "random"),   # ragged tile: 40 % 64 != 0
    (2, 64, 2, 32, False, "row"),     # batch row 1 has no valid key
    (1, 96, 2, 128, True, None),
    (1, 72, 2, 16, False, "random"),
    (1, 200, 2, 128, True, "all"),    # Dh 128, ragged causal T
    (2, 256, 2, 64, True, "tile"),    # keys 64-127 all masked
    (2, 80, 2, 64, True, "all"),      # key tile 64-127 past the last full
]                                     # q tile (rows 0-63)


def _flash_inputs(cuda, case, dtype):
    b, t, h, dh, causal, kind = case
    g = torch.Generator(device=cuda).manual_seed(t * 31 + dh)
    q, k, v, do = (torch.randn((b, t, h, dh), generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    mask = None
    if kind is not None:
        mask = torch.ones((b, t), dtype=torch.bool, device=cuda)
        if kind == "random":
            mask = torch.rand((b, t), generator=g, device=cuda) > 0.2
            mask[:, 0] = True
        elif kind == "row":
            mask[1] = False
        elif kind == "tile":  # every key of one 64-key tile invalid
            mask[:, 64:128] = False
    return q, k, v, do, mask, causal, 1.0 / dh ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, case, dtype):
    q, k, v, do, mask, causal, scale = _flash_inputs(cuda, case, dtype)
    kw = dict(scale=scale, causal=causal)
    tol = FLASH_TOL[dtype]
    n0 = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, mask, need_lse=True, **kw)
    out_nolse, none = fa.flash_fwd(q, k, v, mask, **kw)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, mask, need_lse=True, **kw)
    delta = fa.flash_delta(do, ref_out)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, mask, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, mask, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (n0[0] + 2, n0[1] + 1, n0[2] + 1)
    assert none is None and torch.equal(out, out_nolse)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, mask, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            mask, **kw)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(got, want, **tol)
    if case[5] == "row":  # no valid key: out 0, LSE +inf, zero grads
        assert bool((out[1] == 0).all()) and bool(torch.isinf(lse[1]).all())
        assert bool((dq[1] == 0).all())
        assert bool((dk[1] == 0).all()) and bool((dv[1] == 0).all())


def _kernel_vs_plain(q, k, v, do, mask, causal, scale, tiles):
    """Each kernel at its given tile against its plain version."""
    kw = dict(scale=scale, causal=causal)
    tol = FLASH_TOL[q.dtype]
    out, lse = fa.flash_fwd(q, k, v, mask, need_lse=True,
                            tile=tiles["flash_fwd"], **kw)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, mask, need_lse=True, **kw)
    delta = fa.flash_delta(do, ref_out)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, mask,
                         tile=tiles["flash_bwd_dq"], **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, mask,
                              tile=tiles["flash_bwd_dkv"], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, mask, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            mask, **kw)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(got, want, **tol)


_BUILT_TILES = [(name, dh, tile) for name in sorted(fa.TILES)
                for dh in fa.HEAD_DIMS for tile in fa.TILES[name][dh]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,dh,tile", _BUILT_TILES)
def test_every_built_tile_matches_plain(cuda, name, dh, tile, dtype):
    """Every (Dh, tile) of TILES, causal with a random key mask and a
    length (136) that no tile divides; the other kernels at their
    defaults."""
    q, k, v, do, mask, _, scale = _flash_inputs(
        cuda, (2, 136, 2, dh, True, "random"), dtype)
    tiles = {n: fa.DEFAULT_TILE[n][dtype][dh] for n in fa.TILES}
    tiles[name] = tile
    _kernel_vs_plain(q, k, v, do, mask, True, scale, tiles)


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card(cuda):
    """FlashAttention through autograd on strided q/k/v views (the
    model's split of a fused qkv projection), against autograd of the
    dense reference."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((2, 64, 3 * 4 * 32), generator=g, device=cuda)
    qkv.requires_grad_(True)
    q, k, v = (x.reshape(2, 64, 4, 32) for x in qkv.split(128, dim=-1))
    out = fa.flash_attention(q, k, v, causal=True)
    out.square().sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None
    from distributed_model_parallel_tpu_torch.ops.attention import (
        dot_product_attention,
    )
    ref = dot_product_attention(q, k, v, causal=True, scale=32 ** -0.5)
    ref.square().sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(got, qkv.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_attention_autograd_bf16_strided_split(cuda):
    """bf16 q/k/v as views of a fused qkv projection through autograd:
    the gradient of qkv against the plain versions' dq, dk, dv."""
    g = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn((2, 128, 3 * 4 * 32), generator=g, device=cuda)
    qkv = qkv.to(torch.bfloat16).requires_grad_(True)
    q, k, v = (x.reshape(2, 128, 4, 32) for x in qkv.split(128, dim=-1))
    out = fa.flash_attention(q, k, v, causal=True)
    do = torch.randn(out.shape, generator=g, device=cuda).to(out.dtype)
    out.backward(do)
    kw = dict(scale=32 ** -0.5, causal=True)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, need_lse=True, **kw)
    delta = fa.flash_delta(do, out.detach())
    dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, **kw)
    ref = torch.cat([x.reshape(2, 128, 128) for x in (dq, dk, dv)], dim=-1)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(qkv.grad, ref, **tol)


@pytest.mark.cuda
def test_flash_kernels_refuse_misaligned_operands(cuda):
    """K1-K3 copy 16-byte chunks: a view 4 bytes off is refused, never
    sent to the plain version."""
    n = 1 * 16 * 2 * 32
    q = torch.randn(n + 1, device=cuda)[1:].view(1, 16, 2, 32)
    ok = torch.randn((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(q, ok, ok, scale=0.2)
    lse = torch.zeros((1, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dq(ok, ok, ok, q, lse, lse, scale=0.2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dkv(ok, q, ok, ok, lse, lse, scale=0.2)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_cannot_take(cuda):
    q = torch.randn((1, 16, 2, 24), device=cuda)  # Dh 24 is not built
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(q, q, q, scale=0.2)
    q = torch.randn((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_fwd(q, q.half(), q, scale=0.2)
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_fwd(q, q.cpu(), q, scale=0.2)


# ------------------------------------------- data-parallel trainer (slice 5)

@pytest.mark.cuda
def test_ddp_step_on_the_card_matches_the_cpu(cuda):
    """A tinycnn DDPEngine step at world 1 on NCCL against the same step
    on the CPU (no process group): loss and every parameter at rtol 1e-5
    with TF32 off. 8x8 images keep ReLU inputs that lie within rounding
    of zero unlikely (tests/test_torch_port_ddp.py)."""
    torch.backends.cudnn.allow_tf32 = False
    initialize_backend("cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        rng = np.random.RandomState(0)
        images = rng.randn(16, 8, 8, 3).astype(np.float32)
        labels = rng.randint(0, 10, 16)
        out = {}
        for dev, mesh in (("cuda", None), ("cpu", Mesh(1, None))):
            eng = DDPEngine(tiny_cnn(10), SGD(), mesh=mesh, device=dev)
            ts, m = eng.train_step(eng.init_state(0),
                                   *eng.shard_batch(images, labels), 0.1)
            out[dev] = (m, [t.detach().cpu() for t in tree_leaves(ts.params)],
                        eng.grad_reductions)
    finally:
        dist.destroy_process_group()
    (mc, pc, nc), (mh, ph, nh) = out["cuda"], out["cpu"]
    assert (nc, nh) == (1, 0)
    torch.testing.assert_close(mc["loss_sum"].cpu(), mh["loss_sum"],
                               rtol=1e-5, atol=0)
    for a, b in zip(pc, ph):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_serve_cli_on_the_card_runs_full_f32(cuda, monkeypatch, capsys):
    """Where a CLI picks the card it turns TF32 off in matmuls and cuDNN
    and selects cuDNN's deterministic algorithms, so a `--dtype float32`
    run is the f32 path the tests hold."""
    from distributed_model_parallel_tpu_torch.cli import serve

    for obj, name, value in ((torch.backends.cuda.matmul, "allow_tf32",
                              True),
                             (torch.backends.cudnn, "allow_tf32", True),
                             (torch.backends.cudnn, "deterministic", False)):
        monkeypatch.setattr(obj, name, value)
    out = serve.main(["--device", "cuda", "--vocab-size", "50", "--dim",
                      "32", "--layers", "2", "--heads", "4", "--num-slots",
                      "2", "--max-len", "32", "--prefill-len", "8",
                      "--prompt-len-max", "8", "--num-requests", "2",
                      "--max-new-tokens", "2"])
    assert out["serving"]["generated_tokens"] == 4
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic


def test_native_augment_matches_its_numpy_twin():
    """The port's own augment.cpp, built with g++ at first use into the
    package's build directory, against the NumPy path, bit for bit."""
    assert native.available()
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (64, 32, 32, 3)).astype(np.uint8)
    ys, xs, flips = dl._draw_augment(rng, 64, 4)
    for workers in (1, 8):
        got = native.augment_normalize(images, ys, xs, flips, 4, CIFAR10_MEAN,
                                       CIFAR10_STD, workers=workers)
        want = dl.normalize(dl._crop_flip_numpy(images, ys, xs, flips, 4),
                            CIFAR10_MEAN, CIFAR10_STD)
        assert np.array_equal(got, want)
