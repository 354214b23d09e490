"""The PyTorch port's CUDA kernels on the card, against their plain
versions, and the data-parallel and pipeline steps on the card against
the CPU. Every test marked `cuda` needs a CUDA GPU and skips without
one; the native augment's test runs wherever g++ is. The file imports
neither jax nor the JAX package, so it runs on a GPU machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import importlib

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
@pytest.mark.parametrize("m,k,n", [
    (8, 384, 768), (8, 1536, 768),   # tp row shards at M 8 (S 2)
    (4, 1536, 768), (2, 192, 768),   # ring chunks at S 2 and S 4
    (9, 36, 33), (8, 776, 40),       # a second row tile; 4-byte words
])
def test_int8_kernel_with_input_absmax_matches_plain(cuda, m, k, n):
    """An input absmax per row (a tensor-parallel rank's slice of a row
    quantized with the whole row's, `row_absmax`): codes, scales and
    outputs equal the plain version's on the same absmax, including a
    zero absmax (the floor) and one below the slice's own (clipped
    codes)."""
    g = torch.Generator(device=cuda).manual_seed(m * 11 + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    wq_t, ws = qm.prepare_weight(torch.randn((k, n), generator=g,
                                             device=cuda))
    amax = x.abs().amax(dim=-1) * torch.linspace(0.5, 3.0, m, device=cuda)
    amax[0] = 0.0
    amax = amax.contiguous()
    before = qm.int8_matmul.launches
    y, q, s = qm.int8_matmul(x, wq_t, ws, absmax=amax, return_codes=True)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 1
    rq, rs = qm.quantize_rows(x, amax)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(y, qm.int8_matmul_plain(x, wq_t, ws, amax))
    assert not torch.equal(y, qm.int8_matmul_plain(x, wq_t, ws))
    with pytest.raises(ValueError, match="absmax must be"):
        qm.int8_matmul(x, wq_t, ws, absmax=amax[:-1].contiguous())


@pytest.mark.cuda
def test_quant_dot_under_a_ring_of_one(cuda):
    """`quant_dot("int8")` as the chunk GEMM of the collective-matmul
    rings: a ring of one rank (no group) is the plain dot, one K4 launch
    a projection, equal to `quant_matmul`; the f32 seam is None (the
    ring's own `chunk @ w`)."""
    from distributed_model_parallel_tpu_torch.ops import collective_matmul \
        as cm

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((8, 768), generator=g, device=cuda)
    w = 0.02 * torch.randn((768, 1152), generator=g, device=cuda)
    prepared = qm.prepare_weight(w)
    dot = qm.quant_dot("int8", prepared)
    assert qm.quant_dot("f32") is None and qm.quant_dot(None) is None
    before, hops = qm.int8_matmul.launches, cm.hops
    for ring in (cm.ag_matmul_quant, cm.matmul_rs_quant):
        y = ring(x, w, None, dot)
        assert torch.equal(y, qm.quant_matmul(x, w, "int8",
                                              prepared=prepared))
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 4
    assert cm.hops == hops


@pytest.mark.cuda
def test_int8_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn((8, 30), device=cuda)  # K not a multiple of 4
    wq_t, ws = qm.prepare_weight(torch.randn((30, 16), device=cuda))
    with pytest.raises(ValueError, match="multiple of 4"):
        qm.int8_matmul(x, wq_t, ws)
    with pytest.raises(ValueError, match="different devices"):
        qm.int8_matmul(x.cpu(), wq_t, ws)


# ------------------------------------------------ flash attention K1-K3

fa = importlib.import_module(
    "distributed_model_parallel_tpu_torch.ops.flash_attention")

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


# ------------------------------------------ paged serving on the card

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (40, 768, 2304), (40, 768, 768), (40, 768, 3072), (40, 3072, 768),
    (24, 768, 768), (24, 3072, 768),
])
def test_int8_kernel_matches_plain_at_verify_shapes(cuda, m, k, n):
    """The speculative verify step's rows through K4: num_slots x (k+1)
    = 8 x 5 and 8 x 3. Integer sums are exact and each row quantizes on
    its own, so the outputs are bit-identical, as at M = 8."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    wq_t, ws = qm.prepare_weight(
        0.02 * torch.randn((k, n), generator=g, device=cuda))
    y, q, s = qm.int8_matmul(x, wq_t, ws, return_codes=True)
    rq, rs = qm.quantize_rows(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(y, qm.int8_matmul_plain(x, wq_t, ws))
    # Row r of an M-row call equals the same row alone.
    assert torch.equal(y[5:6], qm.int8_matmul(x[5:6].contiguous(), wq_t,
                                              ws))


def _small_serving(device, mode, **kw):
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        init_params,
    )
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )

    cfg = GPTConfig(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=32, dropout_rate=0.0,
                    pad_token_id=0)
    eng = ServingEngine(cfg, num_slots=4, max_len=32, prefill_len=16,
                        compute_dtype=mode, device=device, **kw)
    return eng, eng.place_params(init_params(cfg, 0, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol", [("f32", 1e-4), ("int8", 5e-3)])
def test_paged_decode_on_the_card_matches_the_cpu(cuda, mode, tol):
    """Chunked paged prefill and six paged decode steps of a ragged
    batch on the card against the CPU (plain versions): every logit row
    within the small-model bars of chip_smoke.py."""
    runs, fed = {}, []  # the CPU run picks every token both runs feed
    for dev in ("cpu", "cuda"):
        eng, p = _small_serving(dev, mode, page_size=4, prefill_chunk=3)
        host, cache = eng.new_host(), eng.init_cache()
        g = np.random.RandomState(1)
        positions = np.zeros(4, np.int64)
        rows = []
        for slot, n in enumerate((3, 7, 5, 12)):
            prompt = g.randint(1, 97, size=n).astype(np.int32)
            for start in range(0, n, 3):
                ids, valid = eng.chunk_ids(prompt, start)
                host.ensure_pages(slot, start + valid)
                cache, nl = eng.chunk_prefill_step(
                    p, cache, host.device_row(slot), ids, start, valid)
            rows.append(nl.cpu())
            positions[slot] = n
        active = np.ones(4, bool)
        for step in range(6):
            if dev == "cpu":
                fed.append(torch.stack(rows[:4]).argmax(-1).numpy()
                           if step == 0 else rows[-1].argmax(-1).numpy())
            for slot in range(4):
                host.ensure_writable(cache, slot, int(positions[slot]))
            _, logits = eng.paged_decode_step(
                p, cache, host.device_table(),
                *eng.step_inputs(positions, fed[step], active))
            rows.append(logits.cpu())
            positions += 1
        runs[dev] = rows
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_speculative_int8_on_the_card_equals_plain_int8(cuda):
    """Speculative int8 decoding (k = 4, a fresh 1-layer draft) on the
    card gives the plain paged int8 run's tokens; K4 runs once per
    projection of every target decode or verify step and draft decode
    step."""
    import dataclasses

    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from distributed_model_parallel_tpu_torch.serving.scheduler import (
        Request,
    )

    kw = dict(page_size=4, prefill_chunk=4)
    target, p = _small_serving("cuda", "int8", speculative_k=4, **kw)
    plain, _ = _small_serving("cuda", "int8", **kw)
    draft = ServingEngine(dataclasses.replace(target.cfg, num_layers=1),
                          num_slots=4, max_len=32, prefill_len=16,
                          compute_dtype="int8", device="cuda", **kw)
    dp = draft.init_params(1)

    def requests():
        return [Request(i, np.random.RandomState(i).randint(
            1, 97, size=n).astype(np.int32), max_new_tokens=8)
            for i, n in enumerate((5, 9, 3, 12, 7, 4))]

    base = qm.int8_matmul.launches
    sched = target.run(p, requests(), draft=draft, draft_params=dp)
    spec_launches = qm.int8_matmul.launches - base
    want = {f.rid: f.tokens for f in plain.run(p, requests()).finished}
    assert {f.rid: f.tokens for f in sched.finished} == want
    assert spec_launches > 0 and spec_launches % 4 == 0


def _pipeline_step(stages, device, schedule, batch, cls=None, **kw):
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        PipelineEngine,
    )

    eng = (cls or PipelineEngine)(stages, SGD(), Mesh(1, None, 2, (device,)),
                                  num_microbatches=2, schedule=schedule, **kw)
    ts, m = eng.train_step(eng.init_state(0), *eng.shard_batch(*batch), 0.1)
    return (m["loss_sum"] / m["count"]).cpu(), [
        t.detach().cpu() for t in tree_leaves((ts.params, ts.model_state))]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_pipeline_step_on_the_card_matches_the_cpu(cuda, schedule,
                                                   monkeypatch):
    """One tinycnn pipeline step (S = 2, M = 2; interleaved V = 2) on the
    card against the CPU, TF32 off: the loss and every parameter and BN
    buffer, rtol 1e-5 (cuDNN and the CPU sum in another order)."""
    from distributed_model_parallel_tpu_torch.models.tinycnn import (
        split_stages,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    v = 2 if schedule == "interleaved" else 1
    rng = np.random.RandomState(0)
    batch = (rng.randn(16, 8, 8, 3).astype(np.float32),
             rng.randint(0, 10, 16))
    got, want = (_pipeline_step(split_stages(2 * v, 10), dev, schedule,
                                batch, virtual_stages=v)
                 for dev in (cuda, torch.device("cpu")))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1], want[1], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_lm_pipeline_step_on_the_card_matches_the_cpu(cuda, schedule):
    """One LMPipelineEngine step of a small GPT (S = 2, M = 2) on the
    card against the CPU, f32: the loss and every parameter."""
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        split_stages,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        LMPipelineEngine,
    )

    cfg = GPTConfig(vocab_size=64, dim=32, num_layers=4, num_heads=4,
                    ffn_dim=64, max_position=16, dropout_rate=0.0,
                    pad_token_id=0)
    ids = np.random.RandomState(1).randint(0, 64, (4, 16))
    got, want = (_pipeline_step(split_stages(2, cfg), dev, schedule,
                                (ids, ids), cls=LMPipelineEngine,
                                pad_token_id=0)
                 for dev in (cuda, torch.device("cpu")))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1], want[1], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _traced(fn, names):
    """`fn()` under torch.profiler: (its result, {name: launches of the
    device kernels whose name holds it})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    return out, {n: sum(c for key, c in kernels if n in key) for n in names}


def _sums_and_params(eng, ts, groups, lr, k, names=()):
    """Each group through `compile_multi_step(eng, k)`: (the float metric
    sums per group, the parameters and model state after, as CPU
    tensors, the launches of the device kernels named in `names` that a
    profile of the last group shows, when there is more than one)."""
    from distributed_model_parallel_tpu_torch.training.multistep import (
        compile_multi_step,
    )

    multi = compile_multi_step(eng, k)
    sums, traced = [], None
    for i, group in enumerate(groups):
        def dispatch(ts=ts, group=group):
            return multi(ts, [eng.shard_batch(*b) for b in group], lr)

        if i and i == len(groups) - 1:
            (ts, m), traced = _traced(dispatch, names)
        else:
            ts, m = dispatch()
        sums.append({key: float(v) for key, v in m.items()})
    leaves = [t.detach().cpu() for t in tree_leaves(
        (ts.params, ts.model_state))]
    return sums, leaves, multi.graph, traced


def _graph_vs_eager(make, groups, lr, k, names=()):
    """(graph run, eager run) from one start: `make()` builds a fresh
    (engine, state); the eager run dispatches the same groups step by
    step (k = 1 passes through) but sums each group's metrics as a
    dispatch does. Each run's last group (when there are several) is
    profiled and its launches of the kernels named in `names` counted."""
    from distributed_model_parallel_tpu_torch.training.multistep import (
        compile_multi_step,
    )

    eng, ts = make()
    got = _sums_and_params(eng, ts, groups, lr, k, names)
    eng0, ts0 = make()
    one = compile_multi_step(eng0, 1)
    sums, traced = [], None
    for i, group in enumerate(groups):
        def steps(ts0=ts0, group=group):
            acc = None
            for b in group:
                ts0, m = one(ts0, [eng0.shard_batch(*b)], lr)
                acc = m if acc is None else {key: acc[key] + m[key]
                                             for key in acc}
            return ts0, acc

        if i and i == len(groups) - 1:
            (ts0, acc), traced = _traced(steps, names)
        else:
            ts0, acc = steps()
        sums.append({key: float(v) for key, v in acc.items()})
    leaves = [t.detach().cpu() for t in tree_leaves(
        (ts0.params, ts0.model_state))]
    return got, (sums, leaves, traced), (eng, eng0)


@pytest.mark.cuda
def test_graph_dispatch_equals_eager_steps_ddp_bf16(cuda):
    """Two 4-step dispatches of a tinycnn DDP bf16 step at world 1 on NCCL
    (the first: one eager warmup step, the capture, three replays; the
    second: four replays) equal eight eager steps bit for bit, metric
    sums and every parameter and BN statistic. The host issues the
    gradient all-reduce for the warmup step and the capture only (a
    replay runs no Python); a profile of the four replays shows the
    NCCL kernels of four eager steps."""
    from distributed_model_parallel_tpu_torch.cli.common import (
        set_device_numerics,
    )

    set_device_numerics()
    initialize_backend("cuda")
    try:
        rng = np.random.RandomState(0)
        batches = [(rng.randn(16, 8, 8, 3).astype(np.float32),
                    rng.randint(0, 10, 16)) for _ in range(8)]

        def make():
            eng = DDPEngine(tiny_cnn(10), SGD(), device="cuda",
                            compute_dtype=torch.bfloat16)
            return eng, eng.init_state(0)

        (gs, gl, graph, gt), (es, el, et), (eng, eng0) = _graph_vs_eager(
            make, [batches[:4], batches[4:]], 0.1, 4, names=("nccl",))
    finally:
        dist.destroy_process_group()
    assert graph.captures == 1 and graph.replays == 7
    assert gs == es
    assert eng.grad_reductions == 1 + graph.captures
    assert eng0.grad_reductions == 8
    assert gt == et
    for a, b in zip(gl, el):
        assert torch.equal(a, b)


def _small_gpt(dropout=0.0):
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                     ffn_dim=256, max_position=64, dropout_rate=dropout,
                     pad_token_id=0)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_graph_dispatch_equals_eager_steps_lm_flash(cuda, remat):
    """A 2-layer GPT with the flash kernels K1-K3 (f32, dropout 0.1):
    two 4-step dispatches equal eight eager steps bit for bit; under
    remat as well, and remat equals no remat. The wrappers count the
    launches the host issues (the graph run's warmup step and capture,
    every eager step); a profile of the four replays shows each kernel
    as often as one of four eager steps."""
    from distributed_model_parallel_tpu_torch.data.lm import (
        synthetic_corpus,
    )
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine

    fa = importlib.import_module(
        "distributed_model_parallel_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = synthetic_corpus(97, 8 * 4 * 64 + 1, seed=3)
    batches = [(corpus[i * 256:(i + 1) * 256].reshape(4, 64),)
               for i in range(8)]
    names = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
             "flash_bwd_dkv_kernel")
    runs = {}
    for r in (remat, False):
        def make(r=r):
            eng = CausalLMSequenceParallelEngine(
                _small_gpt(0.1), SGD(), attention="ulysses_flash",
                remat=r, device="cuda")
            return eng, eng.init_state(0)

        before = fa.flash_fwd.launches
        (gs, gl, graph, gt), (es, el, et), _ = _graph_vs_eager(
            make, [batches[:4], batches[4:]], 0.05, 4, names=names)
        runs[r] = (gs, gl, fa.flash_fwd.launches - before)
        assert graph.replays == 7 and gs == es
        for a, b in zip(gl, el):
            assert torch.equal(a, b)
        # 2 layers x 4 steps; K1 twice a layer under remat
        per = 2 * 4 * (2 if r else 1)
        assert gt == et == {"flash_fwd_kernel": per,
                            "flash_bwd_dq_kernel": 2 * 4,
                            "flash_bwd_dkv_kernel": 2 * 4}
    # K1 through the wrapper: 2 layers, twice each under remat, for the
    # graph run's warmup step and capture and the eager run's 8 steps
    assert runs[remat][2] == 2 * (2 + 8) * (2 if remat else 1)
    assert runs[remat][0] == runs[False][0]
    for a, b in zip(runs[remat][1], runs[False][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bert_dropout_under_graph_and_remat_equals_eager(cuda):
    """A 2-layer BERT with dropout 0.1 (the dropout bits are a hash of the
    device step): a 4-step graph dispatch equals four eager steps, and
    remat equals no remat, bit for bit; dropout is live (the loss
    differs from dropout 0's)."""
    from distributed_model_parallel_tpu_torch.models import bert

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    batches = [(rng.randint(1, 64, size=(8, 16)).astype(np.int32),
                rng.randint(0, 3, size=8)) for _ in range(4)]
    out = {}
    for rate, remat in ((0.1, False), (0.1, True), (0.0, False)):
        cfg = bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                              num_heads=4, intermediate_size=64,
                              max_position=16, dropout_rate=rate)

        def make(cfg=cfg, remat=remat):
            eng = DDPEngine(bert.bert_for_classification(3, cfg,
                                                         remat=remat),
                            SGD(), mesh=Mesh(1, None), device="cuda")
            return eng, eng.init_state(0)

        (gs, gl, _, _), (es, el, _), _ = _graph_vs_eager(
            make, [batches], 0.05, 4)
        assert gs == es
        for a, b in zip(gl, el):
            assert torch.equal(a, b)
        out[rate, remat] = (gs, gl)
    assert out[0.1, True][0] == out[0.1, False][0]
    for a, b in zip(out[0.1, True][1], out[0.1, False][1]):
        assert torch.equal(a, b)
    assert out[0.1, False][0] != out[0.0, False][0]


@pytest.mark.cuda
def test_vit_step_on_the_card_matches_the_cpu(cuda):
    """One ViT DDP step (2 layers, dim 64, 32x32 images) on the card
    against the CPU: loss and every parameter at rtol 1e-5, TF32 off."""
    vit = importlib.import_module(
        "distributed_model_parallel_tpu_torch.models.vit")

    torch.backends.cudnn.allow_tf32 = False
    cfg = vit.ViTConfig(image_size=32, patch_size=4, dim=64, num_layers=2,
                        num_heads=4, mlp_dim=128)
    rng = np.random.RandomState(0)
    images = rng.randn(16, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = DDPEngine(vit.vit(10, cfg), SGD(), mesh=Mesh(1, None),
                        device=dev)
        ts, m = eng.train_step(eng.init_state(0),
                               *eng.shard_batch(images, labels), 0.05)
        out[dev] = (m, [t.detach().cpu() for t in tree_leaves(ts.params)])
    (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
    torch.testing.assert_close(mc["loss_sum"].cpu(), mh["loss_sum"],
                               rtol=1e-5, atol=0)
    for a, b in zip(pc, ph):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


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


# --------------------------------------- gradient reduction (slice 10)

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_reducer_modes_equal_monolithic_at_world_one_ddp(cuda, dtype):
    """tinycnn DDP at world 1 on NCCL: bucketed and overlapped (small
    buckets, 4 segments) equal monolithic bit for bit over two 4-step
    groups, eager and graph-dispatched (the bucket collectives issued
    from the reducer's stream inside the capture); the host issues two
    collectives a bucket for the warmup step and the capture only."""
    from distributed_model_parallel_tpu_torch.cli.common import (
        set_device_numerics,
    )

    set_device_numerics()
    initialize_backend("cuda")
    try:
        rng = np.random.RandomState(1)
        batches = [(rng.randn(16, 8, 8, 3).astype(np.float32),
                    rng.randint(0, 10, 16)) for _ in range(8)]
        runs = {}
        for mode in ("monolithic", "bucketed", "overlapped"):
            def make(mode=mode):
                eng = DDPEngine(tiny_cnn(10), SGD(), device="cuda",
                                compute_dtype=dtype, grad_reduction=mode,
                                bucket_mb=0.002)
                return eng, eng.init_state(0)

            runs[mode] = _graph_vs_eager(make, [batches[:4], batches[4:]],
                                         0.1, 4)
    finally:
        dist.destroy_process_group()
    (gs0, gl0, _, _), (es0, el0, _), _ = runs["monolithic"]
    for mode, ((gs, gl, graph, _), (es, el, _), (eng, eng0)) in runs.items():
        assert gs == es == gs0 == es0, mode
        for a, b, c in zip(gl, el, gl0):
            assert torch.equal(a, b) and torch.equal(a, c), mode
        per_step = eng0.grad_reductions // 8
        assert eng0.grad_reductions == 8 * per_step
        assert eng.grad_reductions == per_step * (1 + graph.captures)
        if mode != "monolithic":
            assert per_step > 2


@pytest.mark.cuda
def test_reducer_modes_equal_monolithic_at_world_one_lm(cuda):
    """A 3-layer GPT with the flash kernels K1-K3 (f32, dropout 0.1) at
    world 1 on NCCL: bucketed and overlapped equal monolithic bit for
    bit, eager and graph-dispatched."""
    from distributed_model_parallel_tpu_torch.data.lm import (
        synthetic_corpus,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=97, dim=64, num_layers=3, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.1,
                    pad_token_id=0)
    corpus = synthetic_corpus(97, 8 * 4 * 64 + 1, seed=3)
    batches = [(corpus[i * 256:(i + 1) * 256].reshape(4, 64),)
               for i in range(8)]
    initialize_backend("cuda")
    try:
        runs = {}
        for mode in ("monolithic", "bucketed", "overlapped"):
            def make(mode=mode):
                eng = CausalLMSequenceParallelEngine(
                    cfg, SGD(), attention="ulysses_flash", device="cuda",
                    grad_reduction=mode, bucket_mb=0.05)
                return eng, eng.init_state(0)

            runs[mode] = _graph_vs_eager(make, [batches[:4], batches[4:]],
                                         0.05, 4)
    finally:
        dist.destroy_process_group()
    (gs0, gl0, _, _), _, _ = runs["monolithic"]
    for mode, ((gs, gl, graph, _), (es, el, _), _) in runs.items():
        assert graph.replays == 7 and gs == es == gs0, mode
        for a, b, c in zip(gl, el, gl0):
            assert torch.equal(a, b) and torch.equal(a, c), mode


@pytest.mark.cuda
def test_wire_codec_on_the_card_equals_the_cpu(cuda):
    """int8 and bf16 codes, scales and decodes on the card equal the
    CPU's (the scale a true division by 127: torch divides a CUDA tensor
    by a Python scalar as a multiplication by its reciprocal), on random
    chunks of many magnitudes, all-zero, denormal and bf16 chunks."""
    from distributed_model_parallel_tpu_torch.ops import wire_codec as wc

    rng = np.random.RandomState(2)
    chunks = [(rng.randn(4099) * 10.0 ** e).astype(np.float32)
              for e in range(-6, 4)]
    chunks += [np.zeros(64, np.float32),
               np.array([1e-38, -1e-39, 3e-39, 0.0], np.float32)]
    for x in chunks:
        for dtype in (torch.float32, torch.bfloat16):
            host = torch.from_numpy(x).to(dtype)
            for wire in ("int8", "bf16"):
                pc, sc = wc.wire_encode(wire, host)
                pg, sg = wc.wire_encode(wire, host.to(cuda))
                assert torch.equal(pg.cpu(), pc)
                if sc is not None:
                    assert torch.equal(sg.cpu(), sc)
                assert torch.equal(
                    wc.wire_decode(wire, pg, sg, dtype).cpu(),
                    wc.wire_decode(wire, pc, sc, dtype))


# ------------------------------------------- slice 11: TP, device cache

def _tp_bert():
    from distributed_model_parallel_tpu_torch.models.bert import (
        BertConfig,
        bert_for_classification,
    )

    return bert_for_classification(4, BertConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=16, dropout_rate=0.0))


@pytest.mark.cuda
def test_tp_step_on_the_card_matches_the_cpu(cuda):
    """A TensorParallelEngine step at model 1 on NCCL (world 1) against
    the same step on the CPU (no process group): loss and every
    parameter at rtol 1e-5 with TF32 off."""
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel \
        import TensorParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )

    initialize_backend("cuda")
    try:
        rng = np.random.RandomState(0)
        ids = rng.randint(1, 97, (16, 12))
        labels = rng.randint(0, 4, 16)
        out = {}
        for dev, mesh in (("cuda", make_mesh(MeshSpec(data=-1, model=1))),
                          ("cpu", Mesh(1, None))):
            eng = TensorParallelEngine(_tp_bert(), SGD(), mesh, device=dev)
            ts, m = eng.train_step(eng.init_state(0),
                                   *eng.shard_batch(ids, labels), 0.05)
            out[dev] = (m, [t.detach().cpu() for t in tree_leaves(ts.params)])
    finally:
        dist.destroy_process_group()
    (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
    torch.testing.assert_close(mc["loss_sum"].cpu(), mh["loss_sum"],
                               rtol=1e-5, atol=0)
    for a, b in zip(pc, ph):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _cache_images(n=64):
    return np.random.RandomState(3).randint(0, 256, (n, 8, 8, 3)).astype(
        np.uint8)


@pytest.mark.cuda
def test_device_cache_bits_on_the_card_equal_the_cpu(cuda):
    """The cache's crops, flips and normalized pixels on the card equal
    the CPU's bit for bit, for a host-int step and a device-scalar one."""
    from distributed_model_parallel_tpu_torch.data.device_cache import (
        DeviceDatasetCache,
    )

    images = _cache_images()
    idx = np.random.RandomState(4).permutation(64)[:32].astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        cache = DeviceDatasetCache(images, dev, augment=True,
                                   mean=CIFAR10_MEAN, std=CIFAR10_STD)
        i = torch.from_numpy(idx).to(dev)
        out[dev] = [t.cpu() for step in (5, torch.tensor(6, device=dev))
                    for t in (*cache.augment_draws(i, step),
                              cache.transform()(i, step=step, train=True))]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replayed_device_cache_step_equals_eager(cuda):
    """A tinycnn DDP step on index batches through the device cache
    (augment on), two 4-step graph dispatches at world 1 on NCCL: the
    metric sums and every parameter equal eight eager steps bit for bit,
    and each replay draws its own step's crops (a probe inside the
    transform keeps each step's augmented batch; they equal the eager
    transform at that step and differ from step to step)."""
    from distributed_model_parallel_tpu_torch.cli.common import (
        set_device_numerics,
    )
    from distributed_model_parallel_tpu_torch.data.device_cache import (
        DeviceDatasetCache,
    )
    from distributed_model_parallel_tpu_torch.training.multistep import (
        compile_multi_step,
    )

    set_device_numerics()
    initialize_backend("cuda")
    try:
        rng = np.random.RandomState(0)
        batches = [((8 * s + np.arange(16, dtype=np.int32)) % 64,
                    rng.randint(0, 10, 16)) for s in range(8)]
        cache = DeviceDatasetCache(_cache_images(), "cuda", augment=True,
                                   mean=CIFAR10_MEAN, std=CIFAR10_STD)
        tf = cache.transform()

        def make():
            eng = DDPEngine(tiny_cnn(10), SGD(), device="cuda",
                            input_transform=tf)
            return eng, eng.init_state(0)

        (gs, gl, graph, _), (es, el, _), _ = _graph_vs_eager(
            make, [batches[:4], batches[4:]], 0.1, 4)
        assert graph.captures == 1 and graph.replays == 7
        assert gs == es
        for a, b in zip(gl, el):
            assert torch.equal(a, b)
        # The probe: one 4-step dispatch, each step's batch kept.
        seen = torch.zeros((4, 16, 8, 8, 3), device=cuda)

        def probe(indices, *, step=None, train=False):
            out = tf(indices, step=step, train=train)
            if train:
                at = torch.as_tensor(step, device=cuda).reshape(1) % 4
                seen.index_copy_(0, at, out[None])
            return out

        probe.wants_ctx = True
        eng = DDPEngine(tiny_cnn(10), SGD(), device="cuda",
                        input_transform=probe)
        multi = compile_multi_step(eng, 4)
        multi(eng.init_state(0), [eng.shard_batch(*b) for b in
                                  [batches[0]] * 4], 0.1)
        torch.cuda.synchronize()
        idx = eng.shard_batch(*batches[0])[0]
        for s in range(4):
            assert torch.equal(seen[s], tf(idx, step=s, train=True))
            if s:
                assert not torch.equal(seen[s], seen[s - 1])
    finally:
        dist.destroy_process_group()


# ------------------------------- FSDP and sharded checkpoints (slice 12)

@pytest.mark.cuda
def test_fsdp_bucketed_at_world_one_equals_ddp_on_the_card(cuda):
    """tinycnn at world 1 on NCCL (`min_shard_elems` 64, so the convs and
    the head gather): FSDP bucketed equals DDP bucketed bit for bit over
    two 4-step groups, eager and graph-dispatched (the weight gathers
    and the bucket collectives inside the capture)."""
    from distributed_model_parallel_tpu_torch.cli.common import (
        set_device_numerics,
    )
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )

    set_device_numerics()
    initialize_backend("cuda")
    try:
        rng = np.random.RandomState(2)
        batches = [(rng.randn(16, 8, 8, 3).astype(np.float32),
                    rng.randint(0, 10, 16)) for _ in range(8)]
        runs = {}
        for cls, kw in ((DDPEngine, {}),
                        (FSDPEngine, {"min_shard_elems": 64})):
            def make(cls=cls, kw=kw):
                eng = cls(tiny_cnn(10), SGD(), device="cuda",
                          grad_reduction="bucketed", bucket_mb=0.002, **kw)
                return eng, eng.init_state(0)

            runs[cls.__name__] = _graph_vs_eager(
                make, [batches[:4], batches[4:]], 0.1, 4)
    finally:
        dist.destroy_process_group()
    (gs0, gl0, _, _), (es0, el0, _), _ = runs["DDPEngine"]
    (gs, gl, graph, _), (es, el, _), (eng, eng0) = runs["FSDPEngine"]
    assert graph.replays > 0 and eng0.param_gathers > 0
    assert gs == es == gs0 == es0
    for a, b, c in zip(gl, el, gl0):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_sharded_save_and_resume_on_the_card_equals_straight(cuda,
                                                             tmp_path):
    """A BERT FSDP state on the card saved after 2 AdamW steps through
    the async writer, one more step taken while the writer runs, then
    restored into a fresh engine that takes steps 3 and 4: bit-equal to
    4 straight steps, the snapshot untouched by the step that raced
    it."""
    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.training.optim import AdamW

    rng = np.random.RandomState(3)
    batches = [(rng.randint(1, 97, (16, 12)), rng.randint(0, 4, 16))
               for _ in range(4)]

    def steps(eng, ts, group):
        for ids, labels in group:
            ts, _ = eng.train_step(ts, *eng.shard_batch(ids, labels), 1e-3)
        return ts

    def fresh():
        eng = FSDPEngine(_tp_bert(), AdamW(), Mesh(1, None), device="cuda")
        return eng, eng.init_state(0)

    eng, ts = fresh()
    straight = steps(eng, ts, batches)
    eng, ts = fresh()
    ts = steps(eng, ts, batches[:2])
    writer = checkpointing.AsyncCheckpointer()
    checkpointing.save_sharded(str(tmp_path), eng.to_canonical_sharded(ts),
                               acc=0.0, epoch=1, writer=writer)
    steps(eng, ts, batches[2:3])  # in place, while the writer runs
    writer.wait()
    eng, like = fresh()
    tree, _, epoch = checkpointing.restore_checkpoint(
        str(tmp_path), eng.canonical_spec(like))
    resumed = steps(eng, eng.from_canonical(tree, like), batches[2:])
    assert epoch == 1 and resumed.step == straight.step == 4
    for a, b in zip(tree_leaves((resumed.params, tuple(resumed.opt_state))),
                    tree_leaves((straight.params,
                                 tuple(straight.opt_state)))):
        assert torch.equal(a, b)


def _sp_inputs(seed, b=2, t=128, h=4, dh=64):
    rng = np.random.RandomState(seed)
    x = {n: rng.randn(b, t, h, dh).astype(np.float32) for n in "qkv"}
    x["mask"] = rng.rand(b, t) > 0.2
    x["mask"][:, 0] = True
    x["mask"][-1] = False  # a row with no valid key
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_and_ulysses_flash_at_one_shard_equal_flash_attention(cuda,
                                                                   dtype):
    """At S 1 the sequence-parallel cores are the path they were before
    the sequence-parallel slice: ring_flash's hop merge and LSE sentinels
    reduce to the flash kernels' forward and backward, Ulysses to its
    core; outputs and gradients equal flash_attention's bit for bit,
    and each launches K1, K2, K3 once."""
    from functools import partial

    ra = importlib.import_module(
        "distributed_model_parallel_tpu_torch.ops.ring_attention")

    x = _sp_inputs(11)
    mask = torch.from_numpy(x["mask"]).to(cuda)
    results = []
    for fn in (fa.flash_attention, ra.ring_flash_attention,
               partial(ra.ulysses_attention,
                       attention_impl=fa.flash_attention)):
        before = [k.launches for k in (fa.flash_fwd, fa.flash_bwd_dq,
                                       fa.flash_bwd_dkv)]
        q, k, v = (torch.from_numpy(x[n]).to(cuda, dtype).requires_grad_(True)
                   for n in "qkv")
        out = fn(q, k, v, mask, causal=True)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        after = [k.launches for k in (fa.flash_fwd, fa.flash_bwd_dq,
                                      fa.flash_bwd_dkv)]
        assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
        results.append((out, q.grad, k.grad, v.grad))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_lm_ring_flash_at_one_shard_equals_ulysses_flash(cuda):
    """One LM train step at S 1 on the card: ring_flash and
    ulysses_flash (both the flash kernels on the whole sequence at one
    shard) give the same metric sums and parameters bit for bit."""
    from distributed_model_parallel_tpu_torch.data.lm import (
        synthetic_corpus,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine

    cfg = GPTConfig(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.1,
                    pad_token_id=0)
    ids = synthetic_corpus(97, 4 * 64, seed=3).reshape(4, 64)
    got = []
    for attention in ("ulysses_flash", "ring_flash"):
        eng = CausalLMSequenceParallelEngine(
            cfg, SGD(), attention=attention, device="cuda",
            mesh=Mesh(1, None))
        ts = eng.init_state(0)
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), 0.05)
        got.append((m, list(tree_leaves(ts.params))))
    (m0, p0), (m1, p1) = got
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.cuda
def test_ring_flash_at_two_shards_launches_per_rank(cuda, tmp_path):
    """ring_flash over 2 gloo ranks sharing the card: causal, seq rank s
    launches K1, K2 and K3 s + 1 times each (its resident block and its
    s visible hops); non-causal, 2 each; the outputs and gradients equal
    flash_attention over the whole sequence on the card."""
    import _torch_port_ranks as ranks

    x = _sp_inputs(12)
    got = ranks.spawn(2, "ring_flash_on_card", x, tmp_path)
    mask = torch.from_numpy(x["mask"]).to(cuda)
    for causal in (True, False):
        assert [r[causal]["launches"] for r in got] == (
            [[1] * 3, [2] * 3] if causal else [[2] * 3] * 2)
        q, k, v = (torch.from_numpy(x[n]).to(cuda).requires_grad_(True)
                   for n in "qkv")
        out = fa.flash_attention(q, k, v, mask, causal=causal)
        out.square().sum().backward()
        want = [t.detach().cpu().numpy() for t in (out, q.grad, k.grad,
                                                   v.grad)]
        for i, w in enumerate(want):
            part = np.concatenate([r[causal]["parts"][i] for r in got],
                                  axis=1)
            np.testing.assert_allclose(part, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{causal} {i}")


def _moe_lm():
    """A small MoE GPT (block 1 of 2 routed, 4 experts) whose capacity
    factor 0.5 drops tokens."""
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        gpt_lm_model,
    )

    return gpt_lm_model(GPTConfig(
        vocab_size=97, dim=64, num_layers=2, num_heads=4, ffn_dim=256,
        max_position=32, dropout_rate=0.0, pad_token_id=0, num_experts=4,
        moe_every=2, moe_capacity_factor=0.5))


@pytest.mark.cuda
def test_moe_lm_step_on_the_card_matches_the_cpu(cuda):
    """One ExpertParallelLMEngine step with dropped tokens, on the card
    against the CPU: loss and every parameter at rtol 1e-5, TF32 off."""
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import ExpertParallelLMEngine

    model = _moe_lm()
    params, state = model.init(torch.Generator().manual_seed(0))
    ids = np.random.RandomState(0).randint(1, 97, (4, 32))
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ExpertParallelLMEngine(model, SGD(), Mesh(1, None),
                                     device=dev, pad_token_id=0)
        ts, m = eng.train_step(eng.state_from_params(params, state),
                               *eng.shard_batch(ids), 0.05)
        out[dev] = (m, [t.detach().cpu() for t in tree_leaves(ts.params)])
    (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
    torch.testing.assert_close(mc["loss_sum"].cpu(), mh["loss_sum"],
                               rtol=1e-5, atol=0)
    for a, b in zip(pc, ph):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_moe_hierarchical_at_one_rank_equals_gspmd_on_the_card(cuda):
    """At one rank the hierarchical exchange is the identity: three steps
    of hierarchical (with and without overlap) equal gspmd's bit for
    bit on the card."""
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import ExpertParallelLMEngine

    model = _moe_lm()
    params, state = model.init(torch.Generator().manual_seed(1))
    ids = np.random.RandomState(1).randint(1, 97, (4, 32))
    runs = []
    for dispatch, overlap in (("gspmd", False), ("hierarchical", False),
                              ("hierarchical", True)):
        eng = ExpertParallelLMEngine(model, SGD(), Mesh(1, None),
                                     device=cuda, dispatch=dispatch,
                                     overlap=overlap, pad_token_id=0)
        ts = eng.state_from_params(params, state)
        losses = []
        for _ in range(3):
            ts, m = eng.train_step(ts, *eng.shard_batch(ids), 0.05)
            losses.append(m["loss_sum"].cpu())
        runs.append((losses, [t.detach().cpu()
                              for t in tree_leaves(ts.params)]))
    for losses, leaves in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(losses, runs[0][0]))
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][1]))


@pytest.mark.cuda
def test_plan_dp1_on_the_card_matches_the_dense_step_and_the_cpu(cuda):
    """`--plan dp1` (the composed engine's dp-only tick program, world 1
    on NCCL): three SGD steps of a small GPT on the card equal the dense
    single-rank engine's on the card and the plan's own on the CPU within
    the f32 bar, losses and every parameter."""
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        init_params,
    )
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        ComposedPlanEngine,
        build_plan_engine,
    )
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.0,
                    pad_token_id=0)
    params = init_params(cfg, 0)
    ids = np.random.RandomState(16).randint(1, 97, (4, 64))
    initialize_backend("cuda")
    try:
        runs = {}
        for name, device in (("plan", "cuda"), ("dense", "cuda"),
                             ("plan_cpu", "cpu")):
            eng = (build_plan_engine(cfg, SGD(), "dp1", device=device)
                   if name.startswith("plan") else
                   CausalLMSequenceParallelEngine(cfg, SGD(), device=device,
                                                  mesh=Mesh(1, None)))
            if name.startswith("plan"):
                assert isinstance(eng, ComposedPlanEngine)
            ts = eng.state_from_params(params)
            losses = []
            for _ in range(3):
                ts, m = eng.train_step(ts, *eng.shard_batch(ids), 0.05)
                losses.append(float(m["loss_sum"] / m["count"]))
            runs[name] = (losses, [t.detach().cpu()
                                   for t in tree_leaves(ts.params)])
    finally:
        dist.destroy_process_group()
    for other in ("dense", "plan_cpu"):
        np.testing.assert_allclose(runs["plan"][0], runs[other][0],
                                   rtol=1e-5)
        for a, b in zip(runs["plan"][1], runs[other][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_plan_dp1_graph_dispatch_equals_eager_steps(cuda):
    """`--plan dp1 --steps-per-dispatch 4` at world 1 on NCCL: two 4-step
    dispatches of the composed engine's step (a CUDA graph replayed)
    equal eight eager steps bit for bit, metric sums and parameters."""
    from distributed_model_parallel_tpu_torch.data.lm import (
        synthetic_corpus,
    )
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        build_plan_engine,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.1,
                    pad_token_id=0)
    corpus = synthetic_corpus(97, 8 * 4 * 64 + 1, seed=5)
    batches = [(corpus[i * 256:(i + 1) * 256].reshape(4, 64),)
               for i in range(8)]
    initialize_backend("cuda")
    try:
        def make():
            eng = build_plan_engine(cfg, SGD(), "dp1", device="cuda")
            return eng, eng.init_state(0)

        (gs, gl, graph, _), (es, el, _), _ = _graph_vs_eager(
            make, [batches[:4], batches[4:]], 0.05, 4)
    finally:
        dist.destroy_process_group()
    assert graph.replays == 7 and gs == es
    for a, b in zip(gl, el):
        assert torch.equal(a, b)
