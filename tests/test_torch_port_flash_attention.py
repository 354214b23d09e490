"""The port's flash attention (`ops/flash_attention.py`) and its N = 1
ring / Ulysses / ring-flash cores (`ops/ring_attention.py`) against the
JAX package.

On the CPU the port's kernel wrappers compute their plain versions; the
JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_attention.py runs them. The same numpy inputs go to
both. Bars are the JAX package's own (tests/test_pallas_attention.py):
f32 outputs and LSE rtol/atol 1e-5, f32 gradients rtol 2e-4 atol 2e-5
(:67), bf16 outputs 5e-2 (:63) and bf16 gradients 1e-1 (:133).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.runtime.compat import shard_map
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

fa = importlib.import_module(
    "distributed_model_parallel_tpu_torch.ops.flash_attention")
ra = importlib.import_module(
    "distributed_model_parallel_tpu_torch.ops.ring_attention")

# The JAX package's ops/__init__ re-exports functions under these module
# names, so the modules are looked up by path.
jpa = importlib.import_module(
    "distributed_model_parallel_tpu.ops.pallas_attention")
jra = importlib.import_module(
    "distributed_model_parallel_tpu.ops.ring_attention")

F32 = dict(out=dict(rtol=1e-5, atol=1e-5), grad=dict(rtol=2e-4, atol=2e-5))
BF16 = dict(out=dict(rtol=5e-2, atol=5e-2), grad=dict(rtol=1e-1, atol=1e-1))

# name: (T, Dh, mask kind, causal, bf16, JAX block size or None)
CASES = {
    "mask": (64, 32, "random", False, False, None),
    "no_mask": (64, 32, None, False, False, None),
    "causal": (64, 32, None, True, False, None),
    "causal_mask": (64, 32, "random", True, False, None),
    "k_blocks": (256, 32, "random", True, False, 64),
    "masked_row": (64, 32, "row", False, False, None),
    "ragged_dense": (20, 32, "random", True, False, None),
    "ragged_masked_row": (20, 32, "row", False, False, None),
    "dh128": (64, 128, None, True, False, None),
    "bf16": (128, 32, "random", True, True, None),
}
B, H = 2, 2


def _inputs(case):
    t, dh, mask_kind, causal, bf16, _ = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q, k, v, g = (rng.randn(B, t, H, dh).astype(np.float32)
                  for _ in range(4))
    mask = None
    if mask_kind == "random":
        mask = rng.rand(B, t) > 0.2
        mask[:, 0] = True
    elif mask_kind == "row":
        mask = np.ones((B, t), bool)
        mask[1] = False  # batch row 1: every key masked
    return q, k, v, g, mask, causal, bf16


def _jax(x, bf16):
    return None if x is None else jnp.asarray(
        x, jnp.bfloat16 if bf16 and x.dtype == np.float32 else None)


def _torch(x, bf16):
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 else t


def _blocks(case):
    blk = CASES[case][5]
    return {} if blk is None else dict(block_q=blk, block_k=blk)


def _bars(case):
    return BF16 if CASES[case][4] else F32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_results(case):
    """JAX forward, LSE (None where the lengths fall back to dense) and
    the gradients of sum(out**2) (as f32 numpy)."""
    q, k, v, _, mask, causal, bf16 = _inputs(case)
    jq, jk, jv, jm = (_jax(x, bf16) for x in (q, k, v, mask))
    kw = _blocks(case)

    def loss(q, k, v):
        out = jpa.flash_attention(q, k, v, jm, causal=causal, **kw)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    out = jpa.flash_attention(jq, jk, jv, jm, causal=causal, **kw)
    lse = None
    if fa.kernel_viable(q.shape[1], k.shape[1]):
        blk = kw.get("block_q", jpa.DEFAULT_BLOCK_Q)
        _, lse4 = jpa._flash_forward(
            jq, jk, jv, jm, 1.0 / np.sqrt(q.shape[-1]), blk,
            kw.get("block_k", jpa.DEFAULT_BLOCK_K), True, causal=causal,
            need_lse=True)
        lse = _np(lse4[..., 0])
    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    return _np(out), lse, tuple(_np(x) for x in grads), out.dtype


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    q, k, v, _, mask, causal, bf16 = _inputs(case)
    want, _, _, want_dtype = _jax_results(case)
    got = fa.flash_attention(*(_torch(x, bf16) for x in (q, k, v, mask)),
                             causal=causal)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert str(want_dtype) == ("bfloat16" if bf16 else "float32")
    np.testing.assert_allclose(_np(got), want, **_bars(case)["out"])


@pytest.mark.parametrize("case", sorted(
    c for c in CASES if fa.kernel_viable(CASES[c][0], CASES[c][0])))
def test_lse_matches_jax(case):
    """The kernel path's LSE, +inf on rows with no valid key."""
    q, k, v, _, mask, causal, bf16 = _inputs(case)
    _, want, _, _ = _jax_results(case)
    _, got = fa.flash_forward_lse(
        *(_torch(x, bf16) for x in (q, k, v, mask)),
        scale=1.0 / np.sqrt(q.shape[-1]), causal=causal)
    assert got.shape == (B, H, q.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_bars(case)["out"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    q, k, v, _, mask, causal, bf16 = _inputs(case)
    _, _, want, _ = _jax_results(case)
    tq, tk, tv = (_torch(x, bf16).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, _torch(mask, bf16), causal=causal)
    out.float().square().sum().backward()
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), w, err_msg=f"d{name}",
                                   **_bars(case)["grad"])


def test_fully_masked_row_kernel_path_vs_dense_path():
    """The kernel path gives out 0, LSE +inf and zero gradients on a row
    with no valid key; the dense path (a length not a multiple of 8)
    gives the mean of V there, as the reference's two paths do."""
    for case, kernel in (("masked_row", True), ("ragged_masked_row", False)):
        q, k, v, _, mask, causal, _ = _inputs(case)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, torch.from_numpy(mask))
        if kernel:
            assert bool((out[1] == 0).all())
            out.square().sum().backward()
            for t in (tq, tk, tv):
                assert bool((t.grad[1] == 0).all())
        else:
            mean_v = tv[1].mean(dim=0, keepdim=True).expand_as(out[1])
            torch.testing.assert_close(out[1], mean_v, rtol=1e-5, atol=1e-5)


def test_lse_only_when_a_gradient_is_needed(monkeypatch):
    seen = []
    real = fa.flash_fwd

    def spy(*a, **kw):
        seen.append(kw["need_lse"])
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    q = torch.randn(1, 16, 2, 16)
    fa.flash_attention(q, q, q)
    fa.flash_attention(q.clone().requires_grad_(True), q, q)
    assert seen == [False, True]


def test_general_mask_and_unbuilt_head_dim_refused():
    q = torch.randn(1, 16, 2, 16)
    with pytest.raises(NotImplementedError, match="key-validity"):
        fa.flash_attention(q, q, q, torch.ones(1, 1, 16, 16, dtype=bool))
    with pytest.raises(ValueError, match="head dims"):
        fa._check("flash_fwd", *(torch.randn(1, 16, 2, 24),) * 3)


# ------------------------------------------- ring / ulysses at N = 1

SP_FNS = {
    "ring": (jra.ring_attention, ra.ring_attention),
    "ulysses": (jra.ulysses_attention, ra.ulysses_attention),
    "ring_flash": (jra.ring_flash_attention, ra.ring_flash_attention),
}


def _one_shard(fn, mask):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    spec = P(None, "seq")
    if mask is None:
        return shard_map(lambda q, k, v: fn(q, k, v, None, causal=True),
                         mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                         check_vma=False)
    return shard_map(lambda q, k, v, m: fn(q, k, v, m, causal=True),
                     mesh=mesh, in_specs=(spec,) * 4, out_specs=spec,
                     check_vma=False)


@pytest.mark.parametrize("t", [32, 20])
@pytest.mark.parametrize("name", sorted(SP_FNS))
def test_sequence_parallel_cores_at_one_shard_match_jax(name, t):
    """Forward and gradients of each core at N = 1 (causal, key mask)
    against the JAX op under a one-device shard_map; T = 20 takes the
    dense per-pair path of ring_flash on both sides."""
    jfn, tfn = SP_FNS[name]
    rng = np.random.RandomState(t)
    q, k, v = (rng.randn(B, t, H, 16).astype(np.float32) for _ in range(3))
    mask = rng.rand(B, t) > 0.2
    mask[:, 0] = True
    jf = _one_shard(jfn, mask)
    jm = jnp.asarray(mask)
    want = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jnp.square(jf(*a, jm))), argnums=(0, 1, 2)
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tfn(tq, tk, tv, torch.from_numpy(mask), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32["out"])
    got.square().sum().backward()
    for nm, tt, w in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(_np(tt.grad), np.asarray(w),
                                   err_msg=f"d{nm}", **F32["grad"])


@pytest.fixture(scope="module")
def two_shards(tmp_path_factory):
    """Each core at N = 2 on two gloo ranks (causal, key mask), forward
    and gradients (`tests/_torch_port_ranks.ring_ops`)."""
    rng = np.random.RandomState(7)
    x = {n: rng.randn(B, 32, H, 16).astype(np.float32) for n in "qkv"}
    x["mask"] = rng.rand(B, 32) > 0.2
    x["mask"][:, 0] = True
    got = ranks.spawn(2, "ring_ops", dict(
        x, cases=[(n, True, "float32") for n in SP_FNS]),
        tmp_path_factory.mktemp("sp2"))
    return x, got


@pytest.mark.parametrize("name", sorted(SP_FNS))
def test_more_than_one_sequence_shard_is_refused(name, two_shards):
    """Refused before the sequence-parallel slice; now each core runs
    over two shards and equals dense attention of the whole sequence,
    forward and gradients, at the reference's sharded bars
    (tests/test_sequence_parallel.py)."""
    x, got = two_shards
    t = {n: torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv"}
    want = dot_product_attention(t["q"], t["k"], t["v"],
                                 torch.from_numpy(x["mask"]), causal=True)
    want.square().sum().backward()
    parts = [np.concatenate([r[name, True, "float32"][i] for r in got],
                            axis=1) for i in range(4)]
    np.testing.assert_allclose(parts[0], _np(want), **F32["out"])
    for i, n in enumerate("qkv", 1):
        np.testing.assert_allclose(parts[i], _np(t[n].grad),
                                   err_msg=f"d{n}", **F32["grad"])


def test_kernel_route_matches_the_references_blocks_viable():
    """The port sends a pair of lengths to the kernels exactly when the
    reference's `_blocks_viable` finds Pallas blocks for it."""
    for tq in range(1, 70):
        for tk in (8, 17, 24, tq):
            want = jpa._blocks_viable(tq, tk, jpa.DEFAULT_BLOCK_Q,
                                      jpa.DEFAULT_BLOCK_K) is not None
            assert fa.kernel_viable(tq, tk) == want, (tq, tk)
