"""The port's dcn wire codec (`ops/wire_codec.py`) and its compressed
cross-slice reduction (`ops/grad_reduction.compressed_dcn_psum`) held
against the JAX package.

The codec is compared bit for bit: payloads, scales and decodes equal
the reference's on random, all-zero, tiny, denormal and bf16 chunks.
The reference runs op by op (as its own codec tests do): jitted, XLA
rewrites the scale's division by 127 into a multiplication by 1/127,
which rounds a few scales in a hundred one ulp away; the port keeps the
division (`wire_codec._div127`). `compressed_dcn_psum` runs on K gloo
ranks (`tests/_torch_port_ranks.py`, one spawn for each K, shared by the
cases) over a mesh of K one-rank slices, against the reference under
`shard_map` on K virtual devices: the same sums of the same decoded
chunks, in the same order, so the results agree at rtol 1e-6 with an
absolute floor of 1e-6·absmax (jitted, the reference's scales may sit
one ulp from the port's, which moves each of the K+1 decodes an element
crosses by at most absmax·2**-23), and lie within (K+1)·absmax/254 of
the f32 sum for int8 (the reference's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.ops import grad_reduction as jgr
from distributed_model_parallel_tpu.ops import wire_codec as jwc
from distributed_model_parallel_tpu.runtime.compat import shard_map
from distributed_model_parallel_tpu_torch.ops import grad_reduction as tgr
from distributed_model_parallel_tpu_torch.ops import wire_codec as twc


def _chunks():
    rng = np.random.RandomState(11)
    return {
        "random": (rng.randn(257) * 3e-2).astype(np.float32),
        "wide": (rng.randn(64) * 10.0 ** rng.uniform(-8, 4, 64)).astype(
            np.float32),
        "zeros": np.zeros(16, np.float32),
        "tiny": np.array([1e-35, -3e-35, 5e-36, 0.0], np.float32),
        "denormal": np.array([1e-38, -1e-39, 0.0, 3e-39, -5e-45],
                             np.float32),
        "halfway": (np.arange(-254, 255, dtype=np.float32) * 0.5),
    }


def test_surface_matches_reference():
    assert twc.COMPRESSION_MODES == jwc.COMPRESSION_MODES
    assert twc.ABSMAX_FLOOR == jwc.ABSMAX_FLOOR
    for w in twc.COMPRESSION_MODES:
        assert twc.wire_itemsize(w) == jwc.wire_itemsize(w)
        assert twc.check_compression(w) == w
    for bad in ("fp8", "NONE"):
        with pytest.raises(ValueError) as want:
            jwc.check_compression(bad)
        with pytest.raises(ValueError, match=repr(bad)) as got:
            twc.check_compression(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jwc.require_dcn_axis("int8", None, "bucket hop")
    with pytest.raises(ValueError) as got:
        twc.require_dcn_axis("int8", None, "bucket hop")
    assert str(got.value) == str(want.value)
    assert twc.require_dcn_axis("none", None) == "none"
    for ici in (1, 2, 4):
        for dcn in (1, 2, 4):
            for w in twc.COMPRESSION_MODES:
                assert (tgr.bucket_pad_multiple(ici, dcn, w)
                        == jgr.bucket_pad_multiple(ici, dcn, w))


@pytest.mark.parametrize("name", sorted(_chunks()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_bit_equal_to_reference(name, dtype):
    x = _chunks()[name]
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for wire in ("bf16", "int8"):
        jp, js = jwc.wire_encode(wire, jx)
        tp, ts = twc.wire_encode(wire, tx)
        np.testing.assert_array_equal(
            tp.float().numpy(), np.asarray(jp, np.float32), err_msg=wire)
        assert str(tp.dtype).split(".")[-1] == str(jp.dtype)
        if wire == "int8":
            assert ts.dtype == torch.float32
            assert float(ts) == float(js), (float(ts), float(js))
        jd = jwc.wire_decode(wire, jp, js, jx.dtype)
        td = twc.wire_decode(wire, tp, ts, tx.dtype)
        assert str(td.dtype).split(".")[-1] == str(jd.dtype)
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd, np.float32))
    # none is the identity
    p, s = twc.wire_encode("none", tx)
    assert p is tx and s is None and twc.wire_decode("none", p, s,
                                                     tx.dtype) is tx


# ------------------------------------------- compressed cross-slice psum

N_LOCAL = 40  # elements a rank: divisible by K and not a power of two


def _shards(k):
    rng = np.random.RandomState(100 + k)
    return (rng.randn(k, N_LOCAL) * 1e-2).astype(np.float32)


@pytest.fixture(scope="module")
def port_dcn(tmp_path_factory):
    """compressed_dcn_psum with each wire on K = 2 and 4 gloo ranks, one
    spawn each."""
    out = {}
    for k in (2, 4):
        x = _shards(k)
        out[k] = ranks.spawn(k, "reducer_ops", {
            "meshes": [1, k], "flat": x, "shard": x,
            "tree": {}, "bf16": [], "tree_cases": [],
        }, tmp_path_factory.mktemp(f"dcn{k}"))
    return out


def _jax_dcn(k, wire):
    """The reference's compressed_dcn_psum over K virtual devices;
    (K, N_LOCAL) rows, rank order."""
    mesh = JMesh(np.array(jax.devices()[:k]), ("dcn",))
    x = jnp.asarray(_shards(k).reshape(-1))
    fn = shard_map(lambda v: jgr.compressed_dcn_psum(v, "dcn", wire),
                   mesh=mesh, in_specs=(P("dcn"),), out_specs=P("dcn"),
                   check_vma=False)
    return np.asarray(jax.jit(fn)(x)).reshape(k, N_LOCAL)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_compressed_dcn_psum_matches_reference(port_dcn, k, wire):
    got = np.stack([r["dcn", wire] for r in port_dcn[k]])
    want = _jax_dcn(k, wire)
    exact = _shards(k).sum(axis=0)
    absmax = float(np.abs(_shards(k)).max())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * absmax)
    for row in got:
        if wire == "int8":
            assert np.abs(row - exact).max() <= (k + 1) * absmax / 254
        elif wire == "bf16":
            np.testing.assert_allclose(row, exact, rtol=1e-2,
                                       atol=(k + 1) * absmax * 2 ** -8)
        else:
            np.testing.assert_allclose(row, exact, rtol=1e-6, atol=1e-7)
    # every rank keeps its own sub-chunk unencoded: ranks agree exactly
    # only where no codec ran
    if wire == "none":
        for row in got[1:]:
            np.testing.assert_array_equal(row, got[0])


def test_compressed_dcn_psum_refuses_an_unpadded_shard(monkeypatch):
    """A shard that does not divide by K is refused, naming the padding
    (the group size is stubbed: the check comes before any collective)."""
    monkeypatch.setattr(tgr, "_size", lambda group: 4)
    with pytest.raises(ValueError, match="bucket_pad_multiple"):
        tgr.compressed_dcn_psum(torch.zeros(6), object(), "int8")
