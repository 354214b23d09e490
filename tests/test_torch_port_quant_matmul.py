"""The PyTorch port's int8 decode GEMM (`distributed_model_parallel_tpu_torch/
ops/quant_matmul.py`) held against the JAX reference
(`distributed_model_parallel_tpu/ops/quant_matmul.py`).

On the CPU the port's wrapper runs its plain version, the kernel's
arithmetic in torch; the reference runs its Pallas kernel in interpret
mode and its dtype-pinned XLA path. Inputs come from numpy seeds and
cross as numpy arrays. Quantization codes and scales must be IDENTICAL
(both sides use IEEE f32 division and round-half-to-even); outputs agree
within rtol/atol 1e-5, the reference's own bar between its two paths
(the integer dot is exact on every path, so only the final f32 products
can differ, in the last ulp). The kernel itself runs only on the GPU
(`tests/test_torch_port_cuda.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.ops import quant_matmul as jqm
from distributed_model_parallel_tpu.ops.wire_codec import (
    ABSMAX_FLOOR as JAX_FLOOR,
)
from distributed_model_parallel_tpu_torch.ops import quant_matmul as tqm
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

RTOL = ATOL = 1e-5
# (m, k, n, seed): the reference's path-parity shapes (m=256 -> two
# Pallas row blocks; m=3 -> one whole-array block) and decode-shaped
# cases at the full-width projection Ks, 768 and 3072 (ffn.out), with
# m = 8 slots. At K = 3072 one output's |acc| is driven past 2**24 (see
# `_xw`), where the int32 -> f32 conversion has to round.
SHAPES = ((256, 32, 16, 6), (3, 32, 16, 7), (8, 768, 96, 3),
          (8, 3072, 64, 5))


def _xw(seed, m, k, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    if k == 3072:
        # Codes 127 x 127 on all but one term: acc[0, 0] = 49540287, odd
        # and above 2**24, so f32 cannot hold it exactly.
        x[0] = 1.0
        x[0, 1] = 0.5
        w[:, 0] = 1.0
    return x, w


def test_surface_matches_reference():
    assert tqm.COMPUTE_DTYPES == jqm.COMPUTE_DTYPES
    assert tqm.ABSMAX_FLOOR == float(np.float32(JAX_FLOOR))
    for mode in tqm.COMPUTE_DTYPES:
        assert tqm.check_compute_dtype(mode) == mode
        assert tqm.normalize_compute_dtype(mode) == mode
    assert tqm.normalize_compute_dtype(None) == "f32"
    # Dtype objects map as the reference's do.
    assert tqm.normalize_compute_dtype(torch.bfloat16) == \
        jqm.normalize_compute_dtype(jnp.bfloat16) == "bf16"
    assert tqm.normalize_compute_dtype(torch.float32) == \
        jqm.normalize_compute_dtype(jnp.float32) == "f32"
    for bad in ("fp8", torch.float16, object()):
        with pytest.raises(ValueError, match="compute_dtype"):
            tqm.normalize_compute_dtype(bad)


@pytest.mark.parametrize("m,k,n,seed", SHAPES)
def test_quantize_codes_and_scales_identical(m, k, n, seed):
    x, w = _xw(seed, m, k, n)
    jq, js = jqm.quantize_rows(jnp.asarray(x))
    tq, ts = tqm.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jwq, jws = jqm.quantize_weight(jnp.asarray(w))
    twq, tws = tqm.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


@pytest.mark.parametrize("m,k,n,seed", SHAPES)
def test_int8_matches_pallas_interpret_and_xla(m, k, n, seed):
    x, w = _xw(seed, m, k, n)
    got = tqm.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           "int8").numpy()
    for path, kw in (("pallas", {"interpret": True}), ("xla", {})):
        ref = np.asarray(jqm.quant_matmul(
            jnp.asarray(x), jnp.asarray(w), "int8", path=path, **kw
        ))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def test_rank3_input_and_zero_column():
    x, w = _xw(8, 12, 16, 8)
    w[:, 3] = 0.0  # an all-zero weight column decodes to exact zeros
    x3 = x.reshape(3, 4, 16)
    got = tqm.quant_matmul(torch.from_numpy(x3), torch.from_numpy(w),
                           "int8").numpy()
    assert got.shape == (3, 4, 8)
    assert (got[..., 3] == 0).all()
    ref = np.asarray(jqm.quant_matmul(
        jnp.asarray(x3), jnp.asarray(w), "int8", path="pallas",
        interpret=True,
    ))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_f32_and_bf16_modes_match_reference():
    """f32 matches the reference; bf16 is a product of bf16 operands
    returned in bf16 on both sides, held at the reference's bf16 serving
    bar (tests/test_serving.py: rtol 1e-2, atol 2e-3): the two round
    their bf16 outputs after summing in another order."""
    x, w = _xw(4, 8, 32, 48)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        tqm.quant_matmul(tx, tw, "f32").numpy(),
        np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w), "f32")),
        rtol=RTOL, atol=ATOL,
    )
    got = tqm.quant_matmul(tx, tw, "bf16")
    ref = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w), "bf16")
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
        rtol=1e-2, atol=2e-3,
    )


def test_cached_weight_quantization_equals_per_call():
    x, w = _xw(11, 8, 64, 40)
    b = np.random.RandomState(12).randn(40).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    wq_t, wscale = tqm.prepare_weight(tw)
    wq, ws = tqm.quantize_weight(tw)
    assert wq_t.is_contiguous() and wq_t.shape == (40, 64)
    assert torch.equal(wq_t, wq.t()) and torch.equal(wscale, ws)
    per_call = tqm.QuantMatmul()
    cached = tqm.QuantMatmul()
    cached.prepare(tw)
    assert cached._lookup(tw) is not None
    assert cached._lookup(tw.clone()) is None  # identity, not value
    assert torch.equal(cached.column(tx, tw, tb),
                       per_call.column(tx, tw, tb))
    # The column and row seams compute the same projection (no model
    # group), as the reference's do.
    for proj in ("column", "row"):
        ref = np.asarray(getattr(jqm.QuantMatmul(), proj)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
        ))
        np.testing.assert_allclose(
            getattr(cached, proj)(tx, tw, tb).numpy(), ref, rtol=RTOL,
            atol=ATOL
        )


def _odd_offset(t):
    """A contiguous copy of `t` whose storage starts one byte in."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 4
    return view


def test_wrapper_refuses_bad_operands():
    x, w = _xw(13, 4, 32, 8)
    tx = torch.from_numpy(x)
    wq_t, ws = tqm.prepare_weight(torch.from_numpy(w))
    bad = [
        (tx.double(), wq_t, ws),                      # x dtype
        (tx[:, :16].contiguous(), wq_t, ws),          # K mismatch
        (tx.t().contiguous().t(), wq_t, ws),          # non-contiguous
        (tx[None], wq_t, ws),                         # rank
        (tx, wq_t.float(), ws),                       # weight dtype
        (tx, wq_t.t().contiguous(), ws),              # (K, N) not (N, K)
        (tx, wq_t, ws[:4]),                           # scale length
        (tx, wq_t, ws.double()),                      # scale dtype
        (tx, _odd_offset(wq_t), ws),                  # misaligned weight
    ]
    for args in bad:
        with pytest.raises(ValueError, match="int8_matmul"):
            tqm.int8_matmul(*args)
    launches = tqm.int8_matmul.launches
    y, q, s = tqm.int8_matmul(tx, wq_t, ws, return_codes=True)
    assert tqm.int8_matmul.launches == launches  # CPU: plain, no launch
    rq, rs = tqm.quantize_rows(tx)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(y, tqm.int8_matmul_plain(tx, wq_t, ws))
