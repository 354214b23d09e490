"""The PyTorch port's CUDA kernels on the card, against their plain
versions. Every test here needs a CUDA GPU and skips without one; the
file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import pytest
import torch

from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm


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
])
def test_int8_kernel_matches_plain(cuda, m, k, n):
    """Identical activation codes and scales, outputs within 1e-6, one
    launch counted per call."""
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
    torch.testing.assert_close(y, qm.int8_matmul_plain(x, wq_t, ws),
                               rtol=1e-6, atol=1e-6)
    assert bool((y[:, 0] == 0).all())


@pytest.mark.cuda
def test_int8_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn((8, 30), device=cuda)  # K not a multiple of 4
    wq_t, ws = qm.prepare_weight(torch.randn((30, 16), device=cuda))
    with pytest.raises(ValueError, match="multiple of 4"):
        qm.int8_matmul(x, wq_t, ws)
    with pytest.raises(ValueError, match="different devices"):
        qm.int8_matmul(x.cpu(), wq_t, ws)
