"""The port's collective-matmul rings (`ops/collective_matmul.py`) held
against the JAX package's rings on its 8-device CPU mesh, the naive
monolithic forms and the dense product.

For ring sizes 2 (one ring of one hop), 3 (the odd single ring) and 4
(the bidirectional ring: 2 hops up, 1 down), on gloo ranks
(`tests/_torch_port_ranks.cm_ops`), from numpy inputs:

* `ag_matmul` and `matmul_rs` against the reference's rings (the same
  chunk folds in the same order), the port's naive all-gather /
  reduce-scatter forms, and x @ w: rtol 1e-5, atol 1e-7;
* their custom backwards (the dual rings) against the dense gradients of
  sum(out * g): rtol 1e-5, atol 1e-6;
* exactly S - 1 hops a ring forward, and 2 (S - 1) backward for
  ag_matmul (the dx ring and the dw ring), S - 1 for matmul_rs (dx and
  dw off one ring).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from distributed_model_parallel_tpu.ops.collective_matmul import (
    ag_matmul as jax_ag_matmul,
    matmul_rs as jax_matmul_rs,
)
from distributed_model_parallel_tpu.runtime.compat import shard_map

from tests._torch_port_ranks import spawn
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

SIZES = (2, 3, 4)
OP_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(size):
    """ag: x (2, 4S, 16), w (16, 8S); rs: x (2, 4S, 8S), w (8S, 16); g
    the cotangent of each output."""
    rng = np.random.RandomState(size)
    f32 = np.float32
    ag = {"x": 0.1 * rng.randn(2, 4 * size, 16), "w": 0.1 * rng.randn(
        16, 8 * size), "g": rng.randn(2, 4 * size, 8 * size)}
    rs = {"x": 0.1 * rng.randn(2, 4 * size, 8 * size), "w": 0.1 * rng.randn(
        8 * size, 16), "g": rng.randn(2, 4 * size, 16)}
    return ({k: v.astype(f32) for k, v in ag.items()},
            {k: v.astype(f32) for k, v in rs.items()})


def _jax_ring(name, size, x, w):
    mesh = Mesh(np.array(jax.devices()[:size]), ("m",))
    if name == "ag":
        fn, specs = jax_ag_matmul, (P(None, "m", None), P(None, "m"),
                                    P(None, None, "m"))
    else:
        fn, specs = jax_matmul_rs, (P(None, None, "m"), P("m", None),
                                    P(None, "m", None))
    return jax.jit(shard_map(partial(fn, axis_name="m"), mesh=mesh,
                             in_specs=specs[:2], out_specs=specs[2],
                             check_vma=False))(jnp.asarray(x),
                                               jnp.asarray(w))


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    out = {}
    for size in SIZES:
        ag, rs = _inputs(size)
        out[size] = spawn(size, "cm_ops", {"ag": ag, "rs": rs},
                          tmp_path_factory.mktemp(f"cm{size}"))
    return out


def _assemble(name, size, ranks, key):
    """The global array from the ranks' parts: ag's output is column-
    sharded (its dx row-, its dw column-sharded); rs's output is
    row-sharded (its dx column-, its dw row-sharded)."""
    parts = [r[name][key] for r in ranks]
    axis = {("ag", "y"): -1, ("ag", "naive"): -1, ("ag", "dx"): -2,
            ("ag", "dw"): -1, ("rs", "y"): -2, ("rs", "naive"): -2,
            ("rs", "dx"): -1, ("rs", "dw"): 0}[name, key]
    return np.concatenate(parts, axis=axis)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["ag", "rs"])
def test_ring_matches_reference_naive_and_dense(rings, name, size):
    data = _inputs(size)[name == "rs"]
    x, w = data["x"], data["w"]
    got = _assemble(name, size, rings[size], "y")
    np.testing.assert_allclose(got, np.asarray(_jax_ring(name, size, x, w)),
                               **OP_TOL)
    np.testing.assert_allclose(got, _assemble(name, size, rings[size],
                                              "naive"), **OP_TOL)
    np.testing.assert_allclose(got, x @ w, **OP_TOL)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["ag", "rs"])
def test_ring_gradients_match_dense(rings, name, size):
    """The dual rings' dx and dw against jax.grad of the dense product,
    and the reference rings' own custom backward."""
    data = _inputs(size)[name == "rs"]
    x, w, g = (jnp.asarray(data[k]) for k in ("x", "w", "g"))

    def dense(x, w):
        return jnp.sum((x @ w) * g)

    def ring(x, w):
        return jnp.sum(_jax_ring(name, size, x, w) * g)

    want = jax.grad(dense, argnums=(0, 1))(x, w)
    ref = jax.grad(ring, argnums=(0, 1))(x, w)
    for key, d, r in zip(("dx", "dw"), want, ref):
        got = _assemble(name, size, rings[size], key)
        np.testing.assert_allclose(got, np.asarray(d), **GRAD_TOL)
        np.testing.assert_allclose(got, np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("size", SIZES)
def test_rings_issue_s_minus_1_hops(rings, size):
    for r in rings[size]:
        assert r["ag"]["hops"] == r["rs"]["hops"] == size - 1
        assert r["ag"]["bwd_hops"] == 2 * (size - 1)
        assert r["rs"]["bwd_hops"] == size - 1
