"""The port's compressed cross-slice FSDP pieces held against the JAX
package: `ops/wire_codec.coded_ppermute` (the reference's custom VJP),
`parallel/fsdp._coded_dcn_gather` and FSDP on a `MeshSpec(dcn=2)` mesh
with `dcn_compression` bf16 / int8.

* `coded_ppermute` on 2 and 4 gloo ranks against the reference's inside
  `shard_map` on the CPU mesh, forward and backward (the cotangent
  through the codec over the inverse permutation), for each wire, on a
  ring and on a partial permutation (a rank that receives nothing gets
  zeros). "none" and bf16 are exact; int8 within the codec's budget
  (the reference jitted divides its scale by 127 as a multiplication by
  1/127, the port by a true division: a code may move by one).
* `_coded_dcn_gather` of a (16, 6) leaf over dcn 2 x ici 2 reproduces
  the fused gather's dcn-major layout: bit-exact with the identity
  codec, within one codec crossing for bf16 / int8 (the reference's
  `tests/test_wire_codec.py::test_fsdp_coded_gather_layout_matches_fused`).
* FSDP on tinycnn at dcn 2 (4 ranks: 2 slices of 2; and 2 ranks: 2
  slices of 1) against the reference's `FSDPEngine` at the same mesh,
  three SGD steps: within the wire budgets (bf16 1e-2, int8 5e-2) of
  the losses and the gathered parameters.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import _torch_port_ranks as ranks
import test_torch_port_fsdp as base
from distributed_model_parallel_tpu.models import tiny_cnn as j_tiny_cnn
from distributed_model_parallel_tpu.ops.wire_codec import (
    coded_ppermute as j_coded_ppermute,
)
from distributed_model_parallel_tpu.runtime.compat import shard_map
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    flatten_tree,
)

WIRES = ("none", "bf16", "int8")
BUDGET = {"none": 1e-5, "bf16": 1e-2, "int8": 5e-2}


def _perms(k):
    return {"ring": tuple((i, (i + 1) % k) for i in range(k)),
            "partial": ((0, 1),)}


def _inputs(k):
    rng = np.random.RandomState(k)
    return (rng.randn(k, 64).astype(np.float32) * 3,
            rng.randn(k, 64).astype(np.float32))


def _jax_hop(x, g, perm, wire):
    k = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:k]), ("dcn",))

    def f(xr, gr):
        y, vjp = jax.vjp(lambda v: j_coded_ppermute(v, "dcn", perm, wire),
                         xr)
        return y, vjp(gr)[0]

    y, dx = jax.jit(shard_map(f, mesh=mesh, in_specs=(JP("dcn"), JP("dcn")),
                              out_specs=(JP("dcn"), JP("dcn")),
                              check_vma=False))(x, g)
    return np.asarray(y), np.asarray(dx)


FSDP_RUNS = {4: [("bucketed", "bf16"), ("bucketed", "int8"),
                 ("monolithic", "int8")],
             2: [("overlapped", "bf16"), ("monolithic", "int8")]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    leaf = np.random.RandomState(0).randn(16, 6).astype(np.float32)
    batches = base._batches()
    ref, port = {}, {}
    for k in (2, 4):
        x, g = _inputs(k)
        for name, perm in _perms(k).items():
            for wire in WIRES:
                ref["hop", k, name, wire] = _jax_hop(x, g, perm, wire)
        cases = FSDP_RUNS[k]
        fsdp_ref = {c: base.jax_run(base.jax_engine(
            j_tiny_cnn(10), k, c[0], "sgd", wire=c[1], dcn=2,
            min_shard_elems=base.MIN_ELEMS), batches, base.LR["sgd"])
            for c in cases}
        params, state = next(iter(fsdp_ref.values()))[0]
        payload = {
            "x": x, "g": g, "leaf": leaf,
            "hops": [(name, perm, wire) for name, perm in _perms(k).items()
                     for wire in WIRES],
            "fsdp": {"model": "tinycnn", "params": params, "state": state,
                     "batches": batches, "min_shard_elems": base.MIN_ELEMS,
                     "runs": [{"name": c, "gr": c[0], "wire": c[1],
                               "dcn": 2, "opt": "sgd",
                               "lr": base.LR["sgd"],
                               "bucket_mb": base.BUCKET_MB}
                              for c in cases]}}
        port[k] = ranks.spawn(k, "codec_suite", payload,
                              tmp_path_factory.mktemp(f"codec{k}"))
        for c in cases:
            ref["fsdp", k, c] = fsdp_ref[c]
    return leaf, ref, port


@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("perm", ("ring", "partial"))
def test_coded_ppermute_forward_and_backward_match_the_reference(
        runs, k, wire, perm):
    _, ref, port = runs
    want_y, want_dx = ref["hop", k, perm, wire]
    absmax = 3 * 4.5  # the rows' absmax is below ~4.5 sigma of 3
    for r in range(k):
        got_y, got_dx = port[k][r]["hop", perm, wire]
        for got, want, scale in ((got_y, want_y[r:r + 1], absmax),
                                 (got_dx, want_dx[r:r + 1], 4.5)):
            if wire == "int8":
                assert np.abs(got - want).max() <= scale / 127 + 1e-6
            else:
                np.testing.assert_array_equal(got, want)
    if perm == "partial" and k > 2:
        # Ranks outside the permutation receive zeros, and their inputs
        # get no cotangent back.
        y, dx = port[k][2]["hop", perm, wire]
        assert not y.any() and not dx.any()


@pytest.mark.parametrize("wire", WIRES)
def test_coded_dcn_gather_reproduces_the_fused_layout(runs, wire):
    leaf, _, port = runs
    for r, out in enumerate(port[4]):
        got = out["gather", wire]
        if wire == "none":
            np.testing.assert_array_equal(got, leaf)
        else:
            tol = {"bf16": 4e-3, "int8": 1e-2}[wire] * np.abs(leaf).max() \
                / 3
            assert np.abs(got - leaf).max() <= max(tol, 1e-2), (r, wire)


@pytest.mark.parametrize("k,case", [(k, c) for k in (4, 2)
                                    for c in FSDP_RUNS[k]],
                         ids=[f"dcn2x{k // 2}-{gr}-{w}" for k in (4, 2)
                              for gr, w in FSDP_RUNS[k]])
def test_fsdp_on_a_compressed_dcn_mesh_matches_the_reference(runs, k, case):
    _, ref, port = runs
    _, sums, canonical, shapes = ref["fsdp", k, case]
    bar = BUDGET[case[1]]
    for r in range(k):
        got = port[k][r]["fsdp"][case]
        np.testing.assert_allclose([s["loss_sum"] for s in got["sums"]],
                                   [s["loss_sum"] for s in sums], rtol=bar)
        assert got["shapes"] == shapes[r]
    g = flatten_tree(port[k][0]["fsdp"][case]["canonical"]["params"])
    w = flatten_tree(canonical["params"])
    for key in w:
        np.testing.assert_allclose(g[key], w[key], rtol=bar, atol=bar,
                                   err_msg=key)
