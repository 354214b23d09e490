"""The port's sequence-parallel attention (`ops/ring_attention.py`) at
N = 2 and 4 shards held against the JAX package's ops.

The port runs on gloo ranks (`tests/_torch_port_ranks.ring_ops`: one
spawn for each world size, every case in it), each rank holding its
columns of the global q, k, v and key mask over the seq group of
`MeshSpec(data=1, seq=N)`; the reference runs the same op under
`shard_map` on as many virtual CPU devices of the same mesh, with
`ring_flash_attention` on its Pallas kernels in interpret mode where the
block lengths tile (T/N a multiple of 8), as its own tests run it. The
inputs have a random key mask, and batch row 1 has no valid key at all
(each op keeps the reference's convention there: the dense cores and the
plain ring average V, the flash kernels give 0).

Tolerances are the reference's own sharded bars
(`tests/test_sequence_parallel.py`): outputs rtol 1e-5 / atol 1e-5,
gradients rtol 2e-4 / atol 2e-5 (the port's plain-ring backward sends
the blocks' gradients back round the ring from one `autograd.Function`,
the reference transposes each `ppermute`: the same sums in another
order); bf16 rtol 5e-2 / atol 5e-2.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_port_ranks as ranks
from distributed_model_parallel_tpu.ops.pallas_attention import (
    flash_attention as j_flash,
)
from distributed_model_parallel_tpu.runtime.compat import shard_map
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu_torch.models.bert import BertConfig
from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    CausalLMSequenceParallelEngine,
    SequenceParallelEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import SGD

jra = importlib.import_module("distributed_model_parallel_tpu.ops."
                              "ring_attention")

B, T, H, DH = 2, 32, 4, 8
OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
NAMES = ("ring", "ring_flash", "ulysses", "ulysses_flash")
JFNS = {"ring": jra.ring_attention, "ring_flash": jra.ring_flash_attention,
        "ulysses": jra.ulysses_attention,
        "ulysses_flash": partial(jra.ulysses_attention,
                                 attention_impl=j_flash)}
# N 4 runs the flash cores causal only (the LM's path); N 2 runs all.
CASES = {s: [(n, c, "float32") for n in NAMES for c in (False, True)
             if s == 2 or c or not n.endswith("flash")] for s in (2, 4)}
CASES[2] += [(n, True, "bfloat16") for n in NAMES]


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, T, H, DH).astype(np.float32) for _ in range(3))
    mask = rng.rand(B, T) > 0.2
    mask[0, 0] = True
    mask[1] = False  # a row with no valid key
    return {"q": q, "k": k, "v": v, "mask": mask}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    inputs = _inputs()
    return {s: ranks.spawn(s, "ring_ops", dict(inputs, cases=CASES[s]),
                           tmp_path_factory.mktemp(f"s{s}"))
            for s in (2, 4)}


def _jax_case(s, name, causal, dtype):
    """The reference op on an (1, s) mesh: (out, dq, dk, dv) as f32."""
    x = _inputs()
    dt = jnp.dtype(dtype)
    mesh = j_mesh(JMeshSpec(data=1, seq=s), devices=jax.devices()[:s])
    spec = P(None, "seq")
    f = shard_map(partial(JFNS[name], axis_name="seq", causal=causal),
                  mesh=mesh, in_specs=(spec,) * 4, out_specs=spec,
                  check_vma=False)
    mask = jnp.asarray(x["mask"])

    def loss(q, k, v):
        o = f(q, k, v, mask)
        return jnp.sum(jnp.square(o.astype(jnp.float32))), o

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[n], dt) for n in "qkv"))
    return [np.asarray(a, np.float32) for a in (out,) + tuple(grads)]


@pytest.mark.parametrize("s,name,causal,dtype", [
    (s,) + c for s in (2, 4) for c in CASES[s]],
    ids=[f"S{s}-{n}-{'causal' if c else 'full'}-{d}"
         for s in (2, 4) for n, c, d in CASES[s]])
def test_op_matches_reference(port, s, name, causal, dtype):
    """Forward and the three gradients of one op at N shards against the
    reference op on the same mesh and inputs."""
    want = _jax_case(s, name, causal, dtype)
    got = [np.concatenate([r[name, causal, dtype][i] for r in port[s]],
                          axis=1) for i in range(4)]
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        tol = BF16 if dtype == "bfloat16" else (OUT if i == 0 else GRAD)
        np.testing.assert_allclose(got[i], want[i], err_msg=what, **tol)


def test_fully_masked_row_keeps_each_cores_convention(port):
    """Batch row 1 has no valid key: the flash cores give 0 there (the
    kernels' convention), the dense cores the mean of V over the keys
    they attend (all T of them for Ulysses, as the dense reference)."""
    v = _inputs()["v"]
    for name in NAMES:
        out = np.concatenate([r[name, False, "float32"][0]
                              for r in port[2]], axis=1)
        if name.endswith("flash"):
            np.testing.assert_array_equal(out[1], 0.0)
        else:
            np.testing.assert_allclose(
                out[1], np.broadcast_to(v[1].mean(0), out[1].shape),
                rtol=1e-5, atol=1e-6)


def test_causal_rank0_gets_gradients_from_every_later_rank(port):
    """Under causal rank 0's queries use no hop, but its K/V are seen by
    every later rank: the gradients the backward sends home reach it."""
    for s in (2, 4):
        for name in NAMES:
            dk0 = port[s][0][name, True, "float32"][2]
            assert np.abs(dk0).max() > 0, (s, name)


@pytest.mark.parametrize("engine", ["lm", "bert"])
def test_ulysses_refuses_heads_not_divisible_by_the_shards(engine):
    """The reference's message, at construction instead of at the first
    traced step."""
    mesh = Mesh(1, None, seq=2)
    with pytest.raises(ValueError) as err:
        if engine == "lm":
            CausalLMSequenceParallelEngine(
                GPTConfig(vocab_size=16, dim=24, num_layers=1, num_heads=3,
                          ffn_dim=32, max_position=16), SGD(),
                attention="ulysses", device="cpu", mesh=mesh)
        else:
            SequenceParallelEngine(
                BertConfig(vocab_size=16, hidden_size=24, num_layers=1,
                           num_heads=3, intermediate_size=32,
                           max_position=16), 2, SGD(), mesh=mesh,
                attention="ulysses_flash", device="cpu")
    jmesh = j_mesh(JMeshSpec(data=1, seq=2), devices=jax.devices()[:2])
    x = jnp.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError) as want:
        shard_map(partial(jra.ulysses_attention, axis_name="seq"),
                  mesh=jmesh, in_specs=(P(None, "seq"),) * 3,
                  out_specs=P(None, "seq"), check_vma=False)(x, x, x)
    assert str(err.value) == str(want.value)
