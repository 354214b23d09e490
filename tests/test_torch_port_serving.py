"""The PyTorch port's GPT serving slice held against the JAX reference.

A small GPT (2 layers, dim 64, 4 heads, vocab 97) is initialized once
by the JAX package, crosses to the port through
`models/convert.from_jax_params`, and both `ServingEngine`s (the
reference's replicated engine with no mesh; the port's on
device="cpu") prefill the same ragged prompts and decode in lockstep.

Tolerances:
* f32 — rtol/atol 1e-5 on every prefill next-logit row and every
  decode step's logits (the reference's own cache-vs-recompute bar);
  sums run in another order in the two frameworks, nothing else
  differs. Greedy tokens identical.
* int8 — greedy tokens identical; logits within rtol 1e-5, atol 5e-3.
  The integer dot is exact on both sides and the activation codes are
  identical whenever the f32 activations are, so the logits agree to
  ~1e-7 on this data; but a one-ulp f32 difference upstream can tip
  one activation across a round-half tie, moving that projection's
  outputs by up to max|x|*max|w|/127 (~3e-3 at these widths) — the
  atol covers exactly one such flip. The f32 bar is not loosened.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models.gpt import (
    GPTConfig as JaxGPTConfig,
    gpt_lm as jax_gpt_lm,
)
from distributed_model_parallel_tpu.models.layers import (
    Context as JaxContext,
)
from distributed_model_parallel_tpu.serving.engine import (
    ServingEngine as JaxEngine,
)
from distributed_model_parallel_tpu.serving.sampling import (
    SamplingConfig as JaxSamplingConfig,
    SlotSampler as JaxSlotSampler,
)
from distributed_model_parallel_tpu.serving.scheduler import (
    Request as JaxRequest,
)
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.models.gpt import (
    GPTConfig,
    gpt_lm,
)
from distributed_model_parallel_tpu_torch.serving.engine import (
    ServingEngine,
)
from distributed_model_parallel_tpu_torch.serving.sampling import (
    SamplingConfig,
    SlotSampler,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import Request

CFG_KW = dict(vocab_size=97, dim=64, num_layers=2, num_heads=4,
              ffn_dim=256, max_position=32, dropout_rate=0.0,
              pad_token_id=0)
ENGINE_KW = dict(num_slots=4, max_len=32, prefill_len=16)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-5, atol=5e-3)
PROMPT_LENS = (3, 7, 5, 12)


@pytest.fixture(scope="module")
def jax_params():
    eng = JaxEngine(JaxGPTConfig(**CFG_KW), **ENGINE_KW)
    params = eng.init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=["f32", "int8"])
def engines(request, jax_params):
    mode = request.param
    jeng = JaxEngine(JaxGPTConfig(**CFG_KW), compute_dtype=mode,
                     **ENGINE_KW)
    teng = ServingEngine(GPTConfig(**CFG_KW), compute_dtype=mode,
                         device="cpu", **ENGINE_KW)
    jp = jeng.place_params(jax.tree.map(jnp.asarray, jax_params))
    tp = teng.place_params(from_jax_params(jax_params))
    return mode, jeng, jp, teng, tp


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG_KW["vocab_size"], size=n).astype(np.int32)
            for n in lens]


def test_decode_lockstep_matches_reference(engines):
    """Prefill a ragged batch, decode mixed-position steps (one slot
    idle for a step), recycle a slot mid-run — every logit row compared
    and every greedy token identical."""
    mode, jeng, jp, teng, tp = engines
    tol = F32_TOL if mode == "f32" else INT8_TOL
    jc, tc = jeng.init_cache(), teng.init_cache()
    tokens = np.zeros((4,), np.int32)
    active = np.zeros((4,), bool)

    def ingest(slot, prompt):
        nonlocal jc, tc
        ids, length = jeng.pad_prompt(prompt)
        jc, jl = jeng.prefill(jp, jc, ids, length, jnp.int32(slot))
        tids, tlength = teng.pad_prompt(prompt)
        assert tlength == int(length)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
        tc, tl = teng.prefill(tp, tc, tids, tlength, slot)
        jl, tl = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(tl, jl, **tol)
        assert tl.argmax() == jl.argmax()
        tokens[slot] = jl.argmax()
        active[slot] = True

    def step(n):
        nonlocal jc, tc
        for _ in range(n):
            jc, jl = jeng.decode_step(jp, jc, jnp.asarray(tokens),
                                      jnp.asarray(active))
            tc, tl = teng.decode_step(
                tp, tc, torch.from_numpy(tokens.astype(np.int64)),
                torch.from_numpy(active),
            )
            jl, tl = np.asarray(jl), tl.numpy()
            np.testing.assert_allclose(tl[active], jl[active], **tol)
            np.testing.assert_array_equal(
                tl[active].argmax(-1), jl[active].argmax(-1)
            )
            tokens[:] = jl.argmax(-1)

    for slot, prompt in enumerate(_prompts()):
        ingest(slot, prompt)
    step(3)
    active[2] = False
    step(1)
    active[2] = True
    ingest(1, _prompts(seed=9, lens=(4,))[0])
    step(3)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **tol)


def test_run_greedy_tokens_match_reference(engines):
    """The continuous-batching loop end to end: more requests than
    slots (admission, eviction, recycling), identical greedy output."""
    _, jeng, jp, teng, tp = engines
    prompts = _prompts(seed=3, lens=(5, 9, 2, 14, 6, 11))
    jsched = jeng.run(jp, [JaxRequest(i, p, max_new_tokens=6)
                           for i, p in enumerate(prompts)])
    tsched = teng.run(tp, [Request(i, p, max_new_tokens=6)
                           for i, p in enumerate(prompts)])
    jtok = {f.rid: f.tokens for f in jsched.finished}
    ttok = {f.rid: f.tokens for f in tsched.finished}
    assert ttok == jtok
    jrep, trep = jsched.latency_report(), tsched.latency_report()
    for key in ("requests", "generated_tokens", "decode_steps",
                "engine_iterations", "mean_batch_occupancy", "goodput"):
        assert trep[key] == jrep[key], key


def test_int8_decode_goes_through_the_int8_gemm(engines, monkeypatch):
    """Under int8 every decode step sends each block's four projections
    (and nothing else) through `int8_matmul`; prefill never does."""
    from distributed_model_parallel_tpu_torch.ops import quant_matmul

    mode, _, _, teng, tp = engines
    calls = []
    real = quant_matmul.int8_matmul
    monkeypatch.setattr(quant_matmul, "int8_matmul",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    cache = teng.init_cache()
    ids, length = teng.pad_prompt(_prompts()[0])
    cache, _ = teng.prefill(tp, cache, ids, length, 0)
    assert calls == []
    active = torch.tensor([True, False, False, False])
    teng.decode_step(tp, cache, torch.zeros(4, dtype=torch.int64), active)
    expect = 4 * CFG_KW["num_layers"] if mode == "int8" else 0
    assert len(calls) == expect
    assert all(s[0] == ENGINE_KW["num_slots"] for s in calls)


def _first_decode_logits(eng, params, prompts, to_slot, feed):
    cache = eng.init_cache()
    rows = []
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, row = eng.prefill(params, cache, ids, length, to_slot(slot))
        rows.append(np.asarray(row))
    tokens = np.stack(rows).argmax(-1)
    return np.asarray(feed(cache, tokens)[1])


def test_int8_gap_to_f32_is_the_references_own(jax_params):
    """The int8-vs-f32 logit gap of a decode step (max|int8 - f32| /
    max|f32|) is the reference's own: the port's equals the JAX engine's
    on the same weights, prompts and fed tokens, to the f32 rounding of
    the two frameworks (int8_gap_vs_jax.py reads the same at GPT-2-small
    width: 2.2250e-2 against 2.2251e-2)."""
    prompts = _prompts()
    gaps = {}
    for pkg in ("port", "jax"):
        logits = {}
        for mode in ("f32", "int8"):
            if pkg == "jax":
                eng = JaxEngine(JaxGPTConfig(**CFG_KW), compute_dtype=mode,
                                **ENGINE_KW)
                p = eng.place_params(jax.tree.map(jnp.asarray, jax_params))
                logits[mode] = _first_decode_logits(
                    eng, p, prompts, jnp.int32,
                    lambda c, t, e=eng, p=p: e.decode_step(
                        p, c, jnp.asarray(t, jnp.int32),
                        jnp.ones((4,), bool)))
            else:
                eng = ServingEngine(GPTConfig(**CFG_KW), compute_dtype=mode,
                                    device="cpu", **ENGINE_KW)
                p = eng.place_params(from_jax_params(jax_params))
                logits[mode] = _first_decode_logits(
                    eng, p, prompts, int,
                    lambda c, t, e=eng, p=p: e.decode_step(
                        p, c, torch.from_numpy(t),
                        torch.ones(4, dtype=torch.bool)))
        diff = np.abs(logits["int8"] - logits["f32"]).max()
        gaps[pkg] = diff / np.abs(logits["f32"]).max()
    assert gaps["jax"] > 1e-4  # int8 moves the logits at these widths too
    np.testing.assert_allclose(gaps["port"], gaps["jax"], rtol=1e-4)


def test_gpt_lm_full_sequence_matches_reference(jax_params):
    cfg = GPTConfig(**CFG_KW)
    ids = np.random.RandomState(5).randint(1, 97, size=(2, 10))
    ids[1, 7:] = 0  # padded tail exercises the pad_token_id key mask
    model = jax_gpt_lm(JaxGPTConfig(**CFG_KW))
    state = {"stem": {}, "head": {},
             "blocks": {str(i): {} for i in range(cfg.num_layers)}}
    ref, _ = model.apply(jax.tree.map(jnp.asarray, jax_params), state,
                         jnp.asarray(ids, jnp.int32), JaxContext())
    got = gpt_lm(from_jax_params(jax_params), torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_weight_bridge_round_trip(jax_params):
    port = from_jax_params(jax_params)
    assert port["blocks"]["1"]["attn"]["qkv"]["w"].shape == (64, 192)
    assert port["head"]["w"].dtype == torch.float32
    back = to_jax_params(port)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    broken = dict(jax_params, head={"w": jax_params["head"]["w"],
                                    "b": np.zeros(97, np.float32)})
    with pytest.raises(ValueError, match="params/head"):
        from_jax_params(broken)


def test_sampler_lanes_match_reference_bit_for_bit():
    logits = np.random.RandomState(2).randn(6, 97).astype(np.float32)
    for kw in (dict(temperature=0.8, seed=3),
               dict(temperature=1.3, top_k=10, top_p=0.9, seed=4)):
        ts = SlotSampler(SamplingConfig(**kw), 3)
        js = JaxSlotSampler(JaxSamplingConfig(**kw), 3)
        for i, row in enumerate(logits):
            assert ts.pick(row, i % 3) == js.pick(row, i % 3)


# Every knob of the reference's engine behaves as the reference's:
# accepted, or refused with the reference's own message (the tp/sp
# layouts without a mesh, collective matmul outside tp; a one-device
# mesh under the replicated layout is accepted).
KNOB_SLICE = 4
ONE_DEVICE_MESH = "one-device mesh"


@pytest.mark.parametrize("knob", [
    dict(layout="tp"), dict(layout="sp"), dict(mesh=ONE_DEVICE_MESH),
    dict(collective_matmul=True), dict(page_size=8), dict(num_pages=4),
    dict(prefill_chunk=4), dict(prefix_cache=True),
    dict(speculative_k=2), dict(compute_dtype="bf16"),
    dict(compute_dtype=torch.bfloat16),
])
def test_out_of_slice_knobs_raise(knob):
    kw = dict(ENGINE_KW, **knob)
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    if kw.get("mesh") == ONE_DEVICE_MESH:
        from distributed_model_parallel_tpu.runtime.mesh import (
            MeshSpec as JaxMeshSpec,
            make_mesh as jax_make_mesh,
        )
        from distributed_model_parallel_tpu_torch.runtime.mesh import (
            MeshSpec as TorchMeshSpec,
            make_mesh as torch_make_mesh,
        )
        jkw["mesh"] = jax_make_mesh(JaxMeshSpec(data=1),
                                    devices=jax.devices()[:1])
        kw["mesh"] = torch_make_mesh(TorchMeshSpec(data=1))
    try:
        jeng = JaxEngine(JaxGPTConfig(**CFG_KW), **jkw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ServingEngine(GPTConfig(**CFG_KW), device="cpu", **kw)
        assert str(got.value) == str(e)
        return
    teng = ServingEngine(GPTConfig(**CFG_KW), device="cpu", **kw)
    assert teng.compute_mode == jeng.compute_mode
    assert (teng.paged_spec is None) == (jeng.paged_spec is None)
    if teng.paged_spec is not None:
        assert teng.paged_spec.num_pages == jeng.paged_spec.num_pages
        assert teng.paged_spec.pages_per_slot == \
            jeng.paged_spec.pages_per_slot
    want = torch.bfloat16 if teng.compute_mode == "bf16" else torch.float32
    assert teng.spec.dtype == want
    assert teng.init_cache()["k"].dtype == want


def test_speculative_run_and_cuda_without_gpu_refused(jax_params):
    eng = ServingEngine(GPTConfig(**CFG_KW), device="cpu", **ENGINE_KW)
    # A draft without speculative_k is refused as the reference refuses
    # it.
    with pytest.raises(ValueError, match="set speculative_k > 0"):
        eng.run({}, [], draft=eng)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(GPTConfig(**CFG_KW), **ENGINE_KW)
    with pytest.raises(ValueError, match="max_len"):
        ServingEngine(GPTConfig(**CFG_KW), device="cpu", max_len=64)
