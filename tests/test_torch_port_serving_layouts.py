"""The PyTorch port's tp and sp serving layouts held against the JAX
reference's engine with the SAME layout on its 8-device CPU mesh.

The reference's serving test model (tests/test_serving.py: vocab 61, dim
16, 2 layers, 4 heads, ffn 32; 4 slots, max_len 16, prefill 8) is
initialized by the JAX package; both engines run one teacher-forced
script: a ragged prefill of three slots, mixed-position decode steps
(one slot idle for a step), slot 0 recycled onto its stale cache tail,
two more steps (and, for the speculative case, a verify step of k + 1 =
3 tokens a slot). The port runs on gloo ranks (`tests/_torch_port_
ranks.serving_layouts`, one process a rank, MeshSpec(data=1, model=M) or
(seq=S)); every rank must hold the same logits. The paged cases (sp
paged, tp speculative) are held against the reference's contiguous
engine of the same layout (`jax_script`): the reference's paged steps
on its CPU mesh give other live logits from run to run under load.

Tolerances (those of tests/test_torch_port_serving.py):
* f32 — rtol/atol 1e-5 on every prefill and decode logit row of the
  live slots: the reference's own cache-vs-recompute bar; sums run in
  another order in the two frameworks (and over gloo), nothing else
  differs.
* int8 — rtol 1e-5, atol 5e-3, greedy tokens identical: one activation
  code tipped across a round-half tie by an f32 ulp upstream moves a
  projection by up to max|x| max|w| / 127. Declarative tp quantizes each
  row with the whole row's absmax (the reference's partitioner keeps the
  unsharded semantics); the rings quantize each chunk of a row-parallel
  block with its local scales, as the reference's shard_map does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_model_parallel_tpu.cli import common as jax_common
from distributed_model_parallel_tpu.models.gpt import (
    GPTConfig as JaxGPTConfig,
    gpt_lm,
)
from distributed_model_parallel_tpu.runtime.mesh import (
    MeshSpec as JaxMeshSpec,
    make_mesh as jax_make_mesh,
)
from distributed_model_parallel_tpu.serving.decode import (
    decode_ring_permutes as jax_decode_ring_permutes,
)
from distributed_model_parallel_tpu.serving.engine import (
    ServingEngine as JaxEngine,
)
from distributed_model_parallel_tpu.serving.scheduler import (
    Request as JaxRequest,
)
from distributed_model_parallel_tpu_torch.cli import serve
from distributed_model_parallel_tpu_torch.cli.common import (
    check_serving_args,
)
from distributed_model_parallel_tpu_torch.serving.decode import (
    decode_ring_permutes,
)

from tests._torch_port_ranks import spawn

CFG_KW = dict(vocab_size=61, dim=16, num_layers=2, num_heads=4, ffn_dim=32,
              max_position=16, dropout_rate=0.0)
ENGINE_KW = dict(num_slots=4, max_len=16, prefill_len=8)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-5, atol=5e-3)
SPEC_K = 2

# (name, engine kwargs, script options) a layout runs.
TP_CASES = {
    "f32": dict(),
    "f32_cm": dict(collective_matmul=True),
    "int8": dict(compute_dtype="int8"),
    "int8_cm": dict(compute_dtype="int8", collective_matmul=True),
    "verify_cm": dict(collective_matmul=True, page_size=4,
                      speculative_k=SPEC_K),
}
TP4_CASES = ("f32", "f32_cm")
SP_CASES = {"f32": dict(), "f32_paged": dict(page_size=4)}


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG_KW["vocab_size"], size=n).astype(np.int32)
            for n in lens]


def script(paged: bool, verify: bool) -> list:
    """The teacher-forced script both engines run (module doc)."""
    rng = np.random.RandomState(5)
    n = ENGINE_KW["num_slots"]
    live = np.array([True, True, True, False])

    def decode(active):
        return ("decode", rng.randint(1, CFG_KW["vocab_size"], n).astype(
            np.int32), active.copy())

    ops = [("prefill", s, p) for s, p in enumerate(_prompts(0, (3, 5, 2)))]
    ops += [decode(live) for _ in range(3)]
    ops.append(decode(np.array([True, True, False, False])))
    if paged:
        ops.append(("release", 0))
    ops.append(("prefill", 0, _prompts(9, (2,))[0]))
    ops += [decode(live) for _ in range(2)]
    if verify:
        ops.append(("verify", rng.randint(
            1, CFG_KW["vocab_size"], (n, SPEC_K + 1)).astype(np.int32),
            live.copy()))
        ops.append(decode(live))
    return ops


def jax_script(eng, params, ops) -> list:
    """`run_serving_script` of tests/_torch_port_ranks.py on the
    reference's CONTIGUOUS engine of the same layout: a paged script's
    page releases are no-ops there, and its verify step is its k + 1
    decode steps, one token of the span each (the logits a verify row
    must reproduce). The reference's paged steps are not used: on its
    CPU mesh they return other live logits from run to run under load
    (up to 0.2 apart, tp and sp alike), and the paged and contiguous
    layouts are logit-identical by the reference's own pins."""
    cache = eng.init_cache()
    out = []
    for op, *args in ops:
        if op == "release":
            continue
        if op == "prefill":
            slot, prompt = args
            ids, length = eng.pad_prompt(prompt)
            cache, logits = eng.prefill(params, cache, ids, length,
                                        jnp.int32(slot))
        else:
            tokens, active = args
            rows = []
            for column in (tokens.T if op == "verify" else [tokens]):
                cache, row = eng.decode_step(params, cache,
                                             jnp.asarray(column),
                                             jnp.asarray(active))
                rows.append(np.asarray(row, np.float32))
            logits = np.stack(rows, axis=1) if op == "verify" else rows[0]
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.fixture(scope="module")
def weights():
    params, _ = gpt_lm(JaxGPTConfig(**CFG_KW)).init(jax.random.PRNGKey(0))
    draft, _ = gpt_lm(JaxGPTConfig(**dict(CFG_KW, num_layers=1))).init(
        jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, draft)


def _ops(kw):
    return script(paged="page_size" in kw, verify="speculative_k" in kw)


SPEC_REQUESTS = [(p, 5) for p in _prompts(3, (3, 6, 2, 5, 4))]


def _port(layout, world, cases, weights, tmp_path_factory, runs=()):
    params, draft = weights
    payload = {"layout": layout, "cfg": CFG_KW, "params": params,
               "draft_params": draft,
               "cases": [(name, dict(ENGINE_KW, **kw), _ops(kw))
                         for name, kw in cases.items()],
               "runs": [(name, dict(ENGINE_KW, **kw), SPEC_REQUESTS)
                        for name, kw in runs]}
    return spawn(world, "serving_layouts", payload,
                 tmp_path_factory.mktemp(f"{layout}{world}"))


@pytest.fixture(scope="module")
def tp2(weights, tmp_path_factory):
    return _port("tp", 2, TP_CASES, weights, tmp_path_factory,
                 runs=[("spec_cm", TP_CASES["verify_cm"])])


@pytest.fixture(scope="module")
def tp4(weights, tmp_path_factory):
    return _port("tp", 4, {k: TP_CASES[k] for k in TP4_CASES}, weights,
                 tmp_path_factory)


@pytest.fixture(scope="module")
def sp(weights, tmp_path_factory):
    return {s: _port("sp", s, SP_CASES, weights, tmp_path_factory)
            for s in (2, 4)}


def _jax_engine(layout, size, kw, cfg_kw=CFG_KW):
    axis = "model" if layout == "tp" else "seq"
    mesh = jax_make_mesh(JaxMeshSpec(data=1, **{axis: size}),
                         devices=jax.devices()[:size])
    return JaxEngine(JaxGPTConfig(**cfg_kw), mesh, layout=layout,
                     **dict(ENGINE_KW, **kw))


def _contiguous(kw):
    return {k: v for k, v in kw.items()
            if k not in ("page_size", "speculative_k")}


def _hold(ranks, layout, size, name, kw, weights):
    """Every rank's logits equal rank 0's bit for bit, and rank 0's match
    the reference engine's with the same layout (contiguous: see
    `jax_script`), row by live row."""
    eng = _jax_engine(layout, size, _contiguous(kw))
    want = jax_script(eng, eng.place_params(
        jax.tree.map(jnp.asarray, weights[0])), _ops(kw))
    got = ranks[0]["logits"][name]
    for other in ranks[1:]:
        for a, b in zip(got, other["logits"][name]):
            np.testing.assert_array_equal(a, b)
    tol = INT8_TOL if kw.get("compute_dtype") == "int8" else F32_TOL
    steps = [op for op in _ops(kw) if op[0] != "release"]
    assert len(got) == len(want) == len(steps)
    for (op, *args), g, w in zip(steps, got, want):
        if op != "prefill":
            g, w = g[args[-1]], w[args[-1]]  # the live slots
        np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_m2_logits_match_reference(tp2, weights, name):
    _hold(tp2, "tp", 2, name, TP_CASES[name], weights)


@pytest.mark.parametrize("name", TP4_CASES)
def test_tp_m4_logits_match_reference(tp4, weights, name):
    _hold(tp4, "tp", 4, name, TP_CASES[name], weights)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(SP_CASES))
def test_sp_logits_match_reference(sp, weights, size, name):
    _hold(sp[size], "sp", size, name, SP_CASES[name], weights)


@pytest.mark.parametrize("size", [2, 4])
def test_decode_rings_issue_s_minus_1_hops_a_projection(tp2, tp4, size):
    """The rings' hops: 4 L (S - 1) a decode step AND a verify step (its
    k + 1 tokens a slot ride the decode rings), none without the rings
    or in prefill; the count is the reference's `serve-decode-ring`
    pin."""
    ranks = {2: tp2, 4: tp4}[size]
    per_step = decode_ring_permutes(CFG_KW["num_layers"], size)
    assert per_step == jax_decode_ring_permutes(CFG_KW["num_layers"], size)
    for name in ("f32_cm",) + (("int8_cm", "verify_cm") if size == 2
                               else ()):
        kw = TP_CASES[name]
        steps = sum(op[0] in ("decode", "verify") for op in _ops(kw))
        for r in ranks:
            assert r["hops"][name] == per_step * steps
    for r in ranks:
        assert r["hops"]["f32"] == 0


def test_tp_placement_equals_replicated_then_split(tp2, tp4):
    """A tree placed into tp equals one placed replicated and then split
    by the tensor-parallel engine's Megatron rules, on every rank."""
    assert all(r["placed_equals_split"] for r in tp2 + tp4)


def test_speculative_under_tp_rings_matches_reference(tp2, weights):
    """Speculative decoding (k 2, a 1-layer draft mirroring the layout)
    under tp M 2 with the rings, through `run`: every rank generates,
    request by request, the greedy tokens of the reference's engine with
    the same layout decoding without speculation (greedy acceptance is
    lossless; the reference's paged steps are not used, `jax_script`)."""
    params, _ = weights
    eng = _jax_engine("tp", 2, _contiguous(TP_CASES["verify_cm"]))
    sched = eng.run(
        eng.place_params(jax.tree.map(jnp.asarray, params)),
        [JaxRequest(rid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(SPEC_REQUESTS)])
    want = {f.rid: list(f.tokens) for f in sched.finished}
    for r in tp2:
        assert r["runs"]["spec_cm"] == want


LAYOUT_ARGV = [
    ["--layout", "tp"],
    ["--layout", "tp", "--model-shards", "2", "--seq-shards", "2"],
    ["--layout", "sp"],
    ["--layout", "sp", "--seq-shards", "2", "--model-shards", "2"],
    ["--model-shards", "2"],
    ["--collective-matmul"],
    ["--layout", "sp", "--seq-shards", "2", "--collective-matmul"],
    ["--layout", "sp", "--seq-shards", "2", "--compute-dtype", "int8"],
    ["--layout", "sp", "--seq-shards", "4", "--page-size", "6",
     "--max-len", "24"],
    ["--layout", "sp", "--seq-shards", "2", "--page-size", "4",
     "--prefill-chunk", "4"],
    ["--layout", "sp", "--seq-shards", "2", "--page-size", "4",
     "--prefill-chunk", "4", "--prefix-cache"],
    ["--layout", "sp", "--seq-shards", "2", "--page-size", "4",
     "--speculative-k", "2"],
    ["--layout", "tp", "--model-shards", "2", "--collective-matmul",
     "--compute-dtype", "int8"],
]


@pytest.mark.parametrize("argv", LAYOUT_ARGV,
                         ids=[" ".join(a) for a in LAYOUT_ARGV])
def test_cli_layout_checks_match_reference(argv):
    """`check_serving_args` refuses exactly what the reference's does,
    with its message; what it accepts, the reference accepts."""
    from distributed_model_parallel_tpu.cli import serve as jax_serve

    jargs = jax_serve.build_parser().parse_args(argv)
    targs = serve.build_parser().parse_args(argv)
    try:
        jax_common.check_serving_args(jargs)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            check_serving_args(targs)
        assert str(got.value) == str(e)
        return
    check_serving_args(targs)


ENGINE_REFUSALS = [
    ("sp", dict(compute_dtype="int8")),
    ("sp", dict(page_size=4, prefill_chunk=4)),
    ("sp", dict(page_size=4, prefill_chunk=4, prefix_cache=True)),
    ("sp", dict(page_size=4, speculative_k=2)),
    ("sp", dict(collective_matmul=True)),
    ("sp", dict(prefill_len=7)),
    ("sp", dict(max_len=15)),
    ("sp", dict(page_size=3, max_len=12, prefill_len=6)),
    ("tp", dict(num_slots=3)),
]


@pytest.mark.parametrize("layout,kw", ENGINE_REFUSALS)
def test_engine_layout_refusals_match_reference(layout, kw):
    """The engine's tp/sp checks raise the reference's ValueError, word
    for word (a world-1 mesh over the reference's 2-device one: the
    checks read the mesh's axis sizes; the port's mesh is built with the
    size the reference's has)."""
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )

    with pytest.raises(ValueError) as want:
        _jax_engine(layout, 2, kw)
    axis = "model" if layout == "tp" else "seq"
    mesh = Mesh(1, None, **{axis: 2})
    with pytest.raises(ValueError) as got:
        ServingEngine(GPTConfig(**CFG_KW), mesh=mesh, layout=layout,
                      device="cpu", **dict(ENGINE_KW, **kw))
    assert str(got.value) == str(want.value)


def test_layout_without_mesh_and_cm_below_two_shards_refused():
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )

    for layout in ("tp", "sp"):
        with pytest.raises(ValueError, match=f"layout '{layout}' needs a "
                                             "mesh"):
            ServingEngine(GPTConfig(**CFG_KW), layout=layout, device="cpu",
                          **ENGINE_KW)
    with pytest.raises(ValueError) as want:
        _jax_engine("tp", 1, dict(collective_matmul=True))
    with pytest.raises(ValueError) as got:
        ServingEngine(GPTConfig(**CFG_KW), mesh=Mesh(1, None),
                      layout="tp", collective_matmul=True, device="cpu",
                      **ENGINE_KW)
    assert str(got.value) == str(want.value)
