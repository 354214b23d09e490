"""The port's MoE layer and stacks (`models/moe.py`, the MoE blocks of
`models/gpt.py` and `models/bert.py`, `models/convert.py`) and its
expert-parallel engines at one rank, held against the JAX package.

Sizes: dim 16, FFN 32, E 4, B 2, T 12 for the layer; the GPT of vocab
64, dim 32, 2 layers (block 1 MoE), 4 heads, T 16 and the MoE BERT
classifier at hidden 32 for the stacks and engines. Inputs come from
numpy seeds. Bars: f32 rtol 1e-5 / atol 1e-6; gradients rtol 1e-5 /
atol 1e-5 (for the stacks' gradients, summed over every token and
vocabulary column, 1e-5 of the leaf's largest magnitude); bf16
activations 1e-2 of the largest magnitude.

* The layer's output, aux loss and gradients (hidden states, router,
  experts) against the reference's `moe_feed_forward`: with capacity
  drops and a key mask, top-1, a roomy capacity, every token's first
  choice overflowing, and bf16 activations. The reference's routing
  cases on the port alone: one expert at full capacity is the dense
  FFN, masked tokens claim no slot, an overflowed first choice falls to
  the second. Dropout draws from the layer's own child lane.
* The GPT (one MoE block) and BERT (a dense and a MoE block) stacks
  through `convert`: logits, the aux state and every gradient.
* `ExpertParallelLMEngine` at one rank, gspmd and hierarchical (with and
  without overlap; bit-equal to each other), against the reference
  engine's 3 SGD steps; a state saved by the port resumes in the
  reference engine and the MoE train state crosses both ways through
  `convert`. (`tests/test_torch_port_moe_exchange.py` holds the DP and
  DDP engines on the MoE BERT.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models import layers as JL
from distributed_model_parallel_tpu.models import moe as jmoe
from distributed_model_parallel_tpu.models.bert import (
    BertConfig as JBertConfig,
)
from distributed_model_parallel_tpu.models.bert import (
    bert_for_classification as j_bert,
)
from distributed_model_parallel_tpu.models.gpt import GPTConfig as JGPTConfig
from distributed_model_parallel_tpu.models.gpt import gpt_lm as j_gpt_lm
from distributed_model_parallel_tpu.parallel import data_parallel as jdp
from distributed_model_parallel_tpu.parallel.expert_parallel import (
    ExpertParallelLMEngine as JEPLMEngine,
)
from distributed_model_parallel_tpu.runtime.mesh import MeshSpec as JMeshSpec
from distributed_model_parallel_tpu.runtime.mesh import make_mesh as j_mesh
from distributed_model_parallel_tpu.training import checkpoint as jckpt
from distributed_model_parallel_tpu.training.optim import SGD as JSGD
from distributed_model_parallel_tpu_torch.models import bert as tbert
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import moe
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
    train_state_from_jax,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.models.gpt import (
    GPTConfig,
    gpt_lm_model,
)
from distributed_model_parallel_tpu_torch.parallel.expert_parallel import (
    ExpertParallelLMEngine,
)
from distributed_model_parallel_tpu_torch.training import checkpoint as ckpt
from distributed_model_parallel_tpu_torch.training.optim import SGD
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)
D, H, B, T = 16, 32, 2, 12
LR = {"sgd": 0.1}
GPT = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, ffn_dim=64,
           max_position=16, dropout_rate=0.0, pad_token_id=0,
           num_experts=4, moe_every=2, moe_top_k=2,
           moe_capacity_factor=0.5)
BERT = dict(vocab_size=67, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=16, dropout_rate=0.0,
            num_experts=4, moe_every=2, moe_capacity_factor=0.5)
CLASSES = 3

# name: (experts, top_k, capacity factor, masked, dtype)
LAYER_CASES = {
    "drops_and_mask": (4, 2, 0.5, True, "f32"),
    "top1": (4, 1, 1.0, False, "f32"),
    "roomy": (4, 2, 4.0, True, "f32"),
    "first_choice_overflows": (4, 2, 1.0, True, "f32"),
    "bf16": (4, 2, 0.5, True, "bf16"),
}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _t(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).requires_grad_(
            grad), tree)


def _layer_inputs(name):
    e, _, _, masked, _ = LAYER_CASES[name]
    rng = np.random.RandomState(sorted(LAYER_CASES).index(name))
    params = {"router": {"w": rng.randn(D, e).astype(np.float32)},
              "experts": {
                  "w_in": 0.3 * rng.randn(e, D, H).astype(np.float32),
                  "b_in": 0.1 * rng.randn(e, H).astype(np.float32),
                  "w_out": 0.3 * rng.randn(e, H, D).astype(np.float32),
                  "b_out": 0.1 * rng.randn(e, D).astype(np.float32)}}
    if name == "first_choice_overflows":
        params["router"]["w"][:, 0] += 3.0  # every token prefers expert 0
        h = np.abs(rng.randn(B, T, D)).astype(np.float32)
    else:
        h = rng.randn(B, T, D).astype(np.float32)
    mask = (rng.rand(B, T) > 0.25) if masked else None
    cot = rng.randn(B, T, D).astype(np.float32)
    return params, h, mask, cot


def _jax_layer(name):
    """(out, aux, grads of sum(out * cot) + aux wrt (params, h))."""
    e, k, cf, _, dtype = LAYER_CASES[name]
    params, h, mask, cot = _layer_inputs(name)
    layer = jmoe.moe_feed_forward(D, H, e, top_k=k, capacity_factor=cf)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    m = None if mask is None else jnp.asarray(mask)

    def f(p, x):
        (y, _), st = layer.apply(p, {}, (x.astype(jdt), m), JL.Context())
        y = y.astype(jnp.float32)
        return jnp.sum(y * cot) + st["moe_aux"], (y, st["moe_aux"])

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(h))
    return np.asarray(y), float(aux), _np(grads)


def _port_layer(name, ctx=None):
    e, k, cf, _, dtype = LAYER_CASES[name]
    params, h, mask, cot = _layer_inputs(name)
    tp, th = _t(params, True), _t(h, True)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    m = None if mask is None else torch.from_numpy(mask)
    (y, _), st = moe.moe_feed_forward(
        tp, (th.to(tdt), m), ctx or L.Context(), num_experts=e, top_k=k,
        capacity_factor=cf)
    y = y.float()
    ((y * torch.from_numpy(cot)).sum() + st["moe_aux"]).backward()
    grads = (jax.tree.map(lambda t: t.grad.numpy(), tp), th.grad.numpy())
    return y.detach().numpy(), float(st["moe_aux"].detach()), grads


def _close(got, want, budget=None, scaled=False, **tol):
    """Leaf by leaf; `budget` is relative to the leaf's largest magnitude,
    and so is atol when `scaled` (gradients summed over every token)."""
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
        if scaled:
            tol = dict(tol, atol=tol["atol"] * max(np.abs(w).max(), 1.0))
        if budget is None:
            np.testing.assert_allclose(
                g, w, err_msg=jax.tree_util.keystr(path), **tol)
        else:
            np.testing.assert_allclose(
                g, w, rtol=budget, atol=budget * max(np.abs(w).max(), 1e-6),
                err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_reference(name):
    want_y, want_aux, want_g = _jax_layer(name)
    got_y, got_aux, got_g = _port_layer(name)
    budget = 1e-2 if LAYER_CASES[name][4] == "bf16" else None
    _close(got_y, want_y, budget, **F32)
    np.testing.assert_allclose(got_aux, want_aux, rtol=budget or 1e-5)
    _close(got_g, want_g, budget, **GRAD)


def _route(h, w, e, k, cap, mask=None):
    return moe.route(torch.as_tensor(h), mask, torch.as_tensor(w), e, k,
                     cap)


def test_routing_cases_of_the_reference():
    """One expert at full capacity is the dense FFN on the valid tokens
    (masked rows zero); a drop leaves a zero row; an overflowed first
    choice falls to the genuine second choice; masked tokens claim no
    slot (removing them leaves the kept tokens' outputs unchanged)."""
    params, h, mask, _ = _layer_inputs("roomy")
    tp = _t(params)
    one = {"router": {"w": tp["router"]["w"][:, :1]},
           "experts": {n: v[:1] for n, v in tp["experts"].items()}}
    m = torch.from_numpy(mask)
    (y, _), _ = moe.moe_feed_forward(one, (torch.from_numpy(h), m),
                                     L.Context(), num_experts=1, top_k=1,
                                     capacity_factor=1.0)
    dense = moe.expert_ffn(one["experts"], torch.from_numpy(h)[None])[0]
    np.testing.assert_allclose(y[m].numpy(), dense[m].numpy(), **F32)
    assert (y[~m] == 0).all()

    # B 1, T 3, E 3, cap 1: tokens 0 and 1 prefer A then B, token 2 A then
    # C. Round 1 keeps token 0 on A; round 2 token 0 on B, token 1 loses
    # B, token 2 falls to C.
    logits = np.array([[3.0, 2.0, 0.0], [3.0, 2.0, 0.0], [3.0, 0.0, 2.0]],
                      np.float32)
    _, chosen, top1 = _route(np.eye(3, dtype=np.float32)[None], logits, 3,
                             2, 1)
    kept = sum(c[1] for c in chosen)[0].numpy()
    np.testing.assert_array_equal(kept, [[1, 1, 0], [0, 0, 0], [0, 0, 1]])
    np.testing.assert_array_equal(top1[0].numpy().argmax(-1), [0, 0, 0])

    # masked column 3 claims no slot: the other tokens' outputs equal
    # those of the sequence without it
    keep = [i for i in range(T) if i != 3]
    cols = torch.ones(B, T, dtype=torch.bool)
    cols[:, 3] = False
    kw = dict(num_experts=4, top_k=2, capacity_factor=4.0)
    (ym, _), _ = moe.moe_feed_forward(tp, (torch.from_numpy(h), cols),
                                      L.Context(), **kw)
    (yr, _), _ = moe.moe_feed_forward(tp, (torch.from_numpy(h[:, keep]),
                                           None), L.Context(), **kw)
    np.testing.assert_allclose(ym[:, keep].numpy(), yr.numpy(), **F32)
    assert (ym[:, 3] == 0).all()


def test_dropout_draws_from_the_layers_own_child_lane():
    ctx = L.Context(train=True, rng=L.fold_in(L.root_key(0), 7))
    params, h, mask, _ = _layer_inputs("drops_and_mask")
    tp, th, m = _t(params), torch.from_numpy(h), torch.from_numpy(mask)
    kw = dict(num_experts=4, top_k=2, capacity_factor=0.5)
    (plain, _), _ = moe.moe_feed_forward(tp, (th, m), ctx, **kw)
    (dropped, _), _ = moe.moe_feed_forward(tp, (th, m), ctx,
                                           dropout_rate=0.5, **kw)
    want = L.dropout(plain, 0.5, ctx.child(1))
    assert torch.equal(dropped, want)
    assert not torch.equal(dropped, L.dropout(plain, 0.5, ctx))


def _gpt_ids(n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ids = rng.randint(1, 64, size=(4, 16)).astype(np.int32)
        ids[i % 4, -4:] = 0
        out.append(ids)
    return out


def _bert_batches(n=3):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        ids = rng.randint(1, 67, size=(4, 16)).astype(np.int32)
        ids[:, -3:] = 0
        out.append((ids, rng.randint(0, CLASSES, 4).astype(np.int32)))
    return out


def _stack_grads(model, params, state, x, cot, ctx):
    """Logits, the kept aux values and the gradients of sum(logits * cot)
    + aux (reference model)."""

    def f(p):
        y, st = model.apply(p, state, x, ctx)
        return jnp.sum(y * cot) + jdp.aux_loss(st), (y, st)

    (_, (y, st)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return np.asarray(y), _np(st), _np(g)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_moe_stacks_match_reference_through_convert(family):
    if family == "gpt":  # one MoE block: the stem, the block, the head
        cfg = dict(GPT, num_layers=1, moe_every=1)
        jmodel = j_gpt_lm(JGPTConfig(**cfg))
        model = gpt_lm_model(GPTConfig(**cfg))
        x = _gpt_ids(1)[0]
        bridge = {}
    else:
        jmodel = j_bert(CLASSES, JBertConfig(**BERT))
        model = tbert.bert_for_classification(CLASSES,
                                              tbert.BertConfig(**BERT))
        x = _bert_batches(1)[0][0]
        bridge = {"model": model}
    p, s = jmodel.init(jax.random.PRNGKey(2))
    p, s = _np(p), _np(s)
    y0 = jax.eval_shape(lambda q: jmodel.apply(q, s, jnp.asarray(x),
                                               JL.Context())[0], p)
    cot = np.random.RandomState(3).randn(*y0.shape).astype(np.float32)
    want_y, want_st, want_g = _stack_grads(jmodel, p, s, jnp.asarray(x), cot,
                                           JL.Context())
    if family == "gpt":
        params, state = from_jax_params(p), jax.tree.map(torch.tensor, s)
    else:
        params, state = from_jax_params(p, model=model, state=s)
    for t in jax.tree_util.tree_leaves(params):
        t.requires_grad_(True)
    y, st = model.apply(params, state, torch.from_numpy(x).long(),
                        L.Context())
    ((y * torch.from_numpy(cot)).sum() + L.aux_loss(st)).backward()
    _close(y.detach().numpy(), want_y, **F32)
    _close(jax.tree.map(lambda t: t.detach().numpy(), st), want_st, **F32)
    grads = jax.tree.map(lambda t: t.grad, params)
    got_g = (to_jax_params(grads) if family == "gpt"
             else to_jax_params(grads, **bridge))
    _close(got_g, want_g, scaled=True, **GRAD)
    assert np.isfinite(L.aux_loss(st).item()) and L.aux_loss(st).item() > 0


def _jax_ep(opt, dispatch="gspmd"):
    mesh = j_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    return JEPLMEngine(j_gpt_lm(JGPTConfig(**GPT)), JSGD(0.9, 1e-2), mesh,
                       dispatch=dispatch, pad_token_id=0, donate=False)


def _jax_steps(eng, ts, batches, lr):
    sums = []
    for ids in batches:
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), jnp.float32(lr))
        sums.append({k: float(v) for k, v in m.items()})
    return ts, sums


def _port_ep(opt, dispatch="gspmd", overlap=False):
    return ExpertParallelLMEngine(
        gpt_lm_model(GPTConfig(**GPT)), SGD(0.9, 1e-2), device="cpu",
        dispatch=dispatch, overlap=overlap, pad_token_id=0)


def _port_steps(eng, ts, batches, lr):
    sums = []
    for ids in batches:
        ts, m = eng.train_step(ts, *eng.shard_batch(ids), lr)
        sums.append({k: float(v) for k, v in m.items()})
    return ts, sums


def _tree(jts):
    return _np({"params": jts.params, "model_state": jts.model_state,
                "opt_state": jts.opt_state._asdict(), "step": jts.step})


@pytest.fixture(scope="module")
def ep_runs():
    """The reference's start and 3-step SGD run, and the port's gspmd,
    hierarchical and hierarchical-overlapped runs from it."""
    out = {}
    for opt in ("sgd",):
        jeng = _jax_ep(opt)
        jts0 = jeng.init_state(jax.random.PRNGKey(0))
        start = _tree(jeng.to_canonical(jts0))
        jts, jsums = _jax_steps(jeng, jts0, _gpt_ids(), LR[opt])
        runs = {}
        for dispatch, overlap in (("gspmd", False), ("hierarchical", False),
                                  ("hierarchical", True)):
            eng = _port_ep(opt, dispatch, overlap)
            ts = eng.from_canonical(start)
            ts, sums = _port_steps(eng, ts, _gpt_ids(), LR[opt])
            runs[dispatch, overlap] = (sums, eng.to_canonical(ts))
        out[opt] = {"want": (jsums, _tree(jeng.to_canonical(jts))),
                    "port": runs, "start": start}
    return out


@pytest.mark.parametrize("opt", ["sgd"])
def test_ep_engines_match_reference_at_one_rank(ep_runs, opt):
    jsums, jtree = ep_runs[opt]["want"]
    for (dispatch, overlap), (sums, tree) in ep_runs[opt]["port"].items():
        for g, w in zip(sums, jsums):
            assert g["count"] == w["count"]
            assert g["correct1"] == w["correct1"]
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                       rtol=1e-5)
        _close(tree["params"], jtree["params"], **F32)
        _close(tree["opt_state"], jtree["opt_state"], **F32)
        _close(tree["model_state"], jtree["model_state"], **F32)


def test_hierarchical_at_one_rank_is_bit_equal_to_gspmd(ep_runs):
    for opt in ep_runs:
        runs = ep_runs[opt]["port"]
        want = runs["gspmd", False]
        for key in (("hierarchical", False), ("hierarchical", True)):
            assert runs[key][0] == want[0]
            for a, b in zip(jax.tree_util.tree_leaves(runs[key][1]),
                            jax.tree_util.tree_leaves(want[1])):
                np.testing.assert_array_equal(a, b)


def test_port_ep_state_resumes_in_the_reference_engine(ep_runs, tmp_path):
    """The port's state after 2 steps, saved in the legacy format, resumes
    in the reference engine; its third step equals the straight run. The
    reference's start crossed the other way in the fixture."""
    start = ep_runs["sgd"]["start"]
    eng = _port_ep("sgd", "hierarchical")
    ts, _ = _port_steps(eng, eng.from_canonical(start), _gpt_ids()[:2],
                        LR["sgd"])
    ckpt.save_checkpoint(str(tmp_path), eng.to_canonical(ts), acc=0.0,
                         epoch=0)
    jeng = _jax_ep("sgd")
    like = jeng.to_canonical(jeng.init_state(jax.random.PRNGKey(5)))
    restored, _, _ = jckpt.restore_checkpoint(str(tmp_path), like)
    jts, sums = _jax_steps(jeng, jeng.from_canonical(restored),
                           _gpt_ids()[2:], LR["sgd"])
    np.testing.assert_allclose(sums[0]["loss_sum"],
                               ep_runs["sgd"]["want"][0][2]["loss_sum"],
                               rtol=1e-5)
    _close(_tree(jeng.to_canonical(jts))["params"],
           ep_runs["sgd"]["want"][1]["params"], **F32)
    # the MoE train state crosses both ways through convert, aux included
    back = train_state_to_jax(train_state_from_jax(
        eng.to_canonical(ts), eng._full_like(eng.init_state())))
    _close(back, eng.to_canonical(ts), rtol=0, atol=0)
    assert "moe_aux" in back["model_state"]["blocks"]["1"]["moe"]
