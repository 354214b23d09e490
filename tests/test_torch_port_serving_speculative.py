"""The PyTorch port's speculative decoding (`serving/speculative.py`)
held against the JAX reference's, on the CPU.

The target is a small GPT (2 layers, dim 64, 4 heads, vocab 97, 32
positions) and the draft a 1-layer one, each with weights from a numpy
seed carried across by `models/convert.from_jax_params`. The pool's
2-token pages make a k-token verify round cross page boundaries, so
rejected suffixes free whole pages on rollback.

* Greedy speculative output EQUALS the port's plain greedy output and
  the reference's speculative output, for k = 2 and k = 4; the
  `speculative` report, the pages each rollback frees and the paged
  statistics equal the reference's.
* `greedy_verify` and `rejection_verify` are pure numpy over the same
  Philox lanes: bit-equal to the reference's on the same inputs; the
  first emitted token's marginal is the target distribution (the
  reference's statistical check, atol 0.03 over 4000 lanes).
* int8: the verify step's logits at the port's contiguous int8 bar
  (rtol 1e-5, atol 5e-3, tests/test_torch_port_serving.py), and the
  speculative int8 run's tokens equal the reference's and the port's
  plain int8 run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_port_serving_paged import numpy_params

from distributed_model_parallel_tpu.cli import serve as jax_serve
from distributed_model_parallel_tpu.models.gpt import (
    GPTConfig as JaxGPTConfig,
)
from distributed_model_parallel_tpu.serving import speculative as jspec
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
from distributed_model_parallel_tpu_torch.cli import serve
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
from distributed_model_parallel_tpu_torch.serving import speculative as tspec
from distributed_model_parallel_tpu_torch.serving.engine import (
    ServingEngine,
)
from distributed_model_parallel_tpu_torch.serving.sampling import (
    SamplingConfig,
    SlotSampler,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import Request
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    save_checkpoint,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

CFG_KW = dict(vocab_size=97, dim=64, num_layers=2, num_heads=4,
              ffn_dim=256, max_position=32, dropout_rate=0.0,
              pad_token_id=0)
DRAFT_KW = dict(CFG_KW, num_layers=1)
ENGINE_KW = dict(num_slots=4, max_len=32, prefill_len=8, page_size=2,
                 prefill_chunk=4)
INT8_TOL = dict(rtol=1e-5, atol=5e-3)


@pytest.fixture(scope="module")
def weights():
    return numpy_params(0, CFG_KW), numpy_params(7, DRAFT_KW)


def _requests(n=6, seed=0, max_new=5, cls=Request):
    """Ragged prompts, more requests than slots: slots recycle mid-run."""
    rng = np.random.RandomState(seed)
    return [cls(i, rng.randint(1, CFG_KW["vocab_size"],
                               size=int(rng.randint(2, 8))).astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _freed_ledger(eng):
    """Record how many pool pages each `truncate` of the engine's future
    hosts returns."""
    freed = []
    new_host = eng.new_host

    def instrumented():
        host = new_host()
        truncate = host.truncate

        def recorded(slot, n_tokens):
            before = host.pool.pages_in_use
            truncate(slot, n_tokens)
            freed.append(before - host.pool.pages_in_use)

        host.truncate = recorded
        return host

    eng.new_host = instrumented
    return freed


def _port(weights, k, mode="f32", **kw):
    """(target, plain twin, draft, params, draft params) of the port."""
    target_w, draft_w = weights
    ekw = dict(ENGINE_KW, compute_dtype=mode, device="cpu", **kw)
    target = ServingEngine(GPTConfig(**CFG_KW), speculative_k=k, **ekw)
    plain = ServingEngine(GPTConfig(**CFG_KW), **ekw)
    dkw = {key: v for key, v in ekw.items() if key != "prefix_cache"}
    draft = ServingEngine(GPTConfig(**DRAFT_KW), **dkw)
    return (target, plain, draft,
            target.place_params(from_jax_params(target_w)),
            draft.place_params(from_jax_params(draft_w)))


def _reference(weights, k, mode="f32", **kw):
    target_w, draft_w = weights
    ekw = dict(ENGINE_KW, compute_dtype=mode, **kw)
    target = JaxEngine(JaxGPTConfig(**CFG_KW), speculative_k=k, **ekw)
    dkw = {key: v for key, v in ekw.items() if key != "prefix_cache"}
    draft = JaxEngine(JaxGPTConfig(**DRAFT_KW), **dkw)
    return (target, draft,
            target.place_params(jax.tree.map(jnp.asarray, target_w)),
            draft.place_params(jax.tree.map(jnp.asarray, draft_w)))


def _tokens(sched):
    return {f.rid: f.tokens for f in sched.finished}


@pytest.fixture(scope="module", params=[2, 4])
def spec_runs(request, weights):
    """One speculative and one plain port run and the reference's
    speculative run on the same requests, with every rollback's freed
    pages recorded on both packages' target and draft hosts."""
    k = request.param
    target, plain, draft, p, dp = _port(weights, k)
    jtarget, jdraft, jp, jdp = _reference(weights, k)
    freed = {name: _freed_ledger(eng) for name, eng in (
        ("port", target), ("port_draft", draft), ("jax", jtarget),
        ("jax_draft", jdraft))}
    sched = target.run(p, _requests(), draft=draft, draft_params=dp)
    jsched = jtarget.run(jp, _requests(cls=JaxRequest), draft=jdraft,
                         draft_params=jdp)
    return {"k": k, "sched": sched, "jsched": jsched,
            "plain": plain.run(p, _requests()), "freed": freed}


def test_spec_greedy_equals_plain_and_reference(spec_runs):
    r = spec_runs
    assert len(r["sched"].finished) == 6
    assert _tokens(r["sched"]) == _tokens(r["plain"]) == \
        _tokens(r["jsched"])
    rep, jrep = (s.latency_report() for s in (r["sched"], r["jsched"]))
    assert rep["speculative"] == jrep["speculative"]
    assert rep["speculative"]["k"] == r["k"]
    # Every token but each request's first came from a verify round.
    assert rep["speculative"]["spec_tokens"] == sum(
        len(t) for t in _tokens(r["sched"]).values()) - 6
    for key in ("decode_steps", "engine_iterations", "generated_tokens"):
        assert rep[key] == jrep[key], key


def test_rollback_returns_pages_as_the_reference(spec_runs):
    """The random draft is rejected, rollbacks free whole pages on both
    caches, and every truncate frees what the reference's frees; the
    pool statistics equal the reference's."""
    r = spec_runs
    freed = r["freed"]
    assert r["sched"].latency_report()["speculative"]["accept_rate"] < 1
    assert freed["port"] == freed["jax"] and max(freed["port"]) > 0
    assert freed["port_draft"] == freed["jax_draft"]
    assert max(freed["port_draft"]) > 0
    assert r["sched"].latency_report()["paged"] == \
        r["jsched"].latency_report()["paged"]


def _identity_surgery(target_w, draft_w):
    """Target block 1 made the identity (its residual branches zeroed,
    its LayerNorms and block 0's last one unit-affine, so it normalizes
    an already normalized stream); the draft holds the target's stem,
    block 0 and head, so its logits are the target's."""
    tw = jax.tree.map(np.copy, target_w)
    unit = {"scale": np.ones(CFG_KW["dim"], np.float32),
            "bias": np.zeros(CFG_KW["dim"], np.float32)}
    tw["blocks"]["0"]["ln2"] = dict(unit)
    for branch in ("attn", "ffn"):
        out = tw["blocks"]["1"][branch]["out"]
        out["w"] = np.zeros_like(out["w"])
        out["b"] = np.zeros_like(out["b"])
    tw["blocks"]["1"]["ln1"] = dict(unit)
    tw["blocks"]["1"]["ln2"] = dict(unit)
    dw = jax.tree.map(np.copy, draft_w)
    dw["stem"], dw["head"] = tw["stem"], tw["head"]
    dw["blocks"]["0"] = tw["blocks"]["0"]
    return tw, dw


def test_exact_prefix_draft_accepts_everything(weights):
    k = 2
    tw, dw = _identity_surgery(*weights)
    target, plain, draft, p, dp = _port((tw, dw), k)
    sched = target.run(p, _requests(), draft=draft, draft_params=dp)
    assert _tokens(sched) == _tokens(plain.run(p, _requests()))
    rep = sched.latency_report()["speculative"]
    assert rep["accept_rate"] == 1.0
    assert rep["mean_accept_len"] == k + 1


def test_spec_with_target_prefix_cache_hits_and_equals_plain(weights):
    """Two slots, so the later identical prompts arrive after the first
    wave published its pages: the target's prefix cache hits, the draft
    ingests every prompt itself, and the tokens equal the plain run's
    and the reference's."""
    kw = dict(prefix_cache=True, num_slots=2)
    target, plain, draft, p, dp = _port(weights, 2, **kw)
    prompt = np.arange(1, 7, dtype=np.int32)
    reqs = [Request(i, prompt, max_new_tokens=4) for i in range(4)]
    sched = target.run(p, reqs, draft=draft, draft_params=dp)
    assert sched.latency_report()["prefix_cache"]["hits"] > 0
    assert _tokens(sched) == _tokens(plain.run(p, reqs))
    jtarget, jdraft, jp, jdp = _reference(weights, 2, **kw)
    jsched = jtarget.run(jp, [JaxRequest(i, prompt, max_new_tokens=4)
                              for i in range(4)],
                         draft=jdraft, draft_params=jdp)
    assert _tokens(sched) == _tokens(jsched)
    assert sched.latency_report()["prefix_cache"] == \
        jsched.latency_report()["prefix_cache"]


@pytest.mark.parametrize("seed", range(8))
def test_greedy_verify_bit_equal_to_reference(seed):
    rng = np.random.RandomState(seed)
    k = 1 + seed % 4
    rows = rng.randn(k + 1, 9)
    # Proposals that match the argmaxes up to a seeded point.
    proposals = rows[:k].argmax(-1)
    cut = seed % (k + 1)
    if cut < k:
        proposals[cut] = (proposals[cut] + 1) % 9
    assert tspec.greedy_verify(rows, proposals) == \
        jspec.greedy_verify(rows, proposals)


@pytest.mark.parametrize("seed", range(8))
def test_rejection_verify_bit_equal_to_reference(seed):
    """Same logits rows, draft distributions, proposals and lane seeds:
    the same emitted tokens, and the lanes left in the same state."""
    rng = np.random.RandomState(100 + seed)
    vocab, k = 11, 1 + seed % 4
    kw = dict(temperature=0.7 + 0.1 * seed, top_k=seed % 3 * 4,
              top_p=1.0 if seed % 2 else 0.9, seed=seed)
    ts = SlotSampler(SamplingConfig(**kw), 2)
    js = JaxSlotSampler(JaxSamplingConfig(**kw), 2)
    for _ in range(5):
        rows = 2 * rng.randn(k + 1, vocab)
        qs = [ts.dist(2 * rng.randn(vocab)) for _ in range(k)]
        proposals = np.array([ts.sample_dist(q, 1) for q in qs])
        assert [js.sample_dist(q, 1) for q in qs] == list(proposals)
        assert tspec.rejection_verify(rows, proposals, qs, ts, 1) == \
            jspec.rejection_verify(rows, proposals, qs, js, 1)
        np.testing.assert_array_equal(ts.dist(rows[0]), js.dist(rows[0]))
    assert ts.uniform(1) == js.uniform(1)


def test_rejection_verify_marginal_is_target_distribution():
    """Over many lanes the FIRST emitted token's marginal equals the
    target's filtered distribution p, though the proposals come from a
    peaked draft q (the reference's check, same trials and bar)."""
    vocab, k, trials = 5, 2, 4000
    rows = np.random.RandomState(0).randn(k + 1, vocab)
    q = np.full(vocab, 0.02)
    q[3] = 1.0 - 0.02 * (vocab - 1)
    counts = np.zeros(vocab)
    for t in range(trials):
        sampler = SlotSampler(SamplingConfig(temperature=1.0, seed=t), 1)
        d = sampler.sample_dist(q, 0)
        emitted = tspec.rejection_verify(rows, np.asarray([d, d]), [q, q],
                                         sampler, 0)
        counts[emitted[0]] += 1
    p = SlotSampler(SamplingConfig(temperature=1.0), 1).dist(rows[0])
    np.testing.assert_allclose(counts / trials, p, atol=0.03)


def test_sampled_spec_run_is_lossless_and_matches_reference(weights):
    """Sampled speculative decoding completes every request with its
    full token count, and draws the reference's tokens at the same
    seed (the logits agree to f32 rounding and every draw rides the
    same Philox lanes)."""
    target, _, draft, p, dp = _port(weights, 2)
    jtarget, jdraft, jp, jdp = _reference(weights, 2)
    cfg = dict(temperature=1.0, top_k=8, seed=3)
    sched = target.run(p, _requests(), SamplingConfig(**cfg), draft=draft,
                       draft_params=dp)
    jsched = jtarget.run(jp, _requests(cls=JaxRequest),
                         JaxSamplingConfig(**cfg), draft=jdraft,
                         draft_params=jdp)
    assert len(sched.finished) == 6
    for f in sched.finished:
        assert len(f.tokens) == 5
        assert all(0 <= t < CFG_KW["vocab_size"] for t in f.tokens)
    assert _tokens(sched) == _tokens(jsched)


def test_int8_verify_step_matches_reference(weights):
    """The verify step under int8 (K4's path on the card) against the
    reference's int8 verify step on the same pool contents, block
    tables and spans: every (slot, position) logit row at the int8
    bar; then whole int8 runs."""
    k = 4
    target, plain, draft, p, dp = _port(weights, k, "int8")
    jtarget, jdraft, jp, jdp = _reference(weights, k, "int8")
    host, jhost = target.new_host(), jtarget.new_host()
    cache, jcache = target.init_cache(), jtarget.init_cache()
    rng = np.random.RandomState(5)
    positions = np.zeros(4, np.int64)
    for slot, n in enumerate((3, 6, 5)):
        prompt = rng.randint(1, 97, size=n).astype(np.int32)
        for h in (host, jhost):
            h.ensure_pages(slot, n)
        ids, length = target.pad_prompt(prompt)
        cache, _ = target.paged_prefill_step(p, cache,
                                             host.device_row(slot), ids,
                                             length)
        jids, jlen = jtarget.pad_prompt(prompt)
        jcache, _ = jtarget.prefill(jp, jcache, jhost.device_row(slot),
                                    jids, jlen)
        positions[slot] = n
    active = np.array([True, True, True, False])
    chunk = rng.randint(1, 97, size=(4, k + 1))
    for slot in range(3):
        for pos in range(positions[slot], positions[slot] + k + 1):
            host.ensure_writable(cache, slot, pos)
            jhost.ensure_writable(jcache, slot, pos)
    _, logits = target.paged_verify_step(
        p, cache, host.device_table(),
        *target.step_inputs(positions, chunk, active))
    _, jlogits = jtarget.verify_step(
        jp, jcache, jhost.device_table(), jnp.asarray(positions, jnp.int32),
        jnp.asarray(chunk, jnp.int32), jnp.asarray(active))
    np.testing.assert_allclose(logits.numpy()[:3], np.asarray(jlogits)[:3],
                               **INT8_TOL)
    sched = target.run(p, _requests(), draft=draft, draft_params=dp)
    jsched = jtarget.run(jp, _requests(cls=JaxRequest), draft=jdraft,
                         draft_params=jdp)
    assert _tokens(sched) == _tokens(jsched) == \
        _tokens(plain.run(p, _requests()))


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
def test_verify_rows_equal_decode_steps(weights, mode):
    """A verify step's k+1 rows equal the logits of k+1 decode steps fed
    the same tokens from the same pool, bit for bit: greedy acceptance
    compares their argmaxes. (On the card, the int8 path holds this
    too: chip_smoke.py phase 9.)"""
    k = 4
    target, _, _, p, _ = _port(weights, k, mode)
    host, cache = target.new_host(), target.init_cache()
    rng = np.random.RandomState(3)
    lens = (3, 6, 5, 7)
    for slot, n in enumerate(lens):
        host.ensure_pages(slot, n + k + 1)
        ids, length = target.pad_prompt(
            rng.randint(1, 97, size=n).astype(np.int32))
        cache, _ = target.paged_prefill_step(p, cache, host.device_row(slot),
                                             ids, length)
    positions = np.array(lens, np.int64)
    span = rng.randint(1, 97, size=(4, k + 1))
    active = np.ones(4, bool)
    before = {name: t.clone() for name, t in cache.items()}
    _, vlog = target.paged_verify_step(
        p, cache, host.device_table(),
        *target.step_inputs(positions, span, active))
    for j in range(k + 1):
        _, dlog = target.paged_decode_step(
            p, before, host.device_table(),
            *target.step_inputs(positions + j, span[:, j], active))
        assert np.array_equal(vlog[:, j].numpy(), dlog.numpy())


def _draft_target_pairs():
    base = dict(ENGINE_KW)
    return [
        (dict(num_slots=2, max_len=32, prefill_len=8), "PAGED draft"),
        (dict(base, speculative_k=2), "non-speculative"),
        (dict(base, prefix_cache=True), "target-side"),
        (dict(base, num_slots=2), "lockstep"),
        (dict(base, prefill_chunk=2), "lockstep"),
        (dict(base, page_size=4), None),
    ]


@pytest.mark.parametrize("draft_kw,match", _draft_target_pairs())
def test_check_draft_engine_raises_where_the_reference_does(draft_kw,
                                                            match):
    target = ServingEngine(GPTConfig(**CFG_KW), speculative_k=2,
                           device="cpu", **ENGINE_KW)
    jtarget = JaxEngine(JaxGPTConfig(**CFG_KW), speculative_k=2,
                        **ENGINE_KW)
    draft = ServingEngine(GPTConfig(**DRAFT_KW), device="cpu", **draft_kw)
    jdraft = JaxEngine(JaxGPTConfig(**DRAFT_KW), **draft_kw)
    outcomes = []
    for check, t, d in ((tspec.check_draft_engine, target, draft),
                        (jspec.check_draft_engine, jtarget, jdraft)):
        try:
            check(t, d)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (match is None) == (outcomes[0] is None)
    if match:
        assert match in outcomes[0]


def test_run_pairs_a_draft_with_speculative_k_as_the_reference(weights):
    target, plain, draft, p, dp = _port(weights, 2)
    with pytest.raises(ValueError, match="needs a proposer"):
        target.run(p, _requests(n=1))
    with pytest.raises(ValueError, match="speculative_k > 0 on the"):
        plain.run(p, _requests(n=1), draft=draft, draft_params=dp)


def _write_checkpoint(directory, cfg_kw, seed, **recorded):
    cfg = dict(cfg_kw)
    params = from_jax_params(numpy_params(seed, cfg))
    gpt = {k: cfg[k] for k in ("vocab_size", "dim", "num_layers",
                               "num_heads", "ffn_dim", "max_position")}
    gpt["num_experts"] = 0
    gpt.update(recorded)
    save_checkpoint(str(directory), {"params": to_jax_params(params)},
                    acc=1.0, epoch=0, extra={"gpt_config": gpt})


@pytest.mark.parametrize("recorded,match", [
    ({}, None),
    (dict(vocab_size=50), "vocab_size"),
    (dict(max_position=16), "max_position"),
    (dict(num_experts=4), "Mixture-of-Experts"),
])
def test_cli_draft_checks_raise_where_the_reference_does(tmp_path,
                                                         recorded, match):
    """The serve CLI's draft resolution on one checkpoint directory,
    against the reference CLI's: the same draft config, or the same
    refusal (a vocabulary or position table that does not match, a
    Mixture-of-Experts draft)."""
    _write_checkpoint(tmp_path, DRAFT_KW, 7, **recorded)
    flags = ["--vocab-size", "97", "--dim", "64", "--layers", "2",
             "--heads", "4", "--max-len", "32", "--page-size", "2",
             "--speculative-k", "2", "--speculative-draft", str(tmp_path)]
    outcomes = []
    for mod, cfg_cls in ((serve, GPTConfig), (jax_serve, JaxGPTConfig)):
        args = mod.build_parser().parse_args(flags)
        target = cfg_cls(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                         ffn_dim=256, max_position=32, dropout_rate=0.0,
                         pad_token_id=0)
        try:
            cfg, name = mod._draft_config(args, target)
            outcomes.append((dataclasses.asdict(cfg), name))
        except SystemExit as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if match:
        assert match in outcomes[0]
    else:
        assert outcomes[0][0]["num_layers"] == 1


def test_cli_serves_speculatively_with_checkpointed_and_fresh_drafts(
        tmp_path, capsys):
    """`cli.serve` with the target's own checkpoint as the draft (every
    proposal accepted) and with a fresh 1-layer draft (rollbacks): both
    give the plain run's tokens, and the report names the real k and
    draft."""
    _write_checkpoint(tmp_path, CFG_KW, 0)
    base = ["--device", "cpu", "--vocab-size", "97", "--dim", "64",
            "--layers", "2", "--heads", "4", "--ffn-dim", "256",
            "--max-len", "32", "--prefill-len", "8", "--num-slots", "4",
            "--prompt-len-max", "8", "--num-requests", "5",
            "--max-new-tokens", "6", "--page-size", "2",
            "--checkpoint", str(tmp_path)]
    plain = serve.main(base)
    same = serve.main(base + ["--speculative-k", "3",
                              "--speculative-draft", str(tmp_path)])
    fresh = serve.main(base + ["--speculative-k", "2",
                               "--speculative-draft-layers", "1"])
    capsys.readouterr()

    def by_rid(out):
        return {r["rid"]: r["tokens"] for r in out["requests"]}

    assert by_rid(same) == by_rid(plain) == by_rid(fresh)
    s = same["serving"]
    assert (s["speculative_k"], s["speculative_draft"]) == (3, str(tmp_path))
    assert s["speculative"]["accept_rate"] == 1.0
    assert fresh["serving"]["speculative"]["accept_rate"] < 1.0
    assert plain["serving"]["speculative_k"] is None
