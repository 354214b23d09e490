"""The PyTorch port's paged serving features held against the JAX
reference: the block-paged KV cache, chunked prefill, the prefix cache
with copy-on-write, page-budgeted admission, bf16 decode, and the
engine's and serve CLI's checks.

A small GPT (2 layers, dim 64, 4 heads, vocab 97, 32 positions) gets
its weights from a numpy seed; they cross to the port through
`models/convert.from_jax_params`. Both packages' engines run on the
CPU: the reference with its defaults (its int8 GEMM through its own
plain XLA path), the port with its plain versions.

Tolerances:
* f32 paged, chunked and prefix runs — logits within rtol/atol 1e-5 of
  the reference's (the bar of tests/test_torch_port_serving.py; sums run
  in another order in the two frameworks), greedy tokens identical; the
  port's paged logits EQUAL its contiguous logits (the gathered view
  holds the same values, and masked positions weigh exactly 0).
* int8 — the contiguous int8 bar of tests/test_torch_port_serving.py
  (rtol 1e-5, atol 5e-3: one activation code tipped across a
  round-half tie by an f32 ulp upstream).
* bf16 — the reference's bf16 serving bar (tests/test_serving.py,
  QUANT_LOGIT_RTOL/ATOL["bf16"]: 1e-2 / 2e-3), against the reference
  run op by op (`jax.disable_jit`). Jitted on the CPU, XLA keeps some
  bf16 intermediates in f32 inside its fusions: on these weights the
  jitted reference's first decode step lies 2.0e-3 from its f32 logits,
  op by op 3.5e-3, and the port (eager torch, rounding to bf16 after
  every op as the op-by-op reference does) 3.9e-3; the port lies 1.3e-3
  from the op-by-op reference and 3.8e-3 from the jitted one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.cli import common as jax_common
from distributed_model_parallel_tpu.cli import serve as jax_serve
from distributed_model_parallel_tpu.models.gpt import (
    GPTConfig as JaxGPTConfig,
)
from distributed_model_parallel_tpu.serving import kv_cache as jkv
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
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
)
from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
from distributed_model_parallel_tpu_torch.serving import kv_cache as tkv
from distributed_model_parallel_tpu_torch.serving.engine import (
    ServingEngine,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import Request

CFG_KW = dict(vocab_size=97, dim=64, num_layers=2, num_heads=4,
              ffn_dim=256, max_position=32, dropout_rate=0.0,
              pad_token_id=0)
ENGINE_KW = dict(num_slots=4, max_len=32, prefill_len=16)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-5, atol=5e-3)
BF16_TOL = dict(rtol=1e-2, atol=2e-3)
# Ragged: with page_size 4, lengths 5 and 7 leave an unaligned last
# page, and six decode steps walk every slot across a page boundary.
PROMPT_LENS = (5, 7, 3, 12)


def numpy_params(seed=0, cfg=CFG_KW):
    """The reference's `gpt_lm` tree for config fields `cfg`, drawn from
    a numpy seed: 0.02-scaled normals, with non-trivial biases and
    LayerNorm affines."""
    rng = np.random.RandomState(seed)
    d, f, v, p = (cfg[k] for k in ("dim", "ffn_dim", "vocab_size",
                                   "max_position"))

    def normal(*shape, scale=0.02):
        return (scale * rng.randn(*shape)).astype(np.float32)

    def linear(i, o):
        return {"w": normal(i, o), "b": normal(o)}

    def norm():
        return {"scale": 1 + normal(d, scale=0.1), "bias": normal(d)}

    blocks = {str(i): {"attn": {"qkv": linear(d, 3 * d),
                                "out": linear(d, d)},
                       "ln1": norm(),
                       "ffn": {"in": linear(d, f), "out": linear(f, d)},
                       "ln2": norm()}
              for i in range(cfg["num_layers"])}
    return {"stem": {"word": normal(v, d), "position": normal(p, d)},
            "blocks": blocks, "head": {"w": normal(d, v)}}


@pytest.fixture(scope="module")
def weights():
    return numpy_params(0)


def engines(weights, mode="f32", **kw):
    """(reference engine, its params, port engine, its params)."""
    jeng = JaxEngine(JaxGPTConfig(**CFG_KW), compute_dtype=mode,
                     **dict(ENGINE_KW, **kw))
    teng = ServingEngine(GPTConfig(**CFG_KW), compute_dtype=mode,
                         device="cpu", **dict(ENGINE_KW, **kw))
    jp = jeng.place_params(jax.tree.map(jnp.asarray, weights))
    return jeng, jp, teng, teng.place_params(from_jax_params(weights))


def prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG_KW["vocab_size"], size=n).astype(np.int32)
            for n in lens]


def host_state(host):
    """A host's bookkeeping as plain data: block tables, the pool's free
    list and refcounts, and the prefix map."""
    state = {"tables": np.asarray(host.block_tables).tolist(),
             "free": sorted(host.pool._free),
             "refs": dict(sorted(host.pool._refs.items())),
             "cow": host.cow_copies, "peak": host.pages_in_use_peak}
    if host.prefix is not None:
        state["prefix"] = (list(host.prefix._map.items()),
                           host.prefix.hits, host.prefix.misses,
                           host.prefix.tokens_reused)
    return state


class Lockstep:
    """The reference's and the port's paged engines (and optionally the
    port's contiguous twin), driven through the same host operations and
    decode steps; every logit row compared."""

    def __init__(self, weights, mode, tol, contiguous=False, **kw):
        self.jeng, self.jp, self.teng, self.tp = engines(weights, mode,
                                                         **kw)
        self.tol = tol
        self.jhost, self.thost = self.jeng.new_host(), self.teng.new_host()
        self.jc, self.tc = self.jeng.init_cache(), self.teng.init_cache()
        n = ENGINE_KW["num_slots"]
        self.tokens = np.zeros(n, np.int32)
        self.positions = np.zeros(n, np.int32)
        self.active = np.zeros(n, bool)
        self.contig = None
        if contiguous:
            ceng = ServingEngine(GPTConfig(**CFG_KW), compute_dtype=mode,
                                 device="cpu", **ENGINE_KW)
            self.contig = (ceng, ceng.place_params(
                from_jax_params(weights)), ceng.init_cache())

    def both_hosts(self, op, *args):
        getattr(self.jhost, op)(*args)
        getattr(self.thost, op)(*args)

    def prefill(self, slot, prompt):
        self.both_hosts("ensure_pages", slot, int(prompt.size))
        ids, length = self.jeng.pad_prompt(prompt)
        self.jc, jl = self.jeng.prefill(
            self.jp, self.jc, self.jhost.device_table()[slot], ids, length)
        tids, tlen = self.teng.pad_prompt(prompt)
        self.tc, tl = self.teng.paged_prefill_step(
            self.tp, self.tc, self.thost.device_row(slot), tids, tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **self.tol)
        if self.contig is not None:
            ceng, cp, cc = self.contig
            _, cl = ceng.prefill(cp, cc, tids, tlen, slot)
            assert torch.equal(cl, tl)
        self.tokens[slot] = int(np.asarray(jl).argmax())
        self.positions[slot] = prompt.size
        self.active[slot] = True

    def step(self, n=1):
        for _ in range(n):
            for slot in np.nonzero(self.active)[0]:
                self.jc = self.jhost.ensure_writable(
                    self.jc, int(slot), int(self.positions[slot]))
                self.tc = self.thost.ensure_writable(
                    self.tc, int(slot), int(self.positions[slot]))
            self.jc, jl = self.jeng.decode_step(
                self.jp, self.jc, self.jhost.device_table(),
                jnp.asarray(self.positions), jnp.asarray(self.tokens),
                jnp.asarray(self.active))
            self.tc, tl = self.teng.paged_decode_step(
                self.tp, self.tc, self.thost.device_table(),
                *self.teng.step_inputs(self.positions, self.tokens,
                                       self.active))
            jl, tl_np = np.asarray(jl), tl.numpy()
            a = self.active
            np.testing.assert_allclose(tl_np[a], jl[a], **self.tol)
            if self.teng.compute_mode != "bf16":
                np.testing.assert_array_equal(tl_np[a].argmax(-1),
                                              jl[a].argmax(-1))
            if self.contig is not None:
                ceng, cp, cc = self.contig
                cc["lengths"] = torch.from_numpy(
                    self.positions.astype(np.int64))
                _, cl = ceng.decode_step(
                    cp, cc, torch.from_numpy(self.tokens.astype(np.int64)),
                    torch.from_numpy(a))
                assert torch.equal(cl[torch.from_numpy(a)],
                                   tl[torch.from_numpy(a)])
            self.tokens[a] = jl[a].argmax(-1)
            self.positions[a] += 1
        assert host_state(self.thost) == host_state(self.jhost)


@pytest.mark.parametrize("page_size", [2, 4])
def test_paged_decode_logits_match_reference_and_contiguous(weights,
                                                            page_size):
    """Monolithic paged prefill of a ragged batch (unaligned last pages),
    decode steps across page boundaries with one slot idle, then a
    recycled slot landing on returned pages: every logit row within
    1e-5 of the reference's, equal to the port's contiguous path's, and
    the hosts' block tables, free lists and refcounts equal."""
    run = Lockstep(weights, "f32", F32_TOL, contiguous=True,
                   page_size=page_size)
    for slot, prompt in enumerate(prompts()):
        run.prefill(slot, prompt)
    run.step(4)
    run.active[2] = False
    run.step(1)
    run.active[2] = True
    run.both_hosts("release", 0)
    run.active[0] = False
    run.prefill(0, prompts(seed=9, lens=(6,))[0])
    run.step(3)
    # Live positions of the pool equal the reference's.
    for slot in range(ENGINE_KW["num_slots"]):
        for pos in range(int(run.positions[slot])):
            pid = run.thost.block_tables[slot, pos // page_size]
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    run.tc[name][:, pid, pos % page_size].numpy(),
                    np.asarray(run.jc[name][:, pid, pos % page_size]),
                    **F32_TOL)


def test_int8_paged_decode_matches_reference(weights):
    run = Lockstep(weights, "int8", INT8_TOL, page_size=4)
    for slot, prompt in enumerate(prompts()):
        run.prefill(slot, prompt)
    run.step(5)


def test_chunked_prefill_logits_match_reference(weights):
    """A 21-token prompt (past prefill_len 16) ingested in unaligned
    3-token chunks over 4-token pages, then decoded: every chunk's
    next-token logits and every decode row within 1e-5 of the
    reference's."""
    jeng, jp, teng, tp = engines(weights, page_size=4, prefill_chunk=3)
    jhost, thost = jeng.new_host(), teng.new_host()
    jc, tc = jeng.init_cache(), teng.init_cache()
    prompt = prompts(seed=4, lens=(21,))[0]
    for start in range(0, prompt.size, 3):
        tids, n = teng.chunk_ids(prompt, start)
        jhost.ensure_pages(1, start + n)
        thost.ensure_pages(1, start + n)
        jc, jl = jeng.chunk_prefill(
            jp, jc, jhost.device_row(1),
            jnp.asarray(tids.numpy(), jnp.int32), jnp.int32(start),
            jnp.int32(n))
        tc, tl = teng.chunk_prefill_step(tp, tc, thost.device_row(1), tids,
                                         start, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert host_state(thost) == host_state(jhost)
    positions = np.array([0, prompt.size, 0, 0], np.int32)
    tokens = np.array([0, np.asarray(jl).argmax(), 0, 0], np.int32)
    active = np.array([False, True, False, False])
    for _ in range(3):
        for host in (jhost, thost):
            host.ensure_writable(None, 1, int(positions[1]))
        jc, jl = jeng.decode_step(jp, jc, jhost.device_table(),
                                  jnp.asarray(positions),
                                  jnp.asarray(tokens), jnp.asarray(active))
        tc, tl = teng.paged_decode_step(
            tp, tc, thost.device_table(),
            *teng.step_inputs(positions, tokens, active))
        np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1],
                                   **F32_TOL)
        tokens[1] = int(np.asarray(jl)[1].argmax())
        positions[1] += 1


def _run(eng, params, reqs, request_cls, **kw):
    sched = eng.run(params, [request_cls(r.rid, r.prompt, r.max_new_tokens)
                             for r in reqs], **kw)
    return sched, {f.rid: f.tokens for f in sched.finished}


def _requests(seed=3, lens=(5, 9, 2, 14, 6, 11), max_new=6):
    return [Request(i, p, max_new_tokens=max_new)
            for i, p in enumerate(prompts(seed, lens))]


def test_chunked_monolithic_and_contiguous_runs_give_the_same_tokens(
        weights):
    """Whole runs: chunked (unaligned 3-token chunks), monolithic paged
    and contiguous give the port the same tokens, and these equal the
    reference's chunked run; a prompt longer than prefill_len runs only
    chunked, with the reference's tokens."""
    reqs = _requests()
    got = {}
    for name, kw in (("contiguous", {}), ("paged", dict(page_size=4)),
                     ("chunked", dict(page_size=4, prefill_chunk=3))):
        teng = ServingEngine(GPTConfig(**CFG_KW), device="cpu",
                             **dict(ENGINE_KW, **kw))
        _, got[name] = _run(teng, teng.place_params(
            from_jax_params(weights)), reqs, Request)
    jeng, jp, teng, tp = engines(weights, page_size=4, prefill_chunk=3)
    jsched, want = _run(jeng, jp, reqs, JaxRequest)
    assert got["contiguous"] == got["paged"] == got["chunked"] == want
    long = _requests(seed=5, lens=(25, 4, 19), max_new=4)
    tsched, tok = _run(teng, tp, long, Request)
    jsched, jtok = _run(jeng, jp, long, JaxRequest)
    assert tok == jtok
    assert tsched.latency_report()["paged"] == \
        jsched.latency_report()["paged"]


def test_page_pool_and_prefix_cache_host_state_match_reference():
    """One sequence of pool, prefix-cache and host operations driven on
    both packages' host structures: equal free lists, refcounts, prefix
    maps, hit counts, evictions and block tables after every step."""
    pools = (jkv.PagePool(6, page_bytes=10), tkv.PagePool(6, page_bytes=10))
    caches = (jkv.PrefixCache(pools[0], 4), tkv.PrefixCache(pools[1], 4))
    log = ([], [])
    rng = np.random.RandomState(0)
    base = rng.randint(1, 50, size=10).astype(np.int32)
    other = rng.randint(1, 50, size=9).astype(np.int32)

    def state(i):
        return (sorted(pools[i]._free), dict(sorted(pools[i]._refs.items())),
                pools[i].kv_cache_bytes, list(caches[i]._map.items()),
                caches[i].hits, caches[i].misses, caches[i].tokens_reused,
                caches[i].evictable, log[i])

    ops = [
        lambda p, c: [p.alloc() for _ in range(3)],
        lambda p, c: c.register(base, [0, 1, 2]),
        lambda p, c: c.match(base),
        lambda p, c: c.match(np.concatenate([base[:8], other[:3]])),
        lambda p, c: c.match(other),
        lambda p, c: [p.decref(pid) for pid in (0, 1, 2)],
        lambda p, c: [p.alloc() for _ in range(3)],
        lambda p, c: c.register(other, [3, 4, 5]),
        lambda p, c: c.release_unused(2),
        lambda p, c: [p.decref(pid) for pid in (0, 1, 2)],
        lambda p, c: c.release_unused(10),
        lambda p, c: [p.alloc() for _ in range(p.free_pages)],
    ]
    for op in ops:
        for i in (0, 1):
            log[i].append(op(pools[i], caches[i]))
        assert state(1) == state(0)
    spec_kw = dict(num_layers=1, num_slots=3, max_len=16, page_size=4,
                   num_pages=9, num_heads=1, head_dim=2)
    copies = ([], [])
    hosts = (jkv.PagedCacheHost(jkv.PagedKVCacheSpec(**spec_kw),
                                prefix_cache=True,
                                copy_fn=lambda c, s, d: copies[0].append(
                                    (int(s), int(d))) or c),
             tkv.PagedCacheHost(tkv.PagedKVCacheSpec(**spec_kw),
                                prefix_cache=True,
                                copy_fn=lambda c, s, d: copies[1].append(
                                    (s, d)) or c))
    host_ops = [
        lambda h: h.can_hold(10), lambda h: h.reserve(0, 10),
        lambda h: h.attach_prefix(0, base), lambda h: h.ensure_pages(0, 10),
        lambda h: h.register_prefix(0, base), lambda h: h.can_hold(16),
        lambda h: h.reserve(1, 12), lambda h: h.attach_prefix(1, base),
        lambda h: h.ensure_writable(None, 1, 9),
        lambda h: h.ensure_writable(None, 1, 10),
        lambda h: h.ensure_writable(None, 0, 10),
        lambda h: h.truncate(1, 5), lambda h: h.release(0),
        lambda h: h.can_hold(16), lambda h: h.reserve(2, 16),
        lambda h: h.ensure_pages(2, 16), lambda h: h.release(1),
        lambda h: h.release(2),
    ]
    for op in host_ops:
        assert op(hosts[1]) == op(hosts[0])
        assert host_state(hosts[1]) == host_state(hosts[0])
        assert hosts[1]._commit == hosts[0]._commit
    assert copies[1] == copies[0] and copies[0]


def _shared_prefix_requests(seed=7, n=6):
    """Requests sharing a 10-token prefix (two full 4-token pages and a
    partial one), each with its own tail; one is the bare prefix (a full
    hit whose partial page copies on write)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, CFG_KW["vocab_size"], size=10).astype(np.int32)
    reqs = [Request(0, prefix, max_new_tokens=5)]
    for i in range(1, n):
        tail = rng.randint(1, CFG_KW["vocab_size"],
                           size=int(rng.randint(1, 6))).astype(np.int32)
        reqs.append(Request(i, np.concatenate([prefix, tail]),
                            max_new_tokens=5))
    reqs.append(Request(n, prefix, max_new_tokens=5))
    return reqs


def test_prefix_cache_run_matches_reference(weights):
    """The prefix-cached engine run: the reference's finished tokens,
    `prefix_cache` report and `paged` statistics (copy-on-write count
    included), and the tokens of the run without the cache."""
    reqs = _shared_prefix_requests()
    kw = dict(page_size=4, prefill_chunk=4, prefix_cache=True)
    jeng, jp, teng, tp = engines(weights, **kw)
    tsched, tok = _run(teng, tp, reqs, Request)
    jsched, jtok = _run(jeng, jp, reqs, JaxRequest)
    assert tok == jtok
    trep, jrep = tsched.latency_report(), jsched.latency_report()
    assert trep["prefix_cache"] == jrep["prefix_cache"]
    assert trep["prefix_cache"]["hits"] > 0
    assert trep["paged"] == jrep["paged"]
    assert trep["paged"]["cow_copies"] > 0
    plain = ServingEngine(GPTConfig(**CFG_KW), device="cpu",
                          **dict(ENGINE_KW, page_size=4, prefill_chunk=4))
    _, ptok = _run(plain, plain.place_params(from_jax_params(weights)),
                   reqs, Request)
    assert ptok == tok


def test_copy_on_write_keeps_the_shared_page_bytes(weights):
    """Slot 0 ingests a 10-token prompt and publishes its pages; slot 1
    borrows all three (a full hit: its last, partial page is shared).
    Both then decode into that page: each write copies first, so the
    cached page's bytes never change while the cache and the slots read
    it, and slot 0's logits equal those of a run without slot 1."""
    _, _, teng, tp = engines(weights, page_size=4, prefill_chunk=4,
                             prefix_cache=True)
    prompt = _shared_prefix_requests()[0].prompt

    def run(with_borrower):
        host, cache = teng.new_host(), teng.init_cache()
        for start in range(0, prompt.size, 4):
            ids, n = teng.chunk_ids(prompt, start)
            host.ensure_pages(0, start + n)
            cache, nl = teng.chunk_prefill_step(tp, cache,
                                                host.device_row(0), ids,
                                                start, n)
        host.register_prefix(0, prompt)
        shared = int(host.block_tables[0, 2])
        before = {n: cache[n][:, shared].clone() for n in ("k", "v")}
        positions = np.array([prompt.size, 0, 0, 0])
        tokens = np.array([int(nl.argmax()), 0, 0, 0])
        active = np.array([True, False, False, False])
        if with_borrower:
            assert host.attach_prefix(1, prompt) == prompt.size
            positions[1], tokens[1], active[1] = (prompt.size - 1,
                                                  prompt[-1], True)
        rows = []
        for _ in range(3):
            for slot in np.nonzero(active)[0]:
                cache = host.ensure_writable(cache, int(slot),
                                             int(positions[slot]))
            assert int(host.block_tables[0, 2]) != shared
            cache, logits = teng.paged_decode_step(
                tp, cache, host.device_table(),
                *teng.step_inputs(positions, tokens, active))
            rows.append(logits[0])
            for name in ("k", "v"):
                assert torch.equal(cache[name][:, shared], before[name])
            tokens[active] = logits.argmax(-1).numpy()[active]
            positions[active] += 1
        assert host.pool.refcount(shared) == 1  # the cache's own
        return host.cow_copies, torch.stack(rows)

    cows_alone, alone = run(False)
    cows, shared_run = run(True)
    assert (cows_alone, cows) == (1, 2)
    assert torch.equal(shared_run, alone)


def test_undersized_pool_defers_admission_and_completes(weights):
    """A pool of 10 four-token pages cannot hold four sequences at once:
    admission waits for pages, every request completes, and the
    admission order (finish order), tokens and page statistics equal the
    reference's; the peak follows live tokens, under the contiguous
    stripes' bytes."""
    reqs = _requests(seed=11, lens=(9, 6, 12, 4, 7), max_new=8)
    jeng, jp, teng, tp = engines(weights, page_size=4, num_pages=10,
                                 prefill_chunk=4)
    tsched, tok = _run(teng, tp, reqs, Request)
    jsched, jtok = _run(jeng, jp, reqs, JaxRequest)
    assert tok == jtok and len(tok) == len(reqs)
    assert [f.rid for f in tsched.finished] == \
        [f.rid for f in jsched.finished]
    trep, jrep = tsched.latency_report(), jsched.latency_report()
    assert trep["paged"] == jrep["paged"]
    assert trep["paged"]["pages_in_use_peak"] <= 10
    assert trep["paged"]["kv_cache_bytes_peak"] < \
        trep["paged"]["contiguous_bytes"]
    for key in ("decode_steps", "engine_iterations", "goodput"):
        assert trep[key] == jrep[key], key


@pytest.mark.parametrize("paged", [False, True])
def test_bf16_first_decode_step_matches_reference(weights, paged):
    """bf16: the prefill next-token rows and the first decode step of a
    ragged batch within the reference's bf16 bar of the reference run op
    by op (module docstring); the cache is bf16."""
    with jax.disable_jit():
        _bf16_first_decode_step(weights, paged)


def _bf16_first_decode_step(weights, paged):
    kw = dict(page_size=4) if paged else {}
    run = Lockstep(weights, "bf16", BF16_TOL, **kw) if paged else None
    if paged:
        for slot, prompt in enumerate(prompts()):
            run.prefill(slot, prompt)
        run.step(1)
        assert run.tc["k"].dtype == torch.bfloat16
        assert str(run.jc["k"].dtype) == "bfloat16"
        return
    jeng, jp, teng, tp = engines(weights, "bf16")
    jc, tc = jeng.init_cache(), teng.init_cache()
    assert tc["k"].dtype == tc["v"].dtype == torch.bfloat16
    for slot, prompt in enumerate(prompts()):
        ids, length = jeng.pad_prompt(prompt)
        jc, jl = jeng.prefill(jp, jc, ids, length, jnp.int32(slot))
        tids, tlen = teng.pad_prompt(prompt)
        tc, tl = teng.prefill(tp, tc, tids, tlen, slot)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    tokens = np.arange(1, 5)
    jc, jl = jeng.decode_step(jp, jc, jnp.asarray(tokens, jnp.int32),
                              jnp.ones(4, bool))
    tc, tl = teng.decode_step(tp, tc, torch.from_numpy(tokens),
                              torch.ones(4, dtype=torch.bool))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)


def test_bf16_run_tokens_match_reference(weights):
    """A chunked paged bf16 run gives the op-by-op reference's tokens."""
    reqs = _requests(max_new=4)
    jeng, jp, teng, tp = engines(weights, "bf16", page_size=4,
                                 prefill_chunk=4)
    _, tok = _run(teng, tp, reqs, Request)
    with jax.disable_jit():
        _, jtok = _run(jeng, jp, reqs, JaxRequest)
    assert tok == jtok


ENGINE_GUARDS = [
    dict(prefill_chunk=4), dict(num_pages=8), dict(prefix_cache=True),
    dict(page_size=4, prefix_cache=True), dict(page_size=5),
    dict(page_size=4, num_pages=2), dict(page_size=4, prefill_chunk=0),
    dict(speculative_k=2), dict(page_size=4, speculative_k=9),
    dict(page_size=4, speculative_k=-1),
    dict(page_size=4, max_len=8, prefill_len=4, speculative_k=8),
    dict(page_size=4, prefill_chunk=4, prefix_cache=True, speculative_k=8),
    dict(compute_dtype="fp8"), dict(compute_dtype=torch.float16),
]


@pytest.mark.parametrize("knobs", ENGINE_GUARDS)
def test_engine_guards_raise_where_the_reference_does(knobs):
    """Each knob set is refused with the reference's message, or accepted
    by both packages."""
    kw = dict(ENGINE_KW, **knobs)
    jkw = dict(kw)
    if jkw.get("compute_dtype") is torch.float16:
        jkw["compute_dtype"] = jnp.float16
    try:
        JaxEngine(JaxGPTConfig(**CFG_KW), **jkw)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        ServingEngine(GPTConfig(**CFG_KW), device="cpu", **kw)
        got = None
    except ValueError as e:
        got = str(e)
    if want is not None and "compute_dtype" in want:
        # The dtype refusals name the port's own dtypes.
        assert got is not None and "compute_dtype" in got
    else:
        # The same message up to its parenthetical reason.
        assert (got is None) == (want is None)
        if got is not None:
            assert got.split(" (")[0] == want.split(" (")[0]


CLI_FLAG_SETS = [
    ["--page-size", "16"], ["--page-size", "0"], ["--page-size", "-1"],
    ["--page-size", "48"], ["--kv-pages", "8"], ["--prefill-chunk", "8"],
    ["--prefix-cache"], ["--page-size", "16", "--prefix-cache"],
    ["--page-size", "16", "--prefill-chunk", "8", "--prefix-cache"],
    ["--page-size", "16", "--kv-pages", "-2"],
    ["--page-size", "16", "--prefill-chunk", "-3"],
    ["--speculative-k", "2"], ["--speculative-k", "9"],
    ["--page-size", "16", "--speculative-k", "2"],
    ["--page-size", "4", "--max-len", "8", "--speculative-k", "8"],
    ["--speculative-draft-layers", "2"], ["--speculative-draft", "D"],
    ["--page-size", "16", "--speculative-k", "2", "--speculative-draft",
     "D", "--speculative-draft-layers", "2"],
    ["--page-size", "16", "--speculative-k", "2",
     "--speculative-draft-layers", "-1"],
    ["--compute-dtype", "bf16"], ["--dtype", "bfloat16"],
    ["--compute-dtype", "int8", "--dtype", "bfloat16"],
]


@pytest.mark.parametrize("flags", CLI_FLAG_SETS)
def test_cli_checks_raise_where_the_reference_does(flags):
    """The serve CLI's flag checks against the reference CLI's
    `check_serving_args` on the same command line: the same message, or
    accepted by both."""
    def outcome(parser, check):
        try:
            check(parser.parse_args(flags))
        except SystemExit as e:
            return str(e)
        return None

    assert outcome(serve.build_parser(), check_serving_args) == outcome(
        jax_serve.build_parser(), jax_common.check_serving_args)


def test_cli_serves_paged_and_chunked_on_cpu(capsys):
    """The CLI end to end with the paged flags: the report names the real
    page size, chunk and pool size, and its tokens equal the contiguous
    run's."""
    base = ["--device", "cpu", "--vocab-size", "97", "--dim", "64",
            "--layers", "2", "--heads", "4", "--num-slots", "4",
            "--max-len", "64", "--prefill-len", "16",
            "--prompt-len-max", "16", "--num-requests", "5",
            "--max-new-tokens", "5"]
    plain = serve.main(base)
    paged = serve.main(base + ["--page-size", "8", "--prefill-chunk", "5",
                               "--kv-pages", "24"])
    capsys.readouterr()
    s = paged["serving"]
    assert (s["page_size"], s["prefill_chunk"], s["paged"]["num_pages"]) \
        == (8, 5, 24)

    def by_rid(out):
        return {r["rid"]: r["tokens"] for r in out["requests"]}

    assert by_rid(paged) == by_rid(plain)
    assert plain["serving"]["page_size"] is None


def test_paged_report_sections_match_the_reference_shape(weights):
    reqs = _shared_prefix_requests(n=3)
    kw = dict(page_size=4, prefill_chunk=4, prefix_cache=True)
    jeng, jp, teng, tp = engines(weights, **kw)
    trep = _run(teng, tp, reqs, Request)[0].latency_report()
    jrep = _run(jeng, jp, reqs, JaxRequest)[0].latency_report()
    assert set(trep) == set(jrep)
    assert dataclasses.is_dataclass(teng.paged_spec)
    assert teng.paged_spec.page_bytes == jeng.paged_spec.page_bytes
