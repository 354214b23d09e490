"""Speculative decoding on the paged serving engine (port of
`serving/speculative.py`): draft-propose, one-pass verify, lossless
accept.

At decode batch sizes a target iteration is weight-bound: one token per
slot pays for a full read of the weights. A small DRAFT model proposes k
tokens per slot, and the target scores all k+1 positions in ONE verify
step (`ServingEngine.paged_verify_step`, the chunk-shaped paged step),
so the weight read is paid once for k+1 positions.

The three invariants this module owns:

* **Losslessness.** Greedy mode emits the longest draft prefix that
  matches the target's own argmaxes plus the target's correction (or
  bonus) token: the tokens of the non-speculative greedy engine.
  Sampled mode applies the rejection rule per position on the slot's
  own Philox lane (`SlotSampler.dist/uniform/sample_dist`): accept draft
  token d with probability min(1, p(d)/q(d)); on the first rejection
  draw the correction from normalize(max(p-q, 0)); after k acceptances
  draw the bonus from p, so the emitted distribution is the target's
  for ANY draft.

* **Rollback is a block-table edit.** A rejected suffix rolls both
  caches back via `PagedCacheHost.truncate`: pages wholly past the kept
  span return to the pool; stale K/V inside the kept final page stays
  masked by the slot's position. KV bytes are never copied.

* **Degrade, don't die.** When any active slot is within k+1 positions
  of `max_len`, the iteration falls back to ONE plain decode step for
  the whole batch (the verify span is fixed at k+1); the sequence
  finishes exactly as the non-speculative engine would. These rounds
  are the report's plain `decode_steps` beside the verify rounds.

Draft-cache bookkeeping (`draft_n[slot]` = positions the draft cache
holds): a proposal round writes positions pos..pos+k-1 into the draft,
so a FULL accept (k+1 emitted) leaves the draft one position behind;
the next round opens with one batched catch-up decode step feeding the
known token at that hole (logits discarded) for the slots that need it.
A partial accept truncates the draft to the kept span.

The prefix cache stays a TARGET-side feature: a cached prompt still
skips target prefill, but the draft always ingests the prompt itself
(its cache holds draft-model K/V, so target prefix pages are unusable
by construction).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from distributed_model_parallel_tpu_torch.observability.metrics import (
    get_metrics,
)
from distributed_model_parallel_tpu_torch.observability.trace import (
    get_tracer,
)
from distributed_model_parallel_tpu_torch.serving.sampling import (
    SlotSampler,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import (
    Request,
    Scheduler,
)

__all__ = [
    "check_draft_engine",
    "greedy_verify",
    "rejection_verify",
    "run_speculative",
]


# ------------------------------------------------- acceptance (pure)


def greedy_verify(rows: np.ndarray, proposals: np.ndarray) -> List[int]:
    """Greedy acceptance for one slot: `rows` is the verify step's (k+1,
    vocab) logits (row i = the target's distribution after the i-th fed
    token), `proposals` the k draft tokens. Emits the longest prefix of
    proposals matching the target's argmaxes, then the target's own
    next token (the correction on a mismatch, the bonus after a full
    match)."""
    k = int(proposals.shape[0])
    emitted: List[int] = []
    for i in range(k):
        t = int(np.argmax(rows[i]))
        emitted.append(t)
        if t != int(proposals[i]):
            return emitted  # correction token; suffix rejected
    emitted.append(int(np.argmax(rows[k])))  # bonus
    return emitted


def rejection_verify(rows: np.ndarray, proposals: np.ndarray,
                     draft_dists: Sequence[np.ndarray],
                     sampler: SlotSampler, slot: int) -> List[int]:
    """Lossless rejection-sampling acceptance for one slot (module
    docstring). `draft_dists[i]` is the draft's filtered distribution
    q_i the i-th proposal was drawn from; the target's p_i comes from
    the verify logits through the same filter (`SlotSampler.dist`). All
    randomness rides the slot's own lane."""
    k = int(proposals.shape[0])
    emitted: List[int] = []
    for i in range(k):
        p = sampler.dist(rows[i])
        q = draft_dists[i]
        d = int(proposals[i])
        # Accept with probability min(1, p[d]/q[d]); q[d] > 0 because d
        # was drawn from q. u*q[d] <= p[d] avoids the division.
        if sampler.uniform(slot) * q[d] <= p[d]:
            emitted.append(d)
            continue
        residual = np.maximum(p - q, 0.0)
        total = residual.sum()
        if total <= 0.0:
            # p <= q everywhere rejects with probability 0; the
            # measure-zero numerical corner draws from p itself (still
            # the target's distribution).
            residual, total = p, p.sum()
        emitted.append(sampler.sample_dist(residual / total, slot))
        return emitted
    emitted.append(sampler.sample_dist(sampler.dist(rows[k]), slot))
    return emitted


# -------------------------------------------------------- guards


def check_draft_engine(target, draft) -> None:
    """Fail fast on a draft engine the loop cannot drive in lockstep
    with the target (the serve CLI rejects most of these from flags;
    this is the engine-level backstop)."""
    if draft.paged_spec is None:
        raise ValueError(
            "speculative decoding needs a PAGED draft engine (rollback "
            "truncates the block table): set page_size on the draft"
        )
    if draft.speculative_k:
        raise ValueError(
            "the draft engine must itself be non-speculative "
            f"(draft.speculative_k={draft.speculative_k})"
        )
    if draft.prefix_cache:
        raise ValueError(
            "prefix caching is a target-side feature: the draft always "
            "ingests prompts itself (its K/V differ from the target's) — "
            "construct the draft with prefix_cache=False"
        )
    for field in ("num_slots", "max_len", "prefill_len", "prefill_chunk"):
        tv, dv = getattr(target, field), getattr(draft, field)
        if tv != dv:
            raise ValueError(
                f"draft engine must match the target's {field} so "
                f"admission and ingest run in lockstep: target {tv}, "
                f"draft {dv}"
            )


# ------------------------------------------------------ the loop


def run_speculative(target, params, requests: Sequence[Request],
                    sampler: Optional[SlotSampler], draft,
                    draft_params) -> Scheduler:
    """Drive `requests` to completion on the TARGET engine with `draft`
    proposing `target.speculative_k` tokens per slot per round. Mirrors
    `ServingEngine._run_paged`'s admission/ingest/evict structure; the
    decode step becomes draft-propose + one-pass verify + lossless
    accept rounds (module docstring)."""
    check_draft_engine(target, draft)
    k = target.speculative_k
    tracer = get_tracer()
    mx = get_metrics()
    host = target.new_host()
    dhost = draft.new_host()
    sched = Scheduler(
        target.num_slots, target.max_len,
        bytes_per_slot=target._slot_stripe_bytes,
    )
    sched.spec_k = k
    chunked = bool(target.prefill_chunk)
    target._check_prompts(requests, chunked)
    for r in requests:
        sched.submit(r)
    cache = target.init_cache()
    dcache = draft.init_cache()
    n_slots = target.num_slots
    positions = np.zeros((n_slots,), np.int64)
    tokens = np.zeros((n_slots,), np.int64)
    active = np.zeros((n_slots,), bool)
    # Positions the draft cache holds for each slot (module docstring).
    draft_n = np.zeros((n_slots,), np.int64)
    # slot -> [prompt, target next-ingest pos (None = covered/done),
    #          draft next-ingest pos, accumulated seconds]
    ingest: dict = {}

    def token_at(seq, p: int) -> int:
        """The sequence's token at absolute position p (prompt, then
        generated): the draft catch-up step's input."""
        np_len = int(seq.request.prompt.size)
        if p < np_len:
            return int(seq.request.prompt[p])
        return int(seq.generated[p - np_len])

    def evict(slot):
        sched.finish(slot)
        active[slot] = False
        host.release(slot)
        dhost.release(slot)

    while sched.has_work() or ingest:
        useful = 0
        # ---- admission: free slots AND page headroom on BOTH pools ---
        # The verify step writes up to k+1 positions past the current
        # one, which near the end of a sequence can overshoot its
        # budget; the reservation covers the overshoot.
        while sched.can_admit():
            nxt = sched.waiting[0][1]
            budget = min(
                int(nxt.prompt.size) + int(nxt.max_new_tokens) + k,
                target.max_len,
            )
            if not (host.can_hold(budget) and dhost.can_hold(budget)):
                break
            seq = sched.admit()
            host.reserve(seq.slot, budget)
            dhost.reserve(seq.slot, budget)
            prompt = seq.request.prompt
            covered = host.attach_prefix(seq.slot, prompt)
            if mx.enabled and host.prefix is not None:
                mx.inc("serve_prefix_hits_total", 1 if covered else 0)
            if not chunked:
                # Monolithic prefill on BOTH engines; the draft's logits
                # are discarded (proposals start next round).
                host.ensure_pages(seq.slot, int(prompt.size))
                dhost.ensure_pages(seq.slot, int(prompt.size))
                ids, length = target.pad_prompt(prompt)
                t0 = tracer.now()
                with tracer.span("prefill", rid=repr(seq.request.rid),
                                 slot=seq.slot):
                    cache, nl = target.paged_prefill_step(
                        params, cache, host.device_row(seq.slot), ids,
                        length,
                    )
                    dcache, _ = draft.paged_prefill_step(
                        draft_params, dcache, dhost.device_row(seq.slot),
                        ids, length,
                    )
                    tok = target._pick(sampler, nl.cpu().numpy(), seq.slot)
                seq.t_first_token = tracer.now()
                sched.record_iteration(1)
                if mx.enabled:
                    mx.observe("serve_prefill_s", seq.t_first_token - t0)
                    mx.inc("serve_tokens_total", 1)
                seq.generated.append(tok)
                tokens[seq.slot] = tok
                positions[seq.slot] = prompt.size
                draft_n[seq.slot] = prompt.size
                active[seq.slot] = True
                if seq.done(target.max_len):
                    evict(seq.slot)
            else:
                # Chunked: the slot activates once BOTH ingests finish
                # (a full target prefix hit skips only the target's).
                t_next = None if covered >= prompt.size - 1 else covered
                ingest[seq.slot] = [prompt, t_next, 0, 0.0]
        # ---- ingestion: one chunk per engine per slot per iteration --
        for slot in sorted(ingest):
            prompt, t_next, d_next, acc = ingest[slot]
            seq = sched.active[slot]
            t0 = tracer.now()
            if t_next is not None:
                ids, n = target.chunk_ids(prompt, t_next)
                host.ensure_pages(slot, t_next + n)
                with tracer.span("prefill_chunk", rid=repr(seq.request.rid),
                                 slot=slot, start=t_next):
                    cache, nl = target.chunk_prefill_step(
                        params, cache, host.device_row(slot), ids, t_next,
                        n,
                    )
                    if t_next + n >= prompt.size:
                        tok = target._pick(sampler, nl.cpu().numpy(), slot)
                        seq.generated.append(tok)
                        tokens[slot] = tok
                        positions[slot] = prompt.size
                        host.register_prefix(slot, prompt)
                        t_next = None
                    else:
                        t_next += n
            if d_next < prompt.size:
                ids, n = draft.chunk_ids(prompt, d_next)
                dhost.ensure_pages(slot, d_next + n)
                with tracer.span("prefill_chunk", rid=repr(seq.request.rid),
                                 slot=slot, start=d_next):
                    dcache, _ = draft.chunk_prefill_step(
                        draft_params, dcache, dhost.device_row(slot), ids,
                        d_next, n,
                    )
                d_next += n
            dt = tracer.now() - t0
            useful += 1
            if t_next is None and d_next >= prompt.size:
                del ingest[slot]
                if not seq.generated:
                    # Full target prefix hit: the first token comes from
                    # the first round; decode the last prompt token at
                    # its own position.
                    positions[slot] = prompt.size - 1
                    tokens[slot] = int(prompt[-1])
                else:
                    seq.t_first_token = tracer.now()
                    if mx.enabled:
                        mx.observe("serve_prefill_s", acc + dt)
                        mx.inc("serve_tokens_total", 1)
                # The draft holds [0, prompt.size) either way; with a
                # prefix hit the first proposal step rewrites position
                # prompt.size - 1 with identical content.
                draft_n[slot] = positions[slot]
                active[slot] = True
                if seq.done(target.max_len):
                    evict(slot)
            else:
                ingest[slot][1] = t_next
                ingest[slot][2] = d_next
                ingest[slot][3] = acc + dt
        # ---- one speculative round (or plain-decode fallback) --------
        n_active = int(active.sum())
        if n_active:
            live = np.nonzero(active)[0]
            if not (positions[live] + k + 1 <= target.max_len).all():
                useful += _plain_round(target, params, host, sched, sampler,
                                       positions, tokens, active, ingest,
                                       evict, cache)
            else:
                cache, dcache = _speculative_round(
                    target, params, draft, draft_params, host, dhost, sched,
                    sampler, positions, tokens, active, ingest, draft_n,
                    token_at, evict, cache, dcache, k)
                useful += n_active
        if mx.enabled:
            mx.gauge("serve_kv_pages_in_use", host.pool.pages_in_use)
        if useful:
            sched.record_iteration(useful)
        elif not ingest and not sched.active and sched.waiting:
            raise RuntimeError(
                "page pool cannot hold the next waiting prompt "
                f"({int(sched.waiting[0][1].prompt.size)} tokens, "
                f"{host.pool.free_pages} target / "
                f"{dhost.pool.free_pages} draft free pages of "
                f"{target.paged_spec.page_size}) — size the pools larger "
                "(num_pages / --kv-pages)"
            )
    sched.paged_stats = dict(target.paged_stats(host),
                             draft_pages_in_use_peak=dhost.pages_in_use_peak)
    sched.prefix_stats = target.prefix_stats(host, requests)
    return sched


def _plain_round(target, params, host, sched, sampler, positions, tokens,
                 active, ingest, evict, cache) -> int:
    """Degrade: one plain decode step for the whole batch (the verify
    span cannot shrink near max_len). Returns the slots it advanced."""
    tracer = get_tracer()
    mx = get_metrics()
    n_active = int(active.sum())
    for slot in np.nonzero(active)[0]:
        host.ensure_writable(cache, int(slot), int(positions[slot]))
    t0 = tracer.now()
    with tracer.span("decode_step", active=n_active):
        _, logits = target.paged_decode_step(
            params, cache, host.device_table(),
            *target.step_inputs(positions, tokens, active),
        )
        logits_np = logits.cpu().numpy()
    dt = tracer.now() - t0
    sched.record_decode_step(n_active)
    tracer.counter("batch_occupancy", n_active)
    if mx.enabled:
        mx.observe("serve_decode_step_s", dt)
    for slot, seq in list(sched.active.items()):
        if slot in ingest or not active[slot]:
            continue
        tok = target._pick(sampler, logits_np[slot], slot)
        if not seq.generated:
            seq.t_first_token = tracer.now()
        else:
            seq.token_times.append(dt)
        seq.generated.append(tok)
        tokens[slot] = tok
        positions[slot] += 1
        # The plain step leaves the draft further behind; the catch-up
        # loop replays the known tokens once rounds resume.
        if seq.done(target.max_len):
            evict(slot)
    return n_active


def _speculative_round(target, params, draft, draft_params, host, dhost,
                       sched, sampler, positions, tokens, active, ingest,
                       draft_n, token_at, evict, cache, dcache, k):
    """Draft catch-up, k proposal steps, one verify step, then accept or
    roll back per slot on the host. Returns (cache, dcache)."""
    tracer = get_tracer()
    n_active = int(active.sum())
    live = np.nonzero(active)[0]
    t0 = tracer.now()
    with tracer.span("draft_round", active=n_active, k=k):
        # 1. Catch-up: slots whose draft cache is short replay the KNOWN
        # tokens at the missing positions (logits discarded). A full
        # accept leaves one hole; plain fallback rounds can leave more.
        while True:
            sync = active & (draft_n < positions)
            if not sync.any():
                break
            stoks = tokens.copy()
            spos = positions.copy()
            for slot in np.nonzero(sync)[0]:
                p = int(draft_n[slot])
                stoks[slot] = token_at(sched.active[int(slot)], p)
                spos[slot] = p
                dhost.ensure_writable(dcache, int(slot), p)
            draft.paged_decode_step(
                draft_params, dcache, dhost.device_table(),
                *draft.step_inputs(spos, stoks, sync),
            )
            draft_n[sync] += 1
        # 2. k proposal steps over the active set.
        proposals = np.zeros((target.num_slots, k), np.int64)
        draft_dists: List[np.ndarray] = []
        cur_tok = tokens.copy()
        cur_pos = positions.copy()
        for i in range(k):
            for slot in live:
                dhost.ensure_writable(dcache, int(slot), int(cur_pos[slot]))
            _, dlogits = draft.paged_decode_step(
                draft_params, dcache, dhost.device_table(),
                *draft.step_inputs(cur_pos, cur_tok, active),
            )
            dlog = dlogits.cpu().numpy()
            if sampler is not None:
                qs = np.zeros((target.num_slots, dlog.shape[-1]),
                              np.float64)
            for slot in live:
                if sampler is None:
                    d = int(np.argmax(dlog[slot]))
                else:
                    qs[slot] = sampler.dist(dlog[slot])
                    d = sampler.sample_dist(qs[slot], int(slot))
                proposals[slot, i] = d
            if sampler is not None:
                draft_dists.append(qs)
            draft_n[live] = cur_pos[live] + 1
            cur_tok = proposals[:, i].copy()
            cur_pos = cur_pos + 1
    # 3. One verify step: the target scores [last_token, d_1..d_k] at
    # positions pos..pos+k.
    tokens_chunk = np.concatenate([tokens[:, None], proposals], axis=1)
    for slot in live:
        for p in range(int(positions[slot]), int(positions[slot]) + k + 1):
            host.ensure_writable(cache, int(slot), p)
    dev_pos, dev_chunk, dev_active = target.step_inputs(
        positions, tokens_chunk, active)
    with tracer.span("verify_step", active=n_active):
        _, vlogits = target.paged_verify_step(
            params, cache, host.device_table(), dev_pos, dev_chunk,
            dev_active,
        )
        vlog = vlogits.cpu().numpy()
    dt = tracer.now() - t0
    tracer.counter("batch_occupancy", n_active)
    # 4. Accept or roll back per slot, on the host.
    total_emitted = 0
    for slot, seq in list(sched.active.items()):
        if slot in ingest or not active[slot]:
            continue
        if sampler is None:
            emitted = greedy_verify(vlog[slot], proposals[slot])
        else:
            emitted = rejection_verify(
                vlog[slot], proposals[slot],
                [q[slot] for q in draft_dists], sampler, slot,
            )
        sched.record_accept_len(len(emitted))
        kept = 0
        finished = False
        per_tok = dt / len(emitted)
        for tok in emitted:
            if not seq.generated:
                seq.t_first_token = tracer.now()
            else:
                seq.token_times.append(per_tok)
            seq.generated.append(int(tok))
            kept += 1
            if seq.done(target.max_len):
                finished = True
                break
        total_emitted += kept
        positions[slot] += kept
        tokens[slot] = int(seq.generated[-1])
        if finished:
            evict(slot)
            continue
        if kept < k + 1:
            # Rejected suffix: both caches roll back by truncating the
            # block table; no KV copies.
            host.truncate(slot, int(positions[slot]))
            dhost.truncate(slot, int(positions[slot]))
            draft_n[slot] = positions[slot]
        # kept == k+1: the draft is one position short (the bonus
        # token's hole); the next round's catch-up step fills it.
    sched.record_verify_step(n_active, total_emitted)
    return cache, dcache
