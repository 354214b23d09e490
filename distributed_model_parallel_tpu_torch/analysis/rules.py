"""The collective-contract rule registry (port of `analysis/rules.py`).

The reference's rules read a parsed, classified HLO module. Here each
rule reads the collectives one rank really issued in one step
(`analysis/record.py`), classified against the mesh
(`analysis/collectives.py`), and the notes the step left (a stage's
backward starting, a quantized projection GEMM). The ids, severities
and contract sentences are the reference's, word for word; what
a rule checks is the same contract stated over the port's program:

* a ring permutation hop is one send of this rank (the reference counts
  collective-permute instructions, one per hop);
* a scope word (`moe_ring`, `serve_ring`, `dcn_wire`, ...) stands for the
  reference's `named_scope` tag;
* an order in the issue sequence stands for a data dependency in the
  HLO graph: the port issues every collective eagerly, so a collective
  issued before an op ran cannot depend on it;
* a dtype contract reads the dtype handed to each hop, and the quantized
  decode contract the quantized GEMM calls (`note("dot")`), beside K4's
  launch counter on the card, since the port has no traced dots.

A rule with no counterpart in a torch program stays registered with its
reason (`Rule.no_counterpart`): where it applies, `run_rules` reports
"no counterpart: <reason>" as an exempted finding, never a violation.

Intended deviations are exemptions, as in the reference: a `LintTarget`
carries `exemptions={rule_id: reason}`; the finding is still computed
and reported but does not count as a violation.

Imports torch only through `analysis/record.py` (no engine): the rule
tests build records by hand.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

from distributed_model_parallel_tpu_torch.analysis.collectives import (
    ClassifiedCollective,
    MeshModel,
    classify,
    monolithic_over,
    nonscalar_all_reduces,
    ring_sends_over,
)
from distributed_model_parallel_tpu_torch.analysis.record import (
    Note,
    Record,
)

DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s8": 1, "u8": 1, "s32": 4,
               "f64": 8, "s64": 8, "pred": 1}


@dataclasses.dataclass(frozen=True)
class LintTarget:
    """What the lint driver ran: engine, mode, mesh facts, and the
    expectations rules pin against. The reference's fields keep their
    names and meanings; its trace-level records (`ring_dtypes`,
    `dcn_ring_records`, `decode_dot_records`, `plan_collective_records`)
    have no field here, because the recorded step itself carries each
    hop's dtype, elements, scope and axes. The port adds the facts only
    the engine knows: the parameter shapes this rank holds at rest, the
    pipeline's microbatches and this rank's stage, and the K4 launches
    of the step on the card."""

    name: str
    # dp | ddp | fsdp | tp | sp | sp_lm | pipeline | serve | cm_ag |
    # cm_rs | ep | plan
    engine: str
    grad_reduction: str = "monolithic"
    collective_matmul: bool = False
    bf16: bool = False
    donate: bool = False

    data_axes: Tuple[str, ...] = ("data",)
    ici_axis: Optional[str] = "data"
    dcn_axis: Optional[str] = None
    ici_size: int = 1
    dcn_size: int = 1
    cm_axis: Optional[str] = None

    bucket_plans: Tuple[Tuple[Tuple[int, str], ...], ...] = ()
    overlap_segments: int = 0

    expected_permutes: Optional[int] = None
    cm_min_ring_permutes: int = 0
    serve_decode_permutes: Optional[int] = None
    speculative_k: int = 0
    spec_verify_permutes: Optional[int] = None

    fsdp_full_leaf_shapes: Tuple[Tuple[int, ...], ...] = ()
    n_param_leaves: int = 0
    state_leaf_shapes: Tuple[Tuple[int, ...], ...] = ()
    # The parameter shapes this rank holds between steps (the port's
    # counterpart of the compiled step's entry parameters).
    at_rest_shapes: Tuple[Tuple[int, ...], ...] = ()

    moe_dispatch: str = "gspmd"
    moe_ring_permutes: Optional[int] = None

    dcn_compression: str = "none"
    dcn_wire_chunks: Tuple[Tuple[int, str], ...] = ()
    dcn_wire_hops: Optional[int] = None
    dcn_gather_chunks: Tuple[Tuple[int, str], ...] = ()

    compute_dtype: Optional[str] = None
    quant_dot_count: Optional[int] = None
    head_weight_shape: Optional[Tuple[int, ...]] = None
    # K4 launches the step made (None off the card, where the wrapper
    # runs its plain version and counts nothing).
    k4_launches: Optional[int] = None

    plan_axes: Tuple[Tuple[str, int], ...] = ()
    plan_schedule: str = "gpipe"
    plan_virtual: int = 1
    plan_microbatches: int = 1
    plan_stage_index: int = 0

    exemptions: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    message: str
    instruction: Optional[str] = None
    exempted: bool = False
    exemption_reason: str = ""


@dataclasses.dataclass
class LintContext:
    """One recorded step, classified, handed to every applicable rule."""

    target: LintTarget
    records: List[Record]
    notes: List[Note]
    mesh: MeshModel
    collectives: List[ClassifiedCollective]

    @classmethod
    def build(cls, target: LintTarget, events, mesh: MeshModel
              ) -> "LintContext":
        records = [e for e in events if isinstance(e, Record)]
        notes = [e for e in events if isinstance(e, Note)]
        return cls(target, records, notes, mesh, classify(records, mesh))

    def finding(self, rule_id: str, message: str,
                instruction: Optional[str] = None) -> Finding:
        return Finding(rule_id, REGISTRY[rule_id].severity, message,
                       instruction)

    # Shared helpers -------------------------------------------------

    def scoped(self, word: str) -> List[ClassifiedCollective]:
        """Collectives whose scope carries `word` as a whole word (a
        backward hop's scope is its forward's: the same site issues
        both)."""
        return [c for c in self.collectives if _scope_word(word, c.scope)]

    def marks(self, kind: str, **match) -> List[Note]:
        return [n for n in self.notes if n.kind == kind and all(
            n.get(k) == v for k, v in match.items())]

    def data_ring_reductions(self) -> List[ClassifiedCollective]:
        """The bucket halves over the intra-slice fabric: the
        reduce-scatter and all-gather the Reducer issues per bucket
        (`ops/grad_reduction.py`), each a ring of S-1 hops in NCCL."""
        t = self.target
        return [c for c in self.scoped("bucket_ring")
                if c.kind in ("reduce_scatter", "all_gather")
                and c.axes is not None and c.axes == {t.ici_axis}]

    def total_buckets(self) -> int:
        return sum(len(p) for p in self.target.bucket_plans)

    def dcn_shard_shapes(self) -> Counter:
        """Expected multiset of (elems, dtype) for the per-bucket
        cross-slice all-reduce: each bucket's 1/ici shard of its padded
        flat buffer."""
        t = self.target
        c: Counter = Counter()
        for plan in t.bucket_plans:
            for padded, dt in plan:
                c[(padded // t.ici_size, dt)] += 1
        return c


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    contract: str
    applies: Callable[[LintTarget], bool]
    check: Callable[[LintContext], List[Finding]]
    # Why the contract has no counterpart in a torch program ("" = it
    # has one).
    no_counterpart: str = ""


REGISTRY: Dict[str, Rule] = {}


def rule(*, id: str, severity: str, contract: str,
         applies: Callable[[LintTarget], bool], no_counterpart: str = ""):
    def deco(fn):
        if id in REGISTRY:
            raise ValueError(f"duplicate rule id {id!r}")
        REGISTRY[id] = Rule(id, severity, contract, applies, fn,
                            no_counterpart)
        return fn
    return deco


def run_rules(ctx: LintContext) -> List[Finding]:
    """Run every applicable rule; exempted findings come back flagged
    (reported, not counted), as do the no-counterpart reports."""
    out: List[Finding] = []
    for r in REGISTRY.values():
        if not r.applies(ctx.target):
            continue
        if r.no_counterpart:
            out.append(Finding(r.id, r.severity,
                               f"no counterpart: {r.no_counterpart}",
                               exempted=True,
                               exemption_reason="no counterpart"))
            continue
        for f in r.check(ctx):
            reason = ctx.target.exemptions.get(r.id)
            if reason is not None:
                f = dataclasses.replace(f, exempted=True,
                                        exemption_reason=reason)
            out.append(f)
    return out


def _is_reducer(t: LintTarget) -> bool:
    return ((t.grad_reduction in ("bucketed", "overlapped")
             or t.dcn_compression != "none")
            and t.engine in ("ddp", "fsdp", "sp_lm"))


def _scope_word(word: str, scope: str) -> bool:
    return bool(re.search(rf"\b{re.escape(word)}\b", scope))


def _state_elems(t: LintTarget) -> set:
    """Element counts a BatchNorm statistics all-reduce may carry: a
    state leaf, or the port's stacked (mean, mean of squares) pair."""
    out = set()
    for s in t.state_leaf_shapes:
        n = math.prod(s) if s else 1
        out |= {n, 2 * n}
    return out


# ------------------------------------------------------------------ rules


@rule(
    id="dcn-grad-all-reduce", severity="error",
    contract=(
        "On bucketed/overlapped paths over a hybrid dcn x ici mesh, no "
        "all-reduce crossing 'dcn' may carry more than one bucket's "
        "1/ici shard — the slow fabric never sees a full gradient."
    ),
    applies=lambda t: _is_reducer(t) and t.dcn_size > 1,
)
def _dcn_grad_all_reduce(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    limit = 0
    for plan in t.bucket_plans:
        for padded, dt in plan:
            limit = max(limit,
                        (padded // t.ici_size) * DTYPE_BYTES.get(dt, 4))
    return [ctx.finding(
        "dcn-grad-all-reduce",
        f"{c.name}: {c.payload_bytes} B all-reduce crosses "
        f"'{t.dcn_axis}' (largest allowed bucket shard: {limit} B)",
        c.name)
        for c in nonscalar_all_reduces(ctx.collectives)
        if c.crosses(t.dcn_axis) and c.payload_bytes > limit]


@rule(
    id="bucket-ring-permutes", severity="error",
    contract=(
        "Each bucket reduces as chunked ppermute rings: exactly "
        "2(S-1) collective-permutes per bucket over the intra-slice "
        "fabric (ring reduce-scatter + ring all-gather), summed over "
        "the per-segment bucket plans."
    ),
    applies=_is_reducer,
)
def _bucket_ring_permutes(ctx: LintContext) -> List[Finding]:
    # The port's bucket halves are one NCCL reduce-scatter and one
    # all-gather over the slice, each a ring of S-1 hops: 2(S-1) hops a
    # bucket is two such calls a bucket.
    t = ctx.target
    if t.ici_size < 2:
        return []
    halves = ctx.data_ring_reductions()
    hops = (t.ici_size - 1) * len(halves)
    expected = 2 * (t.ici_size - 1) * ctx.total_buckets()
    if hops != expected:
        return [ctx.finding(
            "bucket-ring-permutes",
            f"{len(halves)} bucket reduce-scatter/all-gather call(s) over "
            f"'{t.ici_axis}' = {hops} ring hops, expected "
            f"2*({t.ici_size}-1)*{ctx.total_buckets()} = {expected}")]
    return []


@rule(
    id="dcn-bucket-psum-shard", severity="error",
    contract=(
        "On a hybrid mesh, each bucket crosses 'dcn' exactly once, as "
        "an all-reduce shape-pinned at the bucket's 1/ici shard of its "
        "padded flat buffer. (Compressed combos carry NO dcn "
        "all-reduce at all — their hop contract is "
        "dcn-compressed-payload's.)"
    ),
    applies=lambda t: _is_reducer(t) and t.dcn_size > 1
    and t.dcn_compression == "none",
)
def _dcn_bucket_psum_shard(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    expected = ctx.dcn_shard_shapes()
    actual: Counter = Counter(
        (c.elems, c.dtype) for c in nonscalar_all_reduces(ctx.collectives)
        if c.axes is not None and c.axes == {t.dcn_axis})
    if actual != expected:
        return [ctx.finding(
            "dcn-bucket-psum-shard",
            f"dcn-only all-reduce (elems, dtype) {dict(actual)} != "
            f"expected per-bucket 1/ici shards {dict(expected)}")]
    return []


@rule(
    id="no-grad-all-reduce", severity="error",
    contract=(
        "Bucketed/overlapped steps keep ZERO grad-sized all-reduces "
        "over the data fabric: every non-scalar all-reduce touching "
        "the data axes must be either a pinned per-bucket dcn shard or "
        "a BatchNorm statistics reduction (state-leaf shaped)."
    ),
    applies=_is_reducer,
)
def _no_grad_all_reduce(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    allowed_state = _state_elems(t)
    dcn_shards = ctx.dcn_shard_shapes()
    out = []
    for c in nonscalar_all_reduces(ctx.collectives):
        if c.axes is None:
            out.append(ctx.finding(
                "no-grad-all-reduce",
                f"{c.name}: unclassifiable ranks on a non-scalar "
                "all-reduce", c.name))
            continue
        if not (c.axes & set(t.data_axes)):
            continue  # another fabric's reduction ('seq', 'model', ...)
        if c.axes == {t.dcn_axis} and (c.elems, c.dtype) in dcn_shards:
            continue  # the pinned cross-slice bucket hop
        if c.elems in allowed_state:
            continue  # BN batch statistics
        out.append(ctx.finding(
            "no-grad-all-reduce",
            f"{c.name}: non-scalar all-reduce over {sorted(c.axes)} "
            f"carrying {c.elems} x {c.dtype} — grad-sized traffic "
            "outside the bucket rings", c.name))
    return out


@rule(
    id="cm-ring-permutes", severity="error",
    contract=(
        "A collective-matmul ring is exactly S-1 collective-permutes "
        "per kernel (op-level pin); an opted-in engine step carries at "
        "least its projection sites' worth of ring permutes over the "
        "cm axis."
    ),
    applies=lambda t: t.engine in ("cm_ag", "cm_rs")
    or (t.collective_matmul and t.cm_axis is not None),
)
def _cm_ring_permutes(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    rings = ring_sends_over(ctx.collectives, t.cm_axis)
    if t.expected_permutes is not None:
        if len(rings) != t.expected_permutes:
            return [ctx.finding(
                "cm-ring-permutes",
                f"{len(rings)} ring hops over '{t.cm_axis}', expected "
                f"exactly {t.expected_permutes}")]
    elif len(rings) < t.cm_min_ring_permutes:
        return [ctx.finding(
            "cm-ring-permutes",
            f"{len(rings)} ring hops over '{t.cm_axis}', expected >= "
            f"{t.cm_min_ring_permutes} (the opted-in projection sites' "
            "rings)")]
    return []


@rule(
    id="cm-monolithic-collective", severity="error",
    contract=(
        "An opted-in collective-matmul site leaves NO monolithic "
        "all-gather/reduce-scatter on its axis: op-level kernels must "
        "be permute-only; SP engine steps (whose only cm-axis gathers "
        "would be the rings' replacements) must keep zero. The TP "
        "engine is judged only at op level — its embedding/head keep "
        "legitimate partitioner gathers."
    ),
    applies=lambda t: t.engine in ("cm_ag", "cm_rs")
    or (t.collective_matmul and t.engine in ("sp", "sp_lm")),
)
def _cm_monolithic(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    if t.engine in ("cm_ag", "cm_rs"):
        bad = [c for c in ctx.collectives
               if c.kind in ("all_gather", "reduce_scatter", "all_reduce")]
    else:
        bad = [c for c in monolithic_over(ctx.collectives, t.cm_axis)
               if _scope_word("cm_ring", c.scope)]
    return [ctx.finding(
        "cm-monolithic-collective",
        f"{c.name}: monolithic {c.kind} on the opted-in '{t.cm_axis}' "
        "ring path", c.name) for c in bad]


@rule(
    id="fsdp-at-rest-sharded", severity="error",
    contract=(
        "FSDP parameters are never fully materialized at rest: no "
        "entry parameter of the compiled step may carry the FULL shape "
        "of a shardable leaf (every leaf >= min_shard_elems with a "
        "divisible dim lives 1/N on device)."
    ),
    applies=lambda t: t.engine == "fsdp",
)
def _fsdp_at_rest(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    if not t.fsdp_full_leaf_shapes:
        return [ctx.finding(
            "fsdp-at-rest-sharded",
            "the at-rest policy shards nothing (no shardable leaves) — "
            "the contract is vacuous for this model/mesh")]
    full = set(t.fsdp_full_leaf_shapes)
    return [ctx.finding(
        "fsdp-at-rest-sharded",
        f"a parameter held at rest has the full shape {s} of a shardable "
        "leaf — materialized at rest") for s in t.at_rest_shapes
        if s in full]


@rule(
    id="overlap-first-bucket-free", severity="error",
    contract=(
        "Under grad_reduction='overlapped', the FIRST-fired bucket's "
        "ring permutes (last segment's — late layers differentiate "
        "first) carry no transitive dependency on segment 0's backward "
        "ops; segment 0's own bucket MUST depend on them (the control "
        "that keeps the analysis non-vacuous)."
    ),
    applies=lambda t: t.grad_reduction == "overlapped"
    and t.engine in ("ddp", "fsdp", "sp_lm") and t.ici_size > 1,
)
def _overlap_first_bucket(ctx: LintContext) -> List[Finding]:
    # An eager step cannot make a collective depend on an op that runs
    # after it was issued: the first bucket is free of segment 0's
    # backward iff it was issued before that backward began.
    t = ctx.target
    s = t.overlap_segments
    first = ctx.scoped(f"grad_reduce_stage{s - 1}")
    bwd0 = ctx.marks("bwd_stage", stage=0)
    out = []
    if not first:
        out.append(ctx.finding(
            "overlap-first-bucket-free",
            f"no collectives scoped grad_reduce_stage{s - 1} — the "
            "first-fired bucket left no trace (scopes moved?)"))
    if not bwd0:
        out.append(ctx.finding(
            "overlap-first-bucket-free",
            "no bwd_stage note for stage 0 — segment-0 backward left no "
            "trace (notes moved?)"))
    if out:
        return out
    start0 = bwd0[0].seq
    for c in first:
        if c.record.seq > start0:
            out.append(ctx.finding(
                "overlap-first-bucket-free",
                f"first-fired bucket collective {c.name} issued after "
                "segment-0 backward began — the eager firing serialized",
                c.name))
    last = ctx.scoped("grad_reduce_stage0")
    if not last or not all(c.record.seq > start0 for c in last):
        out.append(ctx.finding(
            "overlap-first-bucket-free",
            "positive control failed: segment 0's own bucket was not "
            "issued after segment-0 backward began — the order analysis "
            "is vacuous"))
    return out


@rule(
    id="prefetch-gather-free", severity="error",
    contract=(
        "FSDP overlapped: the prefetched all-gather of segment k-1's "
        "weights depends only on the parameter shards — never on ANY "
        "segment's bucket-ring ops — so the scheduler may hoist it "
        "behind the in-flight reduction."
    ),
    applies=lambda t: t.engine == "fsdp"
    and t.grad_reduction == "overlapped",
)
def _prefetch_gather_free(ctx: LintContext) -> List[Finding]:
    # Eager counterpart: the prefetched gather of segment k is issued
    # while the reductions are in flight, before ANY reduction is
    # joined (no `reduce_wait` note precedes it) and before segment
    # k+1's backward begins (so it hides behind it).
    t = ctx.target
    reduce_ops = [c for k in range(t.overlap_segments)
                  for c in ctx.scoped(f"grad_reduce_stage{k}")]
    if not reduce_ops:
        return [ctx.finding(
            "prefetch-gather-free",
            "no grad_reduce_stage* scoped collectives — the reduction "
            "left no trace (scopes moved?)")]
    waits = ctx.marks("reduce_wait")
    first_wait = waits[0].seq if waits else math.inf
    out = []
    for k in range(t.overlap_segments - 1):
        gathers = [c for c in ctx.scoped(f"prefetch_gather_stage{k}")
                   if c.kind == "all_gather"]
        if not gathers:
            out.append(ctx.finding(
                "prefetch-gather-free",
                f"no prefetched all-gather scoped prefetch_gather_stage{k}"))
            continue
        nxt = ctx.marks("bwd_stage", stage=k + 1)
        bound = min(first_wait, nxt[0].seq if nxt else math.inf)
        for g in gathers:
            if g.record.seq > bound:
                out.append(ctx.finding(
                    "prefetch-gather-free",
                    f"prefetch gather {g.name} (segment {k}) issued after "
                    "a bucket reduction was joined or after segment "
                    f"{k + 1}'s backward began — the ZeRO overlap "
                    "serialized", g.name))
    return out


def _ring_and_monolithic(ctx: LintContext, rule_id: str, expected: int,
                         what: str) -> List[Finding]:
    # The port's step returns every slot's logits to every rank (one
    # `serve_logits` all-gather after the head, so each rank samples the
    # whole batch); that gather carries logits, not a projection's
    # operand, and is the only monolithic collective the rule lets by.
    t = ctx.target
    out = []
    tagged = [c for c in ctx.scoped("serve_ring") if c.is_send]
    if len(tagged) != expected:
        out.append(ctx.finding(
            rule_id,
            f"{len(tagged)} serve_ring-scoped hops{what}, expected "
            f"exactly {expected} (4 rings/block x (S-1) hops)"))
    for c in monolithic_over(ctx.collectives, t.cm_axis):
        if _scope_word("serve_logits", c.scope):
            continue
        out.append(ctx.finding(
            rule_id,
            f"{c.name}: monolithic {c.kind} crossing '{t.cm_axis}' on an "
            "opted-in decode step", c.name))
    return out


@rule(
    id="serve-decode-ring", severity="error",
    contract=(
        "An opted-in serving decode step rides the chunked rings: "
        "exactly 4*layers*(S-1) `serve_ring`-tagged collective-"
        "permutes (one ag_matmul/matmul_rs ring per qkv / attn-out / "
        "ffn-in / ffn-out projection, no backward) and ZERO monolithic "
        "all-gather/reduce-scatter crossing the TP axis — the decode "
        "projections never fall back to the partitioner's fused "
        "collectives."
    ),
    applies=lambda t: t.engine == "serve" and t.collective_matmul
    and not t.speculative_k,
)
def _serve_decode_ring(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    if t.serve_decode_permutes is None:
        return [ctx.finding(
            "serve-decode-ring",
            "no serve_decode_permutes expectation on an opted-in "
            "serving combo — the ring pin was not checked")]
    return _ring_and_monolithic(ctx, "serve-decode-ring",
                                t.serve_decode_permutes, "")


@rule(
    id="spec-verify-step", severity="error",
    contract=(
        "A speculative verify step on an opted-in serving combo "
        "amortizes k+1 scored positions over ONE decode step's wire "
        "traffic: exactly 4*layers*(S-1) `serve_ring`-tagged "
        "collective-permutes (the chunk axis rides the rings' local "
        "operand, never the fabric) and ZERO monolithic all-gather/"
        "reduce-scatter crossing the TP axis — if verify cost scaled "
        "with k on the wire, speculative decoding's win would vanish "
        "at exactly the batch sizes it targets."
    ),
    applies=lambda t: t.engine == "serve" and t.collective_matmul
    and t.speculative_k > 0,
)
def _spec_verify_step(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    if t.spec_verify_permutes is None:
        return [ctx.finding(
            "spec-verify-step",
            "no spec_verify_permutes expectation on a speculative "
            "serving combo — the verify ring pin was not checked")]
    return _ring_and_monolithic(
        ctx, "spec-verify-step", t.spec_verify_permutes,
        f" in the verify step (k={t.speculative_k})")


@rule(
    id="decode-quantized-matmul", severity="error",
    contract=(
        "An opted-in quantized decode step runs EVERY projection GEMM "
        "in the declared arithmetic: exactly 4*layers quantized "
        "dot_generals per step (4*layers*S with the opted-in rings — "
        "S chunk dots per ring), ZERO f32 dot_generals on projection "
        "shapes, and the head matmul still f32 (logits feed "
        "sampling). Pinned from the traced jaxpr "
        "(`lint.jaxpr_dot_records`): compiled CPU HLO normalizes "
        "int8/bf16 dots back to f32, the bf16-ring-upcast precedent."
    ),
    applies=lambda t: (
        t.engine == "serve" and t.compute_dtype is not None
    ),
)
def _decode_quantized_matmul(ctx: LintContext) -> List[Finding]:
    # The port's dots: every projection GEMM notes ("dot", mode, shape)
    # (`ops/quant_matmul.quant_matmul`, the f32 path of
    # `layers.project`, the head); under int8 each quantized one is a
    # K4 launch on the card.
    t = ctx.target
    if t.compute_dtype not in ("int8", "bf16"):
        return [ctx.finding(
            "decode-quantized-matmul",
            f"unknown compute_dtype {t.compute_dtype!r} — the "
            "quantized-dot pin was not checked")]
    dots = ctx.marks("dot")
    if not dots or t.quant_dot_count is None:
        return [ctx.finding(
            "decode-quantized-matmul",
            "no dot notes/quant_dot_count expectation on a quantized "
            "serving combo — the compute-dtype pin was not checked")]
    out = []
    quantized = [d for d in dots if d.get("mode") == t.compute_dtype]
    if len(quantized) != t.quant_dot_count:
        out.append(ctx.finding(
            "decode-quantized-matmul",
            f"{len(quantized)} {t.compute_dtype} projection GEMMs in the "
            f"decode step, expected exactly {t.quant_dot_count}"))
    if t.compute_dtype == "int8" and t.k4_launches is not None \
            and t.k4_launches != len(quantized):
        out.append(ctx.finding(
            "decode-quantized-matmul",
            f"{t.k4_launches} K4 launches for {len(quantized)} int8 "
            "projection GEMMs — a quantized GEMM ran off the kernel"))
    for d in dots:
        shape = tuple(d.get("shape"))
        if d.get("mode") == "f32" and shape != t.head_weight_shape:
            out.append(ctx.finding(
                "decode-quantized-matmul",
                f"f32 GEMM on projection shape {shape} in an opted-in "
                f"{t.compute_dtype} decode step — the projection fell "
                "back to f32 arithmetic"))
    if t.head_weight_shape is not None:
        head = [d for d in dots
                if tuple(d.get("shape")) == t.head_weight_shape]
        if not head:
            out.append(ctx.finding(
                "decode-quantized-matmul",
                f"no GEMM on the head shape {t.head_weight_shape} — the "
                "head-matmul-stays-f32 pin was not checked"))
        for d in head:
            if d.get("mode") != "f32":
                out.append(ctx.finding(
                    "decode-quantized-matmul",
                    f"head matmul {t.head_weight_shape} ran in "
                    f"{d.get('mode')}; the head stays f32 — logits feed "
                    "sampling"))
    return out


BF16_RING_EXEMPT_SCOPES = ("kv_ring",)


def _scope_exempt(scope: str) -> bool:
    return any(_scope_word(s, scope) for s in BF16_RING_EXEMPT_SCOPES)


@rule(
    id="bf16-ring-upcast", severity="error",
    contract=(
        "Inside an opted-in bf16 region (compute_dtype=bfloat16 with "
        "collective-matmul rings), every ppermute over the cm axis "
        "carries a bf16 payload — an f32 permute is a silent upcast "
        "doubling the ring bytes. Checked from the traced jaxpr (the "
        "CPU backend's float-normalization pass rewrites compiled-HLO "
        "collectives to f32, so only trace-level dtypes carry this "
        "contract). Scopes in BF16_RING_EXEMPT_SCOPES (the KV ring's "
        "deliberate f32 wire) are exempt."
    ),
    applies=lambda t: t.bf16 and (
        t.engine in ("cm_ag", "cm_rs") or t.collective_matmul
    ),
)
def _bf16_ring_upcast(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    hops = [c for c in ctx.collectives if c.is_send]
    if not hops:
        return [ctx.finding(
            "bf16-ring-upcast",
            "no ring hops recorded for a bf16 ring combo — the dtype "
            "contract was not checked")]
    return [ctx.finding(
        "bf16-ring-upcast",
        f"f32 hop over '{t.cm_axis}' in the step (scope {c.scope!r}) — "
        "silent upcast on an opted-in bf16 ring", c.name)
        for c in hops if not _scope_exempt(c.scope)
        and c.crosses(t.cm_axis) and c.dtype == "f32"]


@rule(
    id="moe-hierarchical-a2a", severity="error",
    contract=(
        "An opted-in hierarchical MoE step keeps the token exchange on "
        "the explicit two-level path: ZERO token-sized all-to-all "
        "touching the data fabric (the flat exchange the partitioner "
        "would insert — on a hybrid mesh it would drag the full "
        "payload across 'dcn'), and EXACTLY the expected moe_ring-"
        "scoped collective-permute chain (2(I-1)+2(K-1) per exchange "
        "pair, doubled by the mirrored backward — "
        "ops/expert_dispatch.exchange_permutes)."
    ),
    applies=lambda t: t.engine == "ep"
    and t.moe_dispatch == "hierarchical",
)
def _moe_hierarchical_a2a(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    if t.moe_ring_permutes is None:
        return [ctx.finding(
            "moe-hierarchical-a2a",
            "no moe_ring_permutes expectation on an opted-in MoE combo "
            "— the exchange chain was not checked")]
    out = []
    # Payload hops only: an int8 wire's scale rides its own dcn_scale
    # sidecar hop, which exchange_permutes does not count.
    tagged = [c for c in ctx.scoped("moe_ring")
              if c.is_send and not _scope_word("dcn_scale", c.scope)]
    if len(tagged) != t.moe_ring_permutes:
        out.append(ctx.finding(
            "moe-hierarchical-a2a",
            f"{len(tagged)} moe_ring-scoped hops, expected exactly "
            f"{t.moe_ring_permutes} (2(I-1)+2(K-1) per exchange pair, "
            "forward + mirrored backward)"))
    for c in ctx.collectives:
        if c.kind == "all_to_all" and any(c.crosses(a)
                                          for a in t.data_axes):
            out.append(ctx.finding(
                "moe-hierarchical-a2a",
                f"{c.name}: {c.payload_bytes} B all-to-all touching the "
                f"data fabric {tuple(t.data_axes)} — the flat token "
                "exchange survived on an opted-in step", c.name))
    return out


DCN_WIRE_TOKEN = {"bf16": "bf16", "int8": "s8"}


def _wire_hops(c: ClassifiedCollective, k: int) -> List[Tuple[int, str]]:
    """The (elems, dtype) hops a coded cross-slice call carries: a send
    is one; the codec's all-to-all of (K, n) rows is K-1 hops of n, its
    all-gather of n elements K-1 hops of n (`ops/wire_codec.py`)."""
    if c.is_send:
        return [(c.elems, c.dtype)]
    if c.kind == "all_to_all":
        return [(c.elems // k, c.dtype)] * (k - 1)
    if c.kind == "all_gather":
        return [(c.elems, c.dtype)] * (k - 1)
    return []


@rule(
    id="dcn-compressed-payload", severity="error",
    contract=(
        "An opted-in compressed step keeps EVERY cross-'dcn' hop on "
        "the wire codec: each traced dcn-crossing ppermute is either a "
        "dcn_wire-scoped payload in the wire dtype (shape-pinned at "
        "1/2 resp. 1/4 the f32 bytes — the regrouped chunk's element "
        "count at the wire itemsize; FSDP's weight-gather ring hops "
        "pin their own fsdp_gather multiset) or, under int8, its "
        "one-scalar f32 dcn_scale sidecar; and ZERO f32 grad-, "
        "weight- or dispatch-sized "
        "payload crosses 'dcn' in the compiled HLO (no non-scalar "
        "all-reduce outside the BN-state allowlist, no all-to-all, no "
        "all-gather/reduce-scatter). Checked from the traced jaxpr "
        "like bf16-ring-upcast — the CPU backend float-normalizes "
        "bf16 collectives in compiled HLO."
    ),
    applies=lambda t: t.dcn_compression != "none" and t.dcn_size > 1,
)
def _dcn_compressed_payload(ctx: LintContext) -> List[Finding]:
    # The port's codec crosses 'dcn' as sends (the MoE exchange, FSDP's
    # gather ring) or as the reducer's coded all-to-all + all-gather;
    # each call is counted as the hops it carries (`_wire_hops`).
    t = ctx.target
    k = t.dcn_size
    wire = DCN_WIRE_TOKEN[t.dcn_compression]
    out: List[Finding] = []
    payload: List[Tuple[int, str]] = []
    gather_payload: List[Tuple[int, str]] = []
    sidecars: List[Tuple[str, int]] = []
    coded = 0
    for c in ctx.collectives:
        if c.kind == "recv" or not c.crosses(t.dcn_axis):
            continue
        if _scope_word("dcn_scale", c.scope):
            sidecars += [(c.dtype, n) for n, _ in _wire_hops(c, k)]
            coded += 1
        elif _scope_word("dcn_wire", c.scope):
            hops = _wire_hops(c, k)
            if _scope_word("fsdp_gather", c.scope):
                gather_payload += hops
            else:
                payload += hops
            coded += 1
        elif c.is_send or c.kind in ("all_to_all", "all_gather",
                                     "reduce_scatter"):
            out.append(ctx.finding(
                "dcn-compressed-payload",
                f"{c.name}: uncoded {c.kind} crosses '{t.dcn_axis}' on an "
                f"opted-in step ({c.elems} x {c.dtype}) — traffic outside "
                "the wire codec", c.name))
    if not coded:
        out.append(ctx.finding(
            "dcn-compressed-payload",
            "no coded dcn hops recorded for a compressed combo — the "
            "wire dtype/byte contract was not checked"))
        return out
    if t.dcn_wire_chunks:
        expected, actual = Counter(t.dcn_wire_chunks), Counter(payload)
        if actual != expected:
            out.append(ctx.finding(
                "dcn-compressed-payload",
                f"dcn_wire payload hops {dict(actual)} != expected "
                f"compressed chunks {dict(expected)} (elems x "
                "wire-dtype per hop)"))
    elif t.dcn_wire_hops is not None:
        if len(payload) != t.dcn_wire_hops:
            out.append(ctx.finding(
                "dcn-compressed-payload",
                f"{len(payload)} dcn_wire payload hops, expected exactly "
                f"{t.dcn_wire_hops}"))
        for elems, dt in payload:
            if dt != wire:
                out.append(ctx.finding(
                    "dcn-compressed-payload",
                    f"dcn_wire payload hop carries {dt} ({elems} elems), "
                    f"expected the {wire} wire dtype"))
    else:
        out.append(ctx.finding(
            "dcn-compressed-payload",
            "no dcn_wire_chunks/dcn_wire_hops expectation on a "
            "compressed combo — the payload pin was not checked"))
    expected_g, actual_g = (Counter(t.dcn_gather_chunks),
                            Counter(gather_payload))
    if actual_g != expected_g:
        out.append(ctx.finding(
            "dcn-compressed-payload",
            f"fsdp_gather dcn_wire hops {dict(actual_g)} != expected "
            f"compressed weight-gather chunks {dict(expected_g)} (elems "
            "x wire-dtype per ring hop)"))
    n_coded = len(payload) + len(gather_payload)
    if t.dcn_compression == "int8":
        bad = [s for s in sidecars if s != ("f32", 1)]
        for dt, elems in bad:
            out.append(ctx.finding(
                "dcn-compressed-payload",
                f"dcn_scale sidecar is {elems} x {dt}, expected one f32 "
                "scalar per hop"))
        if not bad and len(sidecars) != n_coded:
            out.append(ctx.finding(
                "dcn-compressed-payload",
                f"{len(sidecars)} dcn_scale sidecars for {n_coded} int8 "
                "payload hops — expected one per hop"))
    elif sidecars:
        out.append(ctx.finding(
            "dcn-compressed-payload",
            f"{len(sidecars)} dcn_scale sidecar(s) on a "
            f"{t.dcn_compression} combo — the cast codec has no scale"))
    if t.engine in ("ddp", "fsdp", "sp_lm"):
        allowed_state = _state_elems(t)
        for c in nonscalar_all_reduces(ctx.collectives):
            if c.crosses(t.dcn_axis) and c.elems not in allowed_state:
                out.append(ctx.finding(
                    "dcn-compressed-payload",
                    f"{c.name}: {c.payload_bytes} B all-reduce crosses "
                    f"'{t.dcn_axis}' on a compressed step — uncompressed "
                    "payload on the slow fabric", c.name))
    return out


@rule(
    id="donated-step-aliased", severity="warn",
    contract=(
        "A train step built with donate=True must alias its state "
        "buffers input->output (one alias entry per parameter/optimizer "
        "leaf); a missing alias table double-buffers the whole state "
        "every step."
    ),
    applies=lambda t: t.donate and t.n_param_leaves > 0,
    no_counterpart=(
        "the port's steps update parameters and optimizer state in place "
        "(torch.no_grad in-place ops); there is no compiled step whose "
        "inputs could be donated or double-buffered"),
)
def _donated_step_aliased(ctx: LintContext) -> List[Finding]:
    return []


@rule(
    id="collective-fabric-known", severity="warn",
    contract=(
        "Every collective's replica groups / permute pairs resolve to "
        "mesh coordinates — an unclassifiable collective means the "
        "fabric rules above ran blind on it."
    ),
    applies=lambda t: True,
)
def _collective_fabric_known(ctx: LintContext) -> List[Finding]:
    return [ctx.finding(
        "collective-fabric-known",
        f"{c.name}: {c.kind} over ranks {c.record.ranks} does not resolve "
        "to mesh coordinates", c.name)
        for c in ctx.collectives if c.axes is None]


PLAN_SEQ_SCOPE_WORDS = ("kv_ring", "ag_matmul", "matmul_rs")


def plan_wire_sends(pp: int, virtual: int, microbatches: int,
                    stage: int) -> int:
    """The stage-wire payloads a rank of stage `stage` sends in one step:
    one packed activation per microbatch for each of its chunks but the
    model's last, one packed cotangent per microbatch for each of its
    chunks but the first — whatever the schedule, since a schedule only
    reorders the ticks."""
    chunks = virtual
    up = chunks - (1 if stage == pp - 1 else 0)
    down = chunks - (1 if stage == 0 else 0)
    return microbatches * (up + down) if pp > 1 else 0


@rule(
    id="plan-wire-fabric", severity="error",
    contract=(
        "A composed plan's pipeline wire rides the stage fabric (the "
        "plan mesh's DCN contract) and nothing else: every "
        "`plan_wire`-scoped collective in the traced step is a "
        "ppermute over exactly ('stage',), and a pp>1 plan traces "
        "the schedule's exact static count (PLAN_WIRE_PPERMUTES: "
        "gpipe = forward + transpose; 1f1b/interleaved = the tick "
        "table's up + down wires) — more means the schedule unrolled "
        "instead of replaying its table."
    ),
    applies=lambda t: t.engine == "plan",
)
def _plan_wire_fabric(ctx: LintContext) -> List[Finding]:
    # The executed counterpart of the static pin: each boundary crossing
    # moves ONE packed payload (`plan_wire_sends`); a wire that sent per
    # leaf or per tick would multiply it.
    t = ctx.target
    axes_of = dict(t.plan_axes)
    pp = axes_of.get("stage", 1)
    wire = ctx.scoped("plan_wire")
    if pp > 1 and not wire:
        return [ctx.finding(
            "plan-wire-fabric",
            "no plan_wire-scoped collectives recorded on a pp>1 plan — "
            "the wire pin was not checked")]
    out = []
    for c in wire:
        if not c.is_ring_hop or c.axes != {"stage"}:
            out.append(ctx.finding(
                "plan-wire-fabric",
                f"plan_wire {c.kind} over {sorted(c.axes or ())} "
                f"({c.elems} x {c.dtype}) — the activation wire is a "
                "permutation over ('stage',) only", c.name))
    sends = [c for c in wire if c.is_send]
    expected = plan_wire_sends(pp, t.plan_virtual, t.plan_microbatches,
                               t.plan_stage_index)
    if pp > 1 and len(sends) != expected:
        out.append(ctx.finding(
            "plan-wire-fabric",
            f"{len(sends)} plan_wire payload(s) sent under the "
            f"{t.plan_schedule!r} schedule — stage {t.plan_stage_index} "
            f"sends exactly {expected} (one packed payload per "
            "microbatch and chunk boundary each way)"))
    return out


@rule(
    id="plan-seq-fabric", severity="error",
    contract=(
        "A composed plan keeps its sequence-axis rings on the ICI "
        "fabric: every kv_ring / ag_matmul / matmul_rs-scoped "
        "collective rides exactly ('seq',) — never 'stage' or "
        "'data' — and an sp>1 ring-attention plan must trace at "
        "least one kv_ring hop."
    ),
    applies=lambda t: t.engine == "plan",
)
def _plan_seq_fabric(ctx: LintContext) -> List[Finding]:
    t = ctx.target
    axes_of = dict(t.plan_axes)
    rings = [c for c in ctx.collectives
             if any(_scope_word(w, c.scope) for w in PLAN_SEQ_SCOPE_WORDS)]
    if axes_of.get("seq", 1) > 1 and not rings:
        return [ctx.finding(
            "plan-seq-fabric",
            "no seq-ring collectives recorded on an sp>1 plan — the ring "
            "pin was not checked")]
    return [ctx.finding(
        "plan-seq-fabric",
        f"seq-ring {c.kind} (scope {c.scope!r}) over "
        f"{sorted(c.axes or ())} — the rings ride ('seq',) only", c.name)
        for c in rings if c.axes != {"seq"}]


@rule(
    id="plan-grad-fabric", severity="error",
    contract=(
        "A composed plan reduces gradients as ONE fused psum over "
        "the full ('stage', 'data', 'seq') tuple under the "
        "`plan_grad` scope (complementary stage pieces + seq "
        "partials + data replicas in a single rendezvous — never a "
        "per-axis cascade), and the FSDP weight materialization — "
        "when the plan shards — is `plan_fsdp_gather`-scoped "
        "all-gathers over ('data',) only."
    ),
    applies=lambda t: t.engine == "plan",
)
def _plan_grad_fabric(ctx: LintContext) -> List[Finding]:
    # A port stage rank holds its own stage's leaves only, so the fused
    # reduction spans its stage's (data, seq) ranks: the stage pieces
    # are complementary by placement, not summed. One all-reduce a step
    # when the stage has more than one rank.
    t = ctx.target
    axes_of = dict(t.plan_axes)
    grads = ctx.scoped("plan_grad")
    want = frozenset(a for a in ("data", "seq") if axes_of.get(a, 1) > 1)
    out = []
    if want and len(grads) != 1:
        out.append(ctx.finding(
            "plan-grad-fabric",
            f"{len(grads)} plan_grad-scoped collectives recorded — the "
            "gradient reduction is ONE fused all-reduce a step"))
    for c in grads:
        if c.kind != "all_reduce" or c.axes != want:
            out.append(ctx.finding(
                "plan-grad-fabric",
                f"plan_grad {c.kind} over {sorted(c.axes or ())} — the "
                "gradient reduction is one fused all-reduce over the "
                f"stage's {sorted(want)} ranks", c.name))
    for c in ctx.scoped("plan_fsdp_gather"):
        if c.kind != "all_gather" or c.axes != {"data"}:
            out.append(ctx.finding(
                "plan-grad-fabric",
                f"plan_fsdp_gather {c.kind} over {sorted(c.axes or ())} — "
                "the ZeRO-3 weight gather rides ('data',) only", c.name))
    return out


__all__ = ["DCN_WIRE_TOKEN", "Finding", "LintContext", "LintTarget",
           "REGISTRY", "Rule", "plan_wire_sends", "rule", "run_rules"]
