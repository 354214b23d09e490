"""Pipeline model parallelism over the mesh's stage axis (port of
`parallel/pipeline.py`): `PipelineEngine` with the `gpipe`, `1f1b` and
`interleaved` schedules, `LMPipelineEngine`, and the schedules' tick
tables (`build_1f1b_schedule`, `build_interleaved_schedule`), numpy
copies whose tables equal the JAX ones element by element.

The JAX engine is one SPMD program: every device runs its own stage
through the static tick tables and the wire is a `ppermute`. Its
counterpart here is one process that drives every stage through the
same tables, each stage on its own device (`runtime/mesh.py`: stage s
on `devices[s % len(devices)]`, so on one GPU every stage shares it),
and the hop is a copy to the next stage's device. The `data` axis is
`torch.distributed` ranks, as in the data-parallel engines: each rank
runs the whole pipeline on its share of the batch; gradients (and,
without `sync_bn`, the BN running statistics) are averaged over the
ranks after the step, and SyncBN reduces the batch statistics over the
ranks (`Context.bn_group`).

A step, as in the JAX engine:

* the local batch splits into `num_microbatches` M microbatches; in
  train mode each microbatch is normalized with its own batch
  statistics, and each chunk folds its BN running statistics once per
  microbatch, in microbatch order;
* the wire carries every stage output cast to the common dtype of all
  stage inputs and outputs (bf16 under a bf16 compute dtype, unless an
  f32 leaf rides the pipeline, as the LM's logits do); the receiver
  casts back. The logits are f32 on the last stage;
* the loss is the last stage's cross-entropy sum over the local batch,
  and the gradients are divided by its valid (label != -1) row count;
* `gpipe`: the fill-drain ticks (T = M + S - 1; stage s runs microbatch
  t - s, bubble ticks are not run), and the backward is autograd
  through the whole tick loop: every stage holds the activations of all
  M microbatches, as in JAX;
* `1f1b` and `interleaved` (S stages x V chunks each, chunk l on stage
  l % S): the hand-scheduled tick program. A forward tick runs its chunk
  without a graph, keeps only the chunk's input in a ring `stash_depth`
  deep per chunk, and updates the chunk's BN statistics; a backward
  tick re-runs the chunk under autograd on that input (exact: train
  mode normalizes with batch statistics, and the dropout bits are keyed
  by (step, data rank, chunk, microbatch)), seeds it with the
  cotangent from downstream or with the loss gradient on the last
  chunk, adds the parameter gradient to the chunk's sum and sends the
  input cotangent upstream. Outputs sent at one tick arrive at the next, as the JAX
  `ppermute`s do. The recomputation's BN statistics are discarded.

Gradients and BN statistics of the three schedules agree within
floating-point reassociation: the sum over microbatches runs in another
order. `stage_local_params` is accepted for the JAX engine's API: here
each chunk's parameters, BN statistics and optimizer buffers always live
on their stage's device, so the flag changes nothing. The state's
params, BN statistics and optimizer buffers are per-chunk tuples in
logical order, the JAX engine's canonical form (`to_canonical`); a step
writes the new BN statistics back into the state's own tensors, so a
step whose stages share one device can be captured in a CUDA graph
(`training/multistep.py`). `remat=True` checkpoints each chunk, as the
JAX engine's `remat_layer` does: a chunk's forward under autograd keeps
only its input and runs again in the backward pass. MoE layers are
refused (the JAX engine refuses them too).

Stages as ranks (a composed plan's mesh, `runtime/mesh.make_plan_mesh`):
each stage is a process of its own and holds only its chunks. The same
tick tables drive it (`rank_tick_rows`), run by `run_stage_ticks`: a
rank runs its own items and, at the end of every tick, swaps one packed
payload each way with its neighbouring stage ranks (`StageWire`,
activations downstream, cotangents upstream). gpipe cannot be autograd
through one loop across processes: its forward ticks keep their graphs
and the same ticks, reversed, run the backward. `LMPipelineEngine` on
such a mesh is the reference plan's pp-only route; the gradients are
averaged over the stage's data ranks, the metrics summed over the plan,
and `to_canonical` gathers the chunks onto the plan's first rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.analysis.record import scope
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    train_state_from_jax,
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.models.gpt import lm_targets
from distributed_model_parallel_tpu_torch.models.staging import chunk_owner
from distributed_model_parallel_tpu_torch.ops.wire_codec import (
    _ppermutes_start,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    TrainState,
    _like,
    _metrics,
    place,
    step_key,
    write_back,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh, PlanMesh
from distributed_model_parallel_tpu_torch.training.metrics import (
    cross_entropy,
    valid_count,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_map,
)

# ---------------------------------------------------------------------------
# 1F1B (PipeDream-flush) tick schedule — built on the host at setup time.
# ---------------------------------------------------------------------------

# Per-(tick, stage) work kinds. IDLE ticks are pipeline bubble (the JAX
# engine runs a masked forward there; this one runs nothing).
PIPE_IDLE, PIPE_FWD, PIPE_BWD = 0, 1, 2


class Schedule1F1B(NamedTuple):
    """Static tick tables for the 1F1B schedule, all shaped (T, S).

    `work[t, s]` / `micro[t, s]` say what stage s computes at tick t;
    `recv_fwd*` / `recv_bwd*` say whether the activation (up) / cotangent
    (down) wire buffer a stage holds at the START of tick t carries a
    valid payload, and for which microbatch — the receive side of the
    schedule, derived from the sender side one tick earlier. Ring depths
    are the peak number of simultaneously-live activations / cotangents
    at any stage: the O(S) memory bound that is the point of 1F1B."""

    work: np.ndarray
    micro: np.ndarray
    recv_fwd: np.ndarray
    recv_fwd_m: np.ndarray
    recv_bwd: np.ndarray
    recv_bwd_m: np.ndarray
    num_ticks: int
    stash_depth: int
    cot_depth: int


def _min_ring_depth(intervals_per_slotkey: dict, max_key: int) -> int:
    """Smallest ring depth R such that assigning key k to slot k % R never
    overlaps two live intervals [start, end] (inclusive; arrival happens
    BEFORE compute within a tick, so reuse must be strictly later)."""
    for depth in range(1, max_key + 2):
        ok = True
        for (s, m), (start, _end) in intervals_per_slotkey.items():
            prev = intervals_per_slotkey.get((s, m - depth))
            if prev is not None and start <= prev[1]:
                ok = False
                break
        if ok:
            return depth
    return max_key + 1


def build_1f1b_schedule(num_stages: int,
                        num_microbatches: int) -> Schedule1F1B:
    """One-forward-one-backward (PipeDream-flush) tick program.

    Stage s warms up with min(S-1-s, M) forwards, then alternates
    (forward, backward) pairs, then drains the remaining backwards —
    Megatron's non-interleaved 1F1B work order. Ticks are assigned by a
    greedy lockstep simulation: at each tick a stage runs the head of its
    work queue iff its dependencies completed at an EARLIER tick (one
    ppermute hop separates producer and consumer), else it idles. The
    program length never exceeds 2M + 2(S-1) — the same fill+drain span
    as GPipe's forward+backward — while the number of microbatch
    activations any stage holds live stays <= min(S, M), independent of M
    (GPipe-through-autodiff holds all M)."""
    S, M = num_stages, num_microbatches
    if S < 1 or M < 1:
        raise ValueError(f"need S >= 1, M >= 1; got S={S}, M={M}")
    queues = []
    for s in range(S):
        warm = min(S - 1 - s, M)
        q = [(PIPE_FWD, m) for m in range(warm)]
        for i in range(M - warm):
            q.append((PIPE_FWD, warm + i))
            q.append((PIPE_BWD, i))
        q.extend((PIPE_BWD, m) for m in range(M - warm, M))
        queues.append(q)

    done_f = [[None] * M for _ in range(S)]  # tick stage s finished fwd m
    done_b = [[None] * M for _ in range(S)]
    heads = [0] * S
    work_rows, micro_rows = [], []
    t = 0
    while any(heads[s] < len(queues[s]) for s in range(S)):
        if t > 2 * M + 2 * S:  # greedy 1F1B provably fits well inside this
            raise RuntimeError(
                f"1F1B schedule deadlocked at tick {t} (S={S}, M={M})"
            )
        row_w, row_m = [PIPE_IDLE] * S, [0] * S
        for s in range(S):
            if heads[s] >= len(queues[s]):
                continue
            kind, m = queues[s][heads[s]]
            if kind == PIPE_FWD:
                ready = s == 0 or (
                    done_f[s - 1][m] is not None and done_f[s - 1][m] < t
                )
            else:
                ready = done_f[s][m] is not None and done_f[s][m] < t
                if s < S - 1:
                    ready = ready and (
                        done_b[s + 1][m] is not None and done_b[s + 1][m] < t
                    )
            if ready:
                row_w[s], row_m[s] = kind, m
        # Commit after scanning every stage: this tick's completions become
        # visible only from t+1 (the `< t` checks above), matching the
        # one-tick ppermute latency of the lockstep SPMD program.
        for s in range(S):
            if row_w[s] == PIPE_FWD:
                done_f[s][row_m[s]] = t
                heads[s] += 1
            elif row_w[s] == PIPE_BWD:
                done_b[s][row_m[s]] = t
                heads[s] += 1
        work_rows.append(row_w)
        micro_rows.append(row_m)
        t += 1

    T = t
    assert T <= 2 * M + 2 * (S - 1) or S == 1, (T, S, M)
    work = np.asarray(work_rows, np.int32)
    micro = np.asarray(micro_rows, np.int32)

    # Receive tables: what the wire buffers hold at the START of tick t is
    # whatever the neighbor put on them at tick t-1.
    recv_fwd = np.zeros((T, S), bool)
    recv_fwd_m = np.zeros((T, S), np.int32)
    recv_bwd = np.zeros((T, S), bool)
    recv_bwd_m = np.zeros((T, S), np.int32)
    for tt in range(1, T):
        for s in range(S):
            if s >= 1 and work[tt - 1, s - 1] == PIPE_FWD:
                recv_fwd[tt, s] = True
                recv_fwd_m[tt, s] = micro[tt - 1, s - 1]
            if s <= S - 2 and work[tt - 1, s + 1] == PIPE_BWD:
                recv_bwd[tt, s] = True
                recv_bwd_m[tt, s] = micro[tt - 1, s + 1]

    # Ring depths from the exact live intervals (inclusive ticks):
    # * activation stash at stage s>=1: arrival F(s-1,m)+1 .. consumption
    #   by the backward B(s,m) (stage 0 reads the resident input batch
    #   directly and never stashes);
    # * cotangent at stage s<=S-2: arrival B(s+1,m)+1 .. B(s,m).
    stash_iv = {
        (s, m): (done_f[s - 1][m] + 1, done_b[s][m])
        for s in range(1, S)
        for m in range(M)
    }
    cot_iv = {
        (s, m): (done_b[s + 1][m] + 1, done_b[s][m])
        for s in range(S - 1)
        for m in range(M)
    }
    stash_depth = _min_ring_depth(stash_iv, M - 1) if stash_iv else 1
    cot_depth = _min_ring_depth(cot_iv, M - 1) if cot_iv else 1
    if stash_depth > min(S, M):
        raise RuntimeError(  # the O(S) guarantee this schedule exists for
            f"1F1B stash depth {stash_depth} exceeds min(S, M)="
            f"{min(S, M)} at S={S}, M={M}"
        )
    return Schedule1F1B(
        work, micro, recv_fwd, recv_fwd_m, recv_bwd, recv_bwd_m,
        T, stash_depth, cot_depth,
    )


# ---------------------------------------------------------------------------
# Interleaved virtual-pipeline tick schedule (Megatron SC'21) — the (T, S, V)
# generalization of the 1F1B tables. V=1 reduces EXACTLY to
# `build_1f1b_schedule` (both pinned to the JAX tables by
# tests/test_torch_port_pipeline_schedule.py).
# ---------------------------------------------------------------------------


class ScheduleTicks(NamedTuple):
    """Static tick tables generalized over `virtual_stages` V, all shaped
    (T, S). Each physical stage owns V model chunks; `chunk[t, s]` names
    which of device s's chunks runs at tick t (the logical pipeline stage
    is `chunk * S + s`, so device s owns logical stages {s, s+S, ...} —
    Megatron's round-robin chunk placement). The recv tables gain a
    chunk column: the activation (up-ring) / cotangent (down-ring) wire
    payload a device holds at the START of tick t belongs to ring slot
    `recv_*_c * depth + recv_*_m % depth`. Ring depths are PER-CHUNK:
    the stash array is (V * stash_depth, buf)."""

    work: np.ndarray
    micro: np.ndarray
    chunk: np.ndarray
    recv_fwd: np.ndarray
    recv_fwd_m: np.ndarray
    recv_fwd_c: np.ndarray
    recv_bwd: np.ndarray
    recv_bwd_m: np.ndarray
    recv_bwd_c: np.ndarray
    num_ticks: int
    stash_depth: int
    cot_depth: int
    num_virtual: int


def build_interleaved_schedule(
    num_stages: int, num_microbatches: int, virtual_stages: int = 1
) -> ScheduleTicks:
    """Interleaved 1F1B tick program over S devices × V chunks each.

    Work order per device is Megatron's (Narayanan et al., SC'21,
    `megatron/core/pipeline_parallel/schedules.py`): microbatches are
    processed in groups of S — forward k runs chunk (k//S) % V on
    microbatch (k//(S·V))·S + k%S, backwards mirror with the chunk
    order reversed — with warmup 2(S-1-s) + (V-1)·S forwards before the
    first backward (V=1 keeps the non-interleaved min(S-1-s, M), which
    makes the V=1 tables bit-identical to `build_1f1b_schedule`). Ticks
    are assigned by the same greedy lockstep simulation: dependencies
    are between LOGICAL stages l = v·S + s (one ring-ppermute hop, so a
    consumer runs strictly after its producer's tick).

    The payoff is the span: T = 2MV + 2(S-1) chunk-ticks for 2MV
    chunk-ticks of work per device, i.e. an idle fraction of
    (S-1)/(V·M+S-1) — the 1F1B bubble divided by V (each chunk-tick is
    1/V of a stage-tick of compute, so the fill/drain cost shrinks by V
    while total compute is unchanged). The price is stash memory: early
    chunks' activations live until their late backwards, so the
    per-chunk ring depth grows past min(S, M) (bounded below by the
    exact live intervals, asserted <= min(M, 2S) here) and there are V
    rings. Megatron requires M % S == 0 for V > 1; so do we.
    """
    S, M, V = num_stages, num_microbatches, virtual_stages
    if S < 1 or M < 1 or V < 1:
        raise ValueError(f"need S, M, V >= 1; got S={S}, M={M}, V={V}")
    if V > 1 and S < 2:
        raise ValueError(
            f"interleaving needs >= 2 physical stages, got S={S}"
        )
    if V > 1 and M % S:
        raise ValueError(
            f"interleaved schedule needs num_microbatches divisible by "
            f"num_stages (Megatron's round-robin microbatch groups); "
            f"got M={M}, S={S}"
        )
    C = S * V          # logical pipeline depth
    total = M * V      # forward (and backward) chunk-ticks per device

    def fwd_item(k):
        return (PIPE_FWD, (k // C) * S + k % S, (k // S) % V)

    def bwd_item(k):
        return (PIPE_BWD, (k // C) * S + k % S, V - 1 - (k // S) % V)

    queues = []
    for s in range(S):
        warm = (
            min(S - 1 - s, M) if V == 1
            else min(2 * (S - 1 - s) + (V - 1) * S, total)
        )
        q = [fwd_item(k) for k in range(warm)]
        for i in range(total - warm):
            q.append(fwd_item(warm + i))
            q.append(bwd_item(i))
        q.extend(bwd_item(i) for i in range(total - warm, total))
        queues.append(q)

    done_f = [[None] * M for _ in range(C)]  # tick logical l finished fwd m
    done_b = [[None] * M for _ in range(C)]
    heads = [0] * S
    work_rows, micro_rows, chunk_rows = [], [], []
    t = 0
    while any(heads[s] < len(queues[s]) for s in range(S)):
        if t > 2 * total + 4 * C:
            raise RuntimeError(
                f"interleaved schedule deadlocked at tick {t} "
                f"(S={S}, M={M}, V={V})"
            )
        row_w = [PIPE_IDLE] * S
        row_m = [0] * S
        row_c = [0] * S
        for s in range(S):
            if heads[s] >= len(queues[s]):
                continue
            kind, m, v = queues[s][heads[s]]
            l = v * S + s
            if kind == PIPE_FWD:
                ready = l == 0 or (
                    done_f[l - 1][m] is not None and done_f[l - 1][m] < t
                )
            else:
                ready = done_f[l][m] is not None and done_f[l][m] < t
                if l < C - 1:
                    ready = ready and (
                        done_b[l + 1][m] is not None and done_b[l + 1][m] < t
                    )
            if ready:
                row_w[s], row_m[s], row_c[s] = kind, m, v
        # Commit after scanning every stage (one-tick ppermute latency).
        for s in range(S):
            l = row_c[s] * S + s
            if row_w[s] == PIPE_FWD:
                done_f[l][row_m[s]] = t
                heads[s] += 1
            elif row_w[s] == PIPE_BWD:
                done_b[l][row_m[s]] = t
                heads[s] += 1
        work_rows.append(row_w)
        micro_rows.append(row_m)
        chunk_rows.append(row_c)
        t += 1

    T = t
    # The bubble guarantee the schedule exists for: fill+drain only ever
    # costs the FIRST/LAST chunk's pipeline, 2(S-1) chunk-ticks total.
    assert T <= 2 * total + 2 * (S - 1) or S == 1, (T, S, M, V)
    work = np.asarray(work_rows, np.int32)
    micro = np.asarray(micro_rows, np.int32)
    chunk = np.asarray(chunk_rows, np.int32)

    # Receive tables. The wire is a RING: up payloads come from device
    # (s-1) mod S, down payloads from (s+1) mod S — the wrap edge is how
    # an activation crosses a chunk boundary (logical v·S+S-1 -> (v+1)·S
    # lives on device S-1 -> device 0). For V == 1 the wrap edge never
    # carries a valid payload (its sender would be the last / first
    # logical stage), so these tables equal the 1F1B chain tables.
    recv_fwd = np.zeros((T, S), bool)
    recv_fwd_m = np.zeros((T, S), np.int32)
    recv_fwd_c = np.zeros((T, S), np.int32)
    recv_bwd = np.zeros((T, S), bool)
    recv_bwd_m = np.zeros((T, S), np.int32)
    recv_bwd_c = np.zeros((T, S), np.int32)
    if S > 1:
        for tt in range(1, T):
            for s in range(S):
                sp = (s - 1) % S
                if work[tt - 1, sp] == PIPE_FWD:
                    l = chunk[tt - 1, sp] * S + sp
                    if l < C - 1:
                        recv_fwd[tt, s] = True
                        recv_fwd_m[tt, s] = micro[tt - 1, sp]
                        recv_fwd_c[tt, s] = (l + 1) // S
                sn = (s + 1) % S
                if work[tt - 1, sn] == PIPE_BWD:
                    l = chunk[tt - 1, sn] * S + sn
                    if l > 0:
                        recv_bwd[tt, s] = True
                        recv_bwd_m[tt, s] = micro[tt - 1, sn]
                        recv_bwd_c[tt, s] = (l - 1) // S
    # Per-chunk ring depths from the exact live intervals, keyed by
    # ((device, chunk), m) so reuse conflicts are checked within each
    # chunk's own ring (slot = chunk * depth + m % depth).
    stash_iv = {}
    cot_iv = {}
    for s in range(S):
        for v in range(V):
            l = v * S + s
            for m in range(M):
                if l >= 1:
                    stash_iv[((s, v), m)] = (
                        done_f[l - 1][m] + 1, done_b[l][m]
                    )
                if l <= C - 2:
                    cot_iv[((s, v), m)] = (
                        done_b[l + 1][m] + 1, done_b[l][m]
                    )
    stash_depth = _min_ring_depth(stash_iv, M - 1) if stash_iv else 1
    cot_depth = _min_ring_depth(cot_iv, M - 1) if cot_iv else 1
    if stash_depth > min(M, 2 * S if V > 1 else S):
        raise RuntimeError(
            f"interleaved stash depth {stash_depth} exceeds the "
            f"documented bound min(M, 2S) at S={S}, M={M}, V={V}"
        )
    return ScheduleTicks(
        work, micro, chunk,
        recv_fwd, recv_fwd_m, recv_fwd_c,
        recv_bwd, recv_bwd_m, recv_bwd_c,
        T, stash_depth, cot_depth, V,
    )


# ---------------------------------------------------------------------------
# Stages as ranks: the wire between stage ranks and the per-rank tick program
# ---------------------------------------------------------------------------


def fill_drain_rows(num_stages: int, num_microbatches: int) -> list:
    """The gpipe forward ticks: T = M + S - 1 rows of (stage, PIPE_FWD,
    microbatch, chunk 0) items, stage s running microbatch t - s."""
    S, M = num_stages, num_microbatches
    return [[(s, PIPE_FWD, t - s, 0) for s in range(S) if 0 <= t - s < M]
            for t in range(M + S - 1)]


def rank_tick_rows(schedule: str, num_stages: int, num_microbatches: int,
                   virtual_stages: int = 1):
    """(train rows, eval rows) of a pipeline whose stages are ranks.
    `gpipe`: the fill-drain forward ticks, then the same ticks reversed
    as backward ticks (stage s runs the backward of microbatch M - 1 - u
    + S - 1 - s at backward tick u), so the cotangents ride back one hop
    a tick, as the reference's reversed ppermutes carry them; `1f1b` and
    `interleaved`: the tables of `build_interleaved_schedule`. Eval runs
    the fill-drain ticks, or the interleaved forward ticks when V > 1."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    fwd = fill_drain_rows(S, M)
    if schedule == "gpipe":
        bwd = [[(s, PIPE_BWD, M - 1 - u + S - 1 - s, 0) for s in range(S)
                if 0 <= M - 1 - u + S - 1 - s < M] for u in range(M + S - 1)]
        return fwd + bwd, fwd
    sc = build_interleaved_schedule(S, M, V)
    rows = [[(s, int(sc.work[t, s]), int(sc.micro[t, s]),
              int(sc.chunk[t, s])) for s in range(S)
             if sc.work[t, s] != PIPE_IDLE] for t in range(sc.num_ticks)]
    return rows, (fwd if V == 1 else [
        [item for item in row if item[1] == PIPE_FWD] for row in rows])


class WireLeaf(NamedTuple):
    """One leaf that crosses a chunk boundary: its shape and dtype (a
    bool leaf, the LM's attention mask, rides as 0 / 1)."""

    shape: tuple
    dtype: torch.dtype


class StageWire:
    """The hops between this stage rank and the other stage ranks of its
    column (`runtime/mesh.PlanMesh.stage_ranks`). A chunk boundary's
    leaves travel packed into one flat buffer of the wire dtype, the
    reference's packed (h, mask) ppermute payload; the cotangents of its
    floating leaves travel the other way in a second one. At the end of
    a tick `exchange` issues the tick's sends and receives, activations
    and cotangents together, as one `batch_isend_irecv`
    (`ops/wire_codec._ppermutes_start`, through the host when the group
    is gloo and the tensors are CUDA). Each side derives the tick's
    pairs from the same tick rows, so only payloads that exist move.
    `hops` counts the payloads this rank sent."""

    def __init__(self, leaves, wire_dtype: torch.dtype, column, device):
        self.leaves = [WireLeaf(tuple(lf.shape), lf.dtype) for lf in leaves]
        self.dtype = wire_dtype
        self.column = tuple(column)
        self.device = torch.device(device)
        self._sizes = [int(np.prod(lf.shape)) for lf in self.leaves]
        self._float = [lf.dtype.is_floating_point for lf in self.leaves]
        self.act_numel = sum(self._sizes)
        self.cot_numel = sum(n for n, f in zip(self._sizes, self._float)
                             if f)
        self.hops = 0

    def pack(self, leaves) -> torch.Tensor:
        return torch.cat([t.detach().to(self.dtype).reshape(-1)
                          for t in leaves])

    def unpack(self, flat: torch.Tensor, grad: bool) -> list:
        """A received activation buffer -> the boundary's leaves, the
        floating ones new graph leaves that take a gradient when
        `grad`."""
        out = []
        for piece, lf, f in zip(flat.split(self._sizes), self.leaves,
                                self._float):
            piece = piece.view(lf.shape)
            out.append(piece.to(lf.dtype).requires_grad_(grad) if f
                       else piece > 0.5)
        return out

    def pack_cot(self, grads) -> torch.Tensor:
        return torch.cat([g.to(self.dtype).reshape(-1) for g in grads])

    def unpack_cot(self, flat: torch.Tensor) -> list:
        sizes = [n for n, f in zip(self._sizes, self._float) if f]
        shapes = [lf for lf, f in zip(self.leaves, self._float) if f]
        return [p.view(lf.shape).to(lf.dtype)
                for p, lf in zip(flat.split(sizes), shapes)]

    def exchange(self, up_pairs, down_pairs, up, down):
        """One tick's hops: `up_pairs` / `down_pairs` are the tick's
        (src stage, dst stage) activation / cotangent sends of this
        column, `up` / `down` this rank's payloads (None when it sends
        none). Returns the (activation, cotangent) buffers this rank
        receives, None where it receives none."""
        col, me = self.column, dist.get_rank()
        hops, mine = [], []
        for pairs, x, n in ((up_pairs, up, self.act_numel),
                            (down_pairs, down, self.cot_numel)):
            perm = [(col[a], col[b]) for a, b in pairs]
            if not any(me in pair for pair in perm):
                mine.append(None)
                continue
            if x is None:
                x = torch.zeros(n, dtype=self.dtype, device=self.device)
            else:
                self.hops += 1
            hops.append((x, perm))
            mine.append(any(dst == me for _, dst in perm))
        with scope("plan_wire"):
            outs = iter(_ppermutes_start(hops, dist.group.WORLD)()
                        if hops else [])
        got = []
        for m in mine:
            out = next(outs) if m is not None else None
            got.append(out if m else None)
        return tuple(got)


def run_stage_ticks(rows, *, num_stages: int, num_chunks: int,
                    stage_index: int, wire: Optional[StageWire], first,
                    apply, last, params, train: bool, keep: bool):
    """This stage rank's share of a tick program (`rank_tick_rows`):
    chunk l = v * S + s runs on stage s. `first(m)` is chunk 0's input
    of microbatch m, `apply(l, m, x)` runs chunk l (a list of boundary
    leaves in, a list out; the last chunk's output is its logits),
    `last(m, y)` gives the last chunk's (loss SUM, metric sums) of
    microbatch m, and `params(l)` the leaves chunk l differentiates.

    A forward item runs its chunk on the input that arrived at an
    earlier tick and puts its output on the wire (on the last chunk it
    adds the microbatch's metrics). A backward item seeds its chunk with
    the cotangent that arrived from downstream, or with d(loss sum) = 1
    on the last chunk, adds the parameter gradients to the chunk's sum
    and sends the input cotangent upstream. With `keep` (gpipe) the
    forward keeps its graph and the backward differentiates it; without
    it (1f1b, interleaved) the forward runs without a graph, keeps only
    its input, and the backward runs the chunk again under autograd on
    it. The loss lives on the last stage only and no reduction runs
    before the gradient. Returns (metric sums of this rank's last-chunk
    microbatches or None, {chunk: summed parameter gradients})."""
    S, C, me = num_stages, num_chunks, stage_index
    inbox, cots, kept, grads = {}, {}, {}, {}
    sums = None

    def floats(leaves):
        return [t for t in leaves if t.is_floating_point()]

    def differentiate(l, outs, seeds, x_leaves):
        p = list(params(l))
        xs = [t for t in x_leaves if t.requires_grad]
        g = torch.autograd.grad(outs, p + xs, seeds, allow_unused=True)
        gp = [torch.zeros_like(a) if b is None else b
              for a, b in zip(p, g)]
        grads[l] = gp if l not in grads else [
            a + b for a, b in zip(grads[l], gp)]
        return [torch.zeros_like(x) if b is None else b
                for x, b in zip(xs, g[len(p):])]

    def run_chunk(l, m, grad: bool, consume: bool):
        if l == 0:
            x_leaves, x = [], first(m)
        else:
            buf = inbox.pop((l, m)) if consume else inbox[(l, m)]
            x_leaves = wire.unpack(buf, grad)
            x = x_leaves
        with torch.set_grad_enabled(grad):
            y = apply(l, m, x)
        return x_leaves, y

    for row in rows:
        up_pairs, down_pairs, sent = [], [], []
        up = down = None
        for s, kind, m, v in row:
            l = v * S + s
            if kind == PIPE_FWD and l < C - 1:
                up_pairs.append((s, (l + 1) % S))
                sent.append(("up", s, l + 1, m))
            if kind == PIPE_BWD and l > 0:
                down_pairs.append((s, (l - 1) % S))
                sent.append(("down", s, l - 1, m))
            if s != me:
                continue
            if kind == PIPE_FWD:
                grad = train and keep
                x_leaves, y = run_chunk(l, m, grad, consume=not train or keep)
                if l == C - 1:
                    loss, ms = last(m, y)
                    ms = {k: t.detach() for k, t in ms.items()}
                    sums = ms if sums is None else {
                        k: sums[k] + ms[k] for k in sums}
                    if grad:
                        kept[(l, m)] = (x_leaves, [loss], None)
                else:
                    up = wire.pack(y)
                    if grad:
                        kept[(l, m)] = (x_leaves, floats(y), None)
                continue
            if keep:
                x_leaves, outs, _ = kept.pop((l, m))
            else:
                x_leaves, y = run_chunk(l, m, True, consume=True)
                outs = [last(m, y)[0]] if l == C - 1 else floats(y)
            seeds = (None if l == C - 1
                     else wire.unpack_cot(cots.pop((l, m))))
            with torch.enable_grad():
                gx = differentiate(l, outs, seeds, x_leaves)
            if l > 0:
                down = wire.pack_cot(gx)
        if wire is None or (not up_pairs and not down_pairs):
            continue
        got_up, got_down = wire.exchange(up_pairs, down_pairs, up, down)
        for kind, s, l2, m in sent:
            if l2 % S != me:
                continue
            if kind == "up" and got_up is not None:
                inbox[(l2, m)] = got_up
            elif kind == "down" and got_down is not None:
                cots[(l2, m)] = got_down
    return sums, grads


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def plan_metric_sums(mesh: PlanMesh, sums, device) -> dict:
    """Metric sums over a plan's ranks: one all-reduce over its
    `plan_group` (only the last stage's ranks hold any; the others add
    zeros)."""
    keys = ("correct1", "correct5", "count", "loss_sum")
    flat = (torch.stack([sums[k].float() for k in keys]) if sums
            else torch.zeros(len(keys), device=device))
    if mesh.plan_group is not None:
        with scope("metrics"):
            dist.all_reduce(flat, group=mesh.plan_group)
    return dict(zip(keys, flat.unbind()))


def gather_stage_trees(mesh: PlanMesh, tree):
    """Each stage's canonical `tree` (from its data 0, seq 0 rank)
    gathered onto the plan's first rank and merged there (`merge_trees`);
    None on the other ranks. Collective over the plan's ranks; `tree`
    itself on a plan of one rank."""
    if mesh.plan_group is None:
        return tree
    first = mesh.ranks[0]
    got = [None] * mesh.size if dist.get_rank() == first else None
    send = tree if (mesh.data_index, mesh.seq_index) == (0, 0) else None
    dist.gather_object(send, got, dst=first, group=mesh.plan_group)
    if got is None:
        return None
    parts = [t for t in got if t is not None]
    out = parts[0]
    for part in parts[1:]:
        out = merge_trees(out, part)
    return out


def merge_trees(a, b):
    """The union of two canonical trees that hold different stages'
    parts: dicts key by key, per-chunk tuples chunk by chunk (a chunk
    another rank holds is an empty dict), `a`'s leaf where both hold
    one."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = merge_trees(out[k], v) if k in out else v
        return out
    if isinstance(a, tuple) and isinstance(b, tuple):
        return tuple(map(merge_trees, a, b))
    return a


def _leaves(x) -> list:
    """A stage's input or output: one tensor, or a tuple (the LM's
    (hidden, mask) pair)."""
    return list(x) if isinstance(x, tuple) else [x]


def _unwire(leaves: list, dtypes: list):
    """Wire leaves -> the receiving stage's input, each leaf cast back to
    the dtype its sender produced."""
    out = [t.to(d) for t, d in zip(leaves, dtypes)]
    return tuple(out) if len(out) > 1 else out[0]


class _StageIO(NamedTuple):
    """Input leaf dtypes per chunk and the wire dtype: the common type of
    every stage-I/O leaf (the JAX engine's `_wire_dtype`); `leaves` holds
    each chunk's input leaves as `WireLeaf`s (shape and dtype)."""

    ins: list
    wire: torch.dtype
    leaves: list


@dataclasses.dataclass
class PipelineEngine:
    """Pipeline engine over the mesh's stage axis (module docstring).

    `stages` is a model family's `split_stages` output: S chunks, or S·V
    under `schedule="interleaved"` with `virtual_stages=V`.
    `num_microbatches=1` is the reference's schedule (one batch in
    flight)."""

    stages: List[L.Layer]
    optimizer: Any  # SGD | AdamW (training/optim.py)
    mesh: Mesh
    num_microbatches: int = 1
    sync_bn: bool = False
    # Activations in this dtype (bf16), parameters f32 masters cast per
    # use; None keeps the input dtype.
    compute_dtype: Optional[torch.dtype] = None
    remat: bool = False
    # Accepted for the JAX engine's API; every chunk's state lives on its
    # stage's device either way.
    stage_local_params: bool = False
    schedule: str = "gpipe"
    virtual_stages: int = 1

    def __post_init__(self):
        if self.schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(
                f"schedule must be 'gpipe', '1f1b' or 'interleaved', "
                f"got {self.schedule!r}"
            )
        if self.virtual_stages < 1:
            raise ValueError(
                f"virtual_stages must be >= 1, got {self.virtual_stages}"
            )
        if self.virtual_stages > 1 and self.schedule != "interleaved":
            raise ValueError(
                "virtual_stages > 1 requires schedule='interleaved' "
                "(gpipe/1f1b run exactly one chunk per device)"
            )
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None, float32 or "
                             f"bfloat16, got {self.compute_dtype}")
        self.num_stages = S = self.mesh.stage
        self._V = V = (self.virtual_stages if self.schedule == "interleaved"
                       else 1)
        self.num_chunks = C = S * V
        if C != len(self.stages):
            raise ValueError(
                f"{len(self.stages)} stage chunks but mesh 'stage' axis "
                f"size {S} x virtual_stages {V} needs {C}"
            )
        M = self.num_microbatches
        # Stages as ranks (a plan mesh, `runtime/mesh.make_plan_mesh`):
        # this rank runs and holds only its own stage's chunks.
        self._ranked = isinstance(self.mesh, PlanMesh)
        if self._ranked:
            if self.mesh.seq != 1:
                raise ValueError(
                    "the pipeline engine's stage ranks carry no 'seq' "
                    "axis; pp x sp plans run ComposedPlanEngine "
                    "(parallel/plan.py)")
            #: this rank's logical chunks
            self.mine = [l for l in range(C)
                         if chunk_owner(l, S) == self.mesh.stage_index]
            self.devices = [self.mesh.device] * C
            self._rank_rows = rank_tick_rows(self.schedule, S, M, V)
            self._wires: dict = {}
        else:
            #: the device of each logical chunk
            self.devices = [self.mesh.stage_device(chunk_owner(l, S))
                            for l in range(C)]
        self._bn_group = (self.mesh.group
                          if self.sync_bn and self.mesh.data > 1 else None)
        self._io_cache: dict = {}
        # What runs each chunk: the chunk, or its checkpointed twin.
        self._exec = [L.remat(st) if self.remat else st
                      for st in self.stages]
        #: gradient all-reduces launched (one per train step with a
        #: process group)
        self.grad_reductions = 0
        # Tick rows: per tick, the (stage, work, microbatch, chunk) items.
        fill_drain = [[(s, PIPE_FWD, t - s, 0) for s in range(S)
                       if 0 <= t - s < M] for t in range(M + S - 1)]
        if self.schedule == "gpipe":
            self._sched = None
            self._train_rows = self._eval_rows = fill_drain
        else:
            self._sched = sc = build_interleaved_schedule(S, M, V)
            self._train_rows = [
                [(s, int(sc.work[t, s]), int(sc.micro[t, s]),
                  int(sc.chunk[t, s])) for s in range(S)
                 if sc.work[t, s] != PIPE_IDLE]
                for t in range(sc.num_ticks)]
            # Eval replays the forward ticks (the JAX engine's interleaved
            # eval; gpipe and 1f1b evaluate on the fill-drain ticks).
            self._eval_rows = fill_drain if V == 1 else [
                [item for item in row if item[1] == PIPE_FWD]
                for row in self._train_rows]

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters and BN state: the chunks initialized in order
        from one generator seeded with `seed`, so an image model's
        pipeline starts from the weights its whole model
        (`staged_model`) draws from the same seed."""
        gen = torch.Generator().manual_seed(seed)
        params, state = zip(*(stage.init(gen) for stage in self.stages))
        return self.state_from_params(params, state)

    def state_from_params(self, params, model_state) -> TrainState:
        """A step-0 state around per-chunk `params` and `model_state`
        (sequences in logical order), each chunk moved to its device;
        parameters become leaves that require grad."""
        for l, st in enumerate(model_state):
            if any(path.endswith("moe_aux") for path in _paths(st)):
                raise NotImplementedError(
                    f"chunk {l} carries MoE state: MoE layers are not "
                    "supported inside PipelineEngine stages: the load-"
                    "balance aux loss cannot reach the last-stage loss "
                    "without a differentiated 'stage' collective. Train "
                    "MoE models with the DP / DDP / TensorParallel / "
                    "ExpertParallel engines.")
        if self._ranked:
            def meta(t):
                return torch.empty_like(t, device="meta")

            self._meta_params = tuple(tree_map(meta, p) for p in params)
            self._meta_state = tuple(tree_map(meta, s) for s in model_state)
            params, model_state = (
                tuple(t if l in self.mine else {} for l, t in enumerate(x))
                for x in (params, model_state))
        params = tuple(
            tree_map(lambda t, d=d: t.detach().to(d, torch.float32).clone()
                     .requires_grad_(True), p)
            for p, d in zip(params, self.devices))
        model_state = tuple(
            tree_map(lambda t, d=d: t.detach().to(d, torch.float32).clone(),
                     s) for s, d in zip(model_state, self.devices))
        return TrainState(params, model_state, self.optimizer.init(params),
                          0)

    @property
    def collective_checkpoint(self) -> bool:
        """On stage ranks `Trainer` gathers checkpoints through
        `to_canonical` on every rank (each holds its own chunks)."""
        return self._ranked

    def to_canonical(self, ts: TrainState):
        """The JAX engine's canonical checkpoint tree, as numpy: per-chunk
        tuples of params, BN state and optimizer buffers in logical order
        (`models/convert.train_state_to_jax`). On stage ranks the
        stages' chunks are gathered onto the plan's first rank
        (collective; the other ranks get None)."""
        tree = train_state_to_jax(ts)
        return gather_stage_trees(self.mesh, tree) if self._ranked else tree

    def canonical_spec(self, ts: TrainState) -> dict:
        """`to_canonical`'s shapes and dtypes on stage ranks, without a
        collective (the restore template)."""
        return train_state_spec(TrainState(
            self._meta_params, self._meta_state,
            self.optimizer.init(self._meta_params), ts.step))

    def from_canonical(self, tree, like: Optional[TrainState] = None):
        """Inverse of `to_canonical`, into the devices and layouts of
        `like` (default: a fresh `init_state()`); on stage ranks this
        rank keeps its own chunks of the whole tree."""
        like = like or self.init_state()
        if self._ranked:
            def keep(x):
                if isinstance(x, dict):
                    return {k: keep(v) for k, v in x.items()}
                if isinstance(x, (tuple, list)):
                    return tuple(t if l in self.mine else {}
                                 for l, t in enumerate(x))
                return x

            tree = {k: (tree[k] if k == "step" else keep(tree[k]))
                    for k in tree}
        return train_state_from_jax(tree, like)

    def shard_batch(self, images, labels):
        """This rank's host batch -> the inputs on the first stage's
        device, the labels on the last's."""
        return (place(images, self.devices[0]),
                place(labels, self.devices[-1]).long())

    # ------------------------------------------------------------ steps

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        return x

    def _microbatches(self, x: torch.Tensor) -> list:
        n = x.shape[0]
        if n % self.num_microbatches:
            raise ValueError(f"local batch {n} not divisible by "
                             f"num_microbatches {self.num_microbatches}")
        return list(x.split(n // self.num_microbatches))

    def _stage_io(self, ts: TrainState, x_mb: torch.Tensor,
                  train: bool) -> _StageIO:
        """Every chunk's I/O dtypes from a forward on meta tensors (no
        data, no arithmetic): the static replacement for the JAX engine's
        `stage_io_avals`, and its check of the last stage's output."""
        key = (tuple(x_mb.shape), x_mb.dtype, train)
        if key not in self._io_cache:
            def meta(t):
                return torch.empty_like(t, device="meta")

            ctx = L.Context(train=train, dtype=self.compute_dtype)
            x = meta(x_mb)
            ins, specs, dtypes = [], [], {x.dtype}
            params, states = ((self._meta_params, self._meta_state)
                              if self._ranked
                              else (ts.params, ts.model_state))
            with torch.no_grad():
                for stage, p, s in zip(self.stages, params, states):
                    ins.append([t.dtype for t in _leaves(x)])
                    specs.append([WireLeaf(tuple(t.shape), t.dtype)
                                  for t in _leaves(x)])
                    x, _ = stage.apply(tree_map(meta, p), tree_map(meta, s),
                                       x, ctx)
                    dtypes.update(t.dtype for t in _leaves(x))
            if isinstance(x, tuple) or x.dim() != 2:
                raise ValueError(
                    "last pipeline stage must output a single (rows, "
                    "classes) logits array — classification heads emit "
                    "(microbatch, classes); token-level (LM) heads flatten "
                    "to (microbatch*T, vocab) (models/gpt.py split_stages)"
                )
            wire = dtypes.pop()
            for d in dtypes:
                wire = torch.promote_types(wire, d)
            self._io_cache[key] = _StageIO(ins, wire, specs)
        return self._io_cache[key]

    def _ctx(self, train: bool, key, l: int, m: int) -> L.Context:
        """Dropout bits keyed by (step, data rank, chunk, microbatch): the
        step's key with the chunk and microbatch as its child path, the
        same at a forward tick and at its backward tick's recompute."""
        return L.Context(train=train, dtype=self.compute_dtype,
                         rng=key if train else None, rng_path=(l, m),
                         bn_group=self._bn_group if train else None)

    def _run(self, rows, ts: TrainState, mbs, labels_mbs, io: _StageIO, *,
             train: bool, ticks: bool):
        """Walk the tick rows. `ticks=False` runs forward items only with
        the graph kept when `train` (gpipe's autograd through the whole
        loop) or none (eval); `ticks=True` is the 1F1B / interleaved train
        program. Returns (per-microbatch f32 logits, new BN state,
        per-chunk summed parameter gradients or None)."""
        S, C = self.num_stages, self.num_chunks
        sc = self._sched
        R, Rc = (sc.stash_depth, sc.cot_depth) if sc else (1, 1)
        stash = [[None] * (self._V * R) for _ in range(S)]
        cots = [[None] * (self._V * Rc) for _ in range(S)]
        state = list(ts.model_state)
        logits = [None] * len(mbs)
        grads = [None] * C
        rank = (0 if self.mesh.group is None
                else dist.get_rank(self.mesh.group))
        key = step_key(ts.step, rank) if train else None
        for row in rows:
            sends = []
            for s, kind, m, v in row:
                l = v * S + s
                ctx = self._ctx(train, key, l, m)
                slot = v * R + m % R
                wire_in = None
                if l > 0:
                    wire_in = stash[s][slot]
                    if not ticks or kind == PIPE_BWD:
                        stash[s][slot] = None
                if kind == PIPE_FWD:
                    with torch.set_grad_enabled(train and not ticks):
                        x = mbs[m] if l == 0 else _unwire(wire_in,
                                                          io.ins[l])
                        y, state[l] = self._exec[l].apply(
                            ts.params[l], state[l], x, ctx)
                        y = [t.to(io.wire) for t in _leaves(y)]
                    if l == C - 1:
                        logits[m] = y[0].float()
                    else:
                        sends.append((stash, R, l + 1, m, y))
                    continue
                cslot = v * Rc + m % Rc
                cot = cots[s][cslot]
                cots[s][cslot] = None
                gp, gx = self._backward_tick(ts, state, l, m, ctx, mbs,
                                             labels_mbs, wire_in, cot, io)
                grads[l] = gp if grads[l] is None else [
                    a + b for a, b in zip(grads[l], gp)]
                if l > 0:
                    sends.append((cots, Rc, l - 1, m, gx))
            # Arrival at the next tick, as the JAX engine's ppermute.
            for ring, depth, dst, m, payload in sends:
                s2, v2 = dst % S, dst // S
                slot = v2 * depth + m % depth
                if ring[s2][slot] is not None:
                    raise RuntimeError(
                        f"pipeline ring slot {slot} of stage {s2} is still "
                        f"live at microbatch {m}: the tick tables are wrong")
                ring[s2][slot] = [None if t is None else
                                  t.to(self.devices[dst]) for t in payload]
        return logits, tuple(state), grads

    def _backward_tick(self, ts, state, l, m, ctx, mbs, labels_mbs, wire_in,
                       cot, io):
        """Re-run chunk l on microbatch m under autograd from its stashed
        input; (parameter gradients, input cotangents for the wire)."""
        leaves_in = []
        with torch.enable_grad():
            if l == 0:
                x = mbs[m]
            else:
                leaves_in = [t.detach().requires_grad_(d.is_floating_point)
                             for t, d in zip(wire_in, io.ins[l])]
                x = _unwire(leaves_in, io.ins[l])
            y, _ = self._exec[l].apply(ts.params[l], state[l], x, ctx)
            y = [t.to(io.wire) for t in _leaves(y)]
            if l == self.num_chunks - 1:
                lbl = labels_mbs[m]
                outs = [cross_entropy(y[0].float(), lbl) * valid_count(lbl)]
                seeds = None
            else:
                outs, seeds = zip(*[(o, c) for o, c in zip(y, cot)
                                    if c is not None])
            p_leaves = list(tree_leaves(ts.params[l]))
            diff_in = [t for t in leaves_in if t.requires_grad]
            g = torch.autograd.grad(outs, p_leaves + diff_in, seeds,
                                    allow_unused=True)
        gp = [torch.zeros_like(p) if gi is None else gi
              for p, gi in zip(p_leaves, g)]
        gx = iter(g[len(p_leaves):])
        return gp, [next(gx) if t.requires_grad else None for t in leaves_in]

    def _mean_over_data(self, tensors: list) -> list:
        """Each tensor averaged over the data ranks: one flat all-reduce
        per device (SUM / world); the identity without a process group."""
        if self.mesh.group is None:
            return tensors
        out = list(tensors)
        by_device: dict = {}
        for i, t in enumerate(tensors):
            by_device.setdefault(t.device, []).append(i)
        for idx in by_device.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=self.mesh.group)
            flat = flat / self.mesh.data
            for i, piece in zip(idx, flat.split(
                    [tensors[i].numel() for i in idx])):
                out[i] = piece.view(tensors[i].shape)
        return out

    def _sum_metrics(self, m: dict) -> dict:
        keys = sorted(m)
        flat = torch.stack([m[k].float() for k in keys])
        if self.mesh.group is not None:
            with scope("metrics"):
                dist.all_reduce(flat, group=self.mesh.group)
        return dict(zip(keys, flat.unbind()))

    def _rank_ticks(self, ts: TrainState, images, labels, train: bool):
        """This stage rank's ticks (`run_stage_ticks`): (metric sums of
        its last-chunk microbatches or None, {chunk: summed parameter
        gradients}, new BN state)."""
        mbs = self._microbatches(self._input(images))
        labels_mbs = list(labels.reshape(self.num_microbatches, -1))
        io = self._stage_io(ts, mbs[0], train=train)
        S, C = self.num_stages, self.num_chunks
        wire = None
        if S > 1:
            if any(io.leaves[l] != io.leaves[1] for l in range(2, C)):
                raise ValueError(
                    "stage ranks send one packed payload a hop: every "
                    "chunk boundary must carry the same leaves (the LM's "
                    "(hidden, mask) pair)")
            wkey = (tuple(io.leaves[1]), io.wire)
            if wkey not in self._wires:
                self._wires[wkey] = StageWire(io.leaves[1], io.wire,
                                              self.mesh.stage_ranks,
                                              self.mesh.device)
            wire = self._wires[wkey]
        state = list(ts.model_state)
        key = step_key(ts.step, self.mesh.data_index) if train else None
        keep = self.schedule == "gpipe"

        def apply(l, m, x):
            if l > 0:
                x = tuple(x) if len(x) > 1 else x[0]
            y, new = self._exec[l].apply(ts.params[l], state[l], x,
                                         self._ctx(train, key, l, m))
            if train and (keep or not torch.is_grad_enabled()):
                state[l] = new  # forward items fold BN statistics
            return y if l == C - 1 else _leaves(y)

        def last(m, y):
            lbl = labels_mbs[m]
            ce = cross_entropy(y.float(), lbl)
            return ce * valid_count(lbl), _metrics(ce, y.float(), lbl)

        sums, grads = run_stage_ticks(
            self._rank_rows[0 if train else 1], num_stages=S, num_chunks=C,
            stage_index=self.mesh.stage_index, wire=wire,
            first=lambda m: mbs[m], apply=apply, last=last,
            params=lambda l: list(tree_leaves(ts.params[l])), train=train,
            keep=keep)
        return sums, grads, tuple(state)

    @property
    def wire_hops(self) -> int:
        """Payloads this stage rank has put on the stage wire."""
        return sum(w.hops for w in getattr(self, "_wires", {}).values())

    def _rank_train_step(self, ts: TrainState, images, labels, lr):
        sums, grads, new_state = self._rank_ticks(ts, images, labels, True)
        loss_norm = valid_count(labels).clamp_min(1.0)
        flat = [g / loss_norm.to(g.device)
                for l in sorted(grads) for g in grads[l]]
        if self.mesh.group is not None:
            self.grad_reductions += 1
        grads = _like(ts.params, iter(self._mean_over_data(flat)))
        if not self.sync_bn:
            new_state = _like(new_state, iter(self._mean_over_data(
                list(tree_leaves(new_state)))))
        write_back(ts.model_state, new_state)
        params, opt_state = self.optimizer.update(
            ts.params, ts.opt_state, grads, lr)
        return (TrainState(params, ts.model_state, opt_state, ts.step + 1),
                plan_metric_sums(self.mesh, sums, labels.device))

    def train_step(self, ts: TrainState, images, labels, lr):
        """One optimizer step; parameters, BN state and optimizer state
        are updated in place. Returns (state, metric sums over every data
        rank)."""
        if self._ranked:
            return self._rank_train_step(ts, images, labels, lr)
        mbs = self._microbatches(self._input(images))
        labels_mbs = list(labels.reshape(self.num_microbatches, -1))
        io = self._stage_io(ts, mbs[0], train=True)
        loss_norm = valid_count(labels).clamp_min(1.0)
        p_leaves = list(tree_leaves(ts.params))
        logits, new_state, grads = self._run(
            self._train_rows, ts, mbs, labels_mbs, io, train=True,
            ticks=self._sched is not None)
        logits = torch.cat(logits)
        loss_sum = cross_entropy(logits, labels) * valid_count(labels)
        loss = loss_sum / loss_norm
        if self._sched is None:
            g = torch.autograd.grad(loss, p_leaves, allow_unused=True)
            flat = [torch.zeros_like(p) if gi is None else gi
                    for p, gi in zip(p_leaves, g)]
        else:
            flat = [gi / loss_norm.to(gi.device)
                    for chunk in grads for gi in chunk]
        if self.mesh.group is not None:
            self.grad_reductions += 1
        grads = _like(ts.params, iter(self._mean_over_data(flat)))
        if not self.sync_bn:
            new_state = _like(new_state, iter(self._mean_over_data(
                list(tree_leaves(new_state)))))
        write_back(ts.model_state, new_state)
        params, opt_state = self.optimizer.update(
            ts.params, ts.opt_state, grads, lr)
        m = _metrics(loss.detach(), logits.detach(), labels)
        return (TrainState(params, ts.model_state, opt_state, ts.step + 1),
                self._sum_metrics(m))

    @torch.no_grad()
    def eval_step(self, ts: TrainState, images, labels) -> dict:
        if self._ranked:
            sums, _, _ = self._rank_ticks(ts, images, labels, False)
            return plan_metric_sums(self.mesh, sums, labels.device)
        mbs = self._microbatches(self._input(images))
        io = self._stage_io(ts, mbs[0], train=False)
        logits, _, _ = self._run(self._eval_rows, ts, mbs, None, io,
                                 train=False, ticks=False)
        logits = torch.cat(logits)
        return self._sum_metrics(_metrics(cross_entropy(logits, labels),
                                          logits, labels))


def _paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix


@dataclasses.dataclass
class LMPipelineEngine(PipelineEngine):
    """`PipelineEngine` for decoder-LM stages (`models/gpt.py
    split_stages`): `shard_batch` takes this data rank's rows of the
    GLOBAL batch (the LM loader's, as the sequence-parallel engine's
    `shard_batch` does) and builds their flattened next-token targets on
    the host (`lm_targets(ids).reshape(-1)`: the last position and pad
    targets are -1), so the loader's `(ids, ids)` batches drive it, and
    the loss is normalized by the valid target count, as the dense LM
    loss is."""

    pad_token_id: Any = None

    def shard_batch(self, ids, labels=None):
        d = self.mesh.data
        if ids.shape[0] % d:
            raise ValueError(
                f"batch size {ids.shape[0]} must be divisible by the "
                f"'data' mesh axis ({d} ranks)")
        rows = ids.shape[0] // d
        r = self.mesh.data_index
        ids = np.asarray(ids)[r * rows:(r + 1) * rows]
        targets = lm_targets(ids, self.pad_token_id).reshape(-1)
        return (place(np.asarray(ids), self.devices[0]).long(),
                place(targets, self.devices[-1]).long())


__all__ = ["LMPipelineEngine", "PIPE_BWD", "PIPE_FWD", "PIPE_IDLE",
           "PipelineEngine", "Schedule1F1B", "ScheduleTicks",
           "build_1f1b_schedule", "build_interleaved_schedule"]
