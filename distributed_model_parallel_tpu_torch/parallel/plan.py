"""One `ParallelPlan`: composed PP x SP x (FSDP-)DP over ranks (port of
`parallel/plan.py`).

    ParallelPlan(pp=S_pp, tp_or_sp=S_sp, dp=S_dp, fsdp=..., ep=S_ep)

is laid out on the stage-major ('stage', 'data', 'seq') mesh of
`runtime/mesh.make_plan_mesh`: rank = (stage * dp + data) * sp + seq, one
process a rank, so that a pipeline stage is a rank of its own next to its
seq and data ranks. The reference runs the plan as one SPMD program whose
every device runs every stage's code under `where`-selects; here each
rank runs only its own stage, and the axes compose as follows:

  stage — the pipeline's tick tables (`parallel/pipeline.rank_tick_rows`:
          gpipe, 1f1b, interleaved) driven per rank by
          `pipeline.run_stage_ticks`: one send / receive pair per tick
          between neighbouring stage ranks (`pipeline.StageWire`),
          activations downstream and cotangents upstream. gpipe runs its
          fill-drain forward ticks and then the reversed backward ticks
          (the reference's reversed ppermutes); the loss lives on the
          last stage only, and no reduction runs before the gradient.
          Each stage rank holds only its own chunks' parameters and
          optimizer state: chunk l = v * pp + s of pp * V uniform chunks
          (`num_layers % (pp * V) == 0`) runs on stage s, the stem with
          chunk 0 and the head with the last chunk.
  seq   — `CausalLMSequenceParallelEngine`'s per-shard math on the seq
          ranks of each (stage, data): the shard-aware position slice,
          `lm_targets` built from the whole rows and sharded beside the
          ids, and ring / Ulysses / ring-flash attention with causal=True
          over the stage's `seq_group` (K1-K3 under the `*_flash` cores,
          at the hop shapes); `collective_matmul` runs the FFN pair on the
          seq rings (`sequence_parallel._seq_matmul_policy`).
  data  — per-rank gradients are complementary pieces (partial per seq
          shard, per-replica sums over data), so ONE fused all-reduce over
          the stage's (data, seq) ranks (`PlanMesh.data_seq_group`), the
          valid-token count riding in the same buffer, divided by that
          global count, gives the dense mean-loss gradient. `fsdp=True`
          shards the stage's leaves 1/dp over its data group
          (`fsdp.fsdp_specs` on the canonical shapes, leaves below
          `MIN_SHARD_ELEMS` replicated), all-gathers them at the start of a step and keeps each rank's
          own slice of the reduced gradient: ZeRO-3 on the plan's data
          axis.
  ep    — an ep > 1 plan routes to `ExpertParallelLMEngine`'s
          hierarchical dispatch (experts ride the data ranks); the
          composed engine refuses MoE configs, as the reference's does.

`build_plan_engine` keeps the reference's degenerate map: pp-only plans
run `LMPipelineEngine` on stage ranks, sp-only (x dp) plans
`CausalLMSequenceParallelEngine`, ep plans `ExpertParallelLMEngine`, and
dp-only, fsdp and multi-axis plans `ComposedPlanEngine`.

Checkpoints: the canonical form is the dense `gpt_lm` tree. `to_canonical`
gathers the FSDP shards over each stage's data group and the stages'
trees onto the plan's first rank (collective; the other ranks get None),
`from_canonical` keeps this rank's chunks (and FSDP slice) of a full
tree, and `to_canonical_sharded` describes which rank holds which region
of every canonical leaf, so a sharded file saved under one plan restores
under another.
"""

from __future__ import annotations

import dataclasses
import re
from functools import partial
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.checkpointing.sharded import (
    ShardedLeaf,
    ShardedState,
    _canonical_data,
    _dtype_name,
)
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    train_state_from_jax,
    train_state_spec,
    train_state_to_jax,
)
from distributed_model_parallel_tpu_torch.models.gpt import (
    block_apply,
    head_apply,
    init_params,
    lm_targets,
    stem_apply,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    TrainState,
    step_key,
)
from distributed_model_parallel_tpu_torch.parallel.fsdp import (
    P,
    _all_gather,
    _sharded_dim,
    fsdp_specs,
)
from distributed_model_parallel_tpu_torch.parallel.pipeline import (
    StageWire,
    WireLeaf,
    gather_stage_trees,
    plan_metric_sums,
    rank_tick_rows,
    run_stage_ticks,
)
from distributed_model_parallel_tpu_torch.parallel.sequence_parallel import (
    ATTENTION,
    CausalLMSequenceParallelEngine,
    _check_seq_len,
    _seq_matmul_policy,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import (
    PlanMesh,
    make_plan_mesh,
)
from distributed_model_parallel_tpu_torch.training.checkpoint import (
    flatten_tree,
)
from distributed_model_parallel_tpu_torch.training.optim import (
    tree_leaves,
    tree_like,
    tree_map,
)

PLAN_AXES = ("pp", "tp_or_sp", "dp", "ep")
# Spec-string vocabulary: every alias maps to its ParallelPlan field.
# "sp" and "tp" both mean the tp_or_sp axis (the within-slice leg is
# Megatron-SP sequence sharding with TP-style rings); "fsdp" means the dp
# axis with parameter sharding on.
_TOKEN_FIELD = {
    "pp": "pp", "sp": "tp_or_sp", "tp": "tp_or_sp",
    "dp": "dp", "fsdp": "dp", "ep": "ep",
}
# The pp token optionally carries the pipeline SCHEDULE as a dashed
# suffix: `pp2-1f1b` (PipeDream-flush), `pp4-int2` (Megatron interleaved
# with V=2 virtual chunks per stage). No suffix = gpipe.
_TOKEN_RE = re.compile(
    r"^(pp|sp|tp|dp|fsdp|ep)(\d+)(?:-(1f1b|int(\d+)))?$"
)
PLAN_SCHEDULES = ("gpipe", "1f1b", "interleaved")
# FSDP leaves below this many elements stay replicated (FSDP's default).
MIN_SHARD_ELEMS = 1024


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Declarative axis assignment: how many ways each parallelism axis
    runs. `fsdp` shards parameters and moments over the dp axis (ZeRO-3);
    `tp_or_sp` is the within-slice sequence leg. The product of the axes
    is the number of ranks the plan occupies."""

    pp: int = 1
    tp_or_sp: int = 1
    dp: int = 1
    ep: int = 1
    fsdp: bool = False
    # Pipeline schedule of the pp axis, execution only (never part of the
    # parameter layout): "gpipe" (fill-drain), "1f1b" (PipeDream-flush,
    # O(S) activation stash) or "interleaved" (Megatron's virtual
    # pipeline, `virtual_stages` chunks a stage).
    schedule: str = "gpipe"
    virtual_stages: int = 1

    def __post_init__(self):
        for name in PLAN_AXES:
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"ParallelPlan.{name} must be an int >= 1, got {v!r}"
                )
        if self.fsdp and self.dp < 2:
            raise ValueError(
                "ParallelPlan(fsdp=True) shards parameters over the dp "
                f"axis; dp={self.dp} leaves nothing to shard"
            )
        if self.schedule not in PLAN_SCHEDULES:
            raise ValueError(
                f"ParallelPlan.schedule must be one of "
                f"{PLAN_SCHEDULES}, got {self.schedule!r} (the --plan "
                "pp token sets it: pp2, pp2-1f1b, pp4-int2)"
            )
        if not isinstance(self.virtual_stages, int) or \
                self.virtual_stages < 1:
            raise ValueError(
                "ParallelPlan.virtual_stages must be an int >= 1, got "
                f"{self.virtual_stages!r}"
            )
        if self.schedule == "interleaved" and self.virtual_stages < 2:
            raise ValueError(
                "ParallelPlan.schedule='interleaved' needs "
                "virtual_stages >= 2 (the --plan token spells it "
                "pp<S>-int<V>, e.g. pp4-int2); V=1 interleaving IS "
                "1f1b — spell it pp<S>-1f1b"
            )
        if self.schedule != "interleaved" and self.virtual_stages != 1:
            raise ValueError(
                f"ParallelPlan.virtual_stages={self.virtual_stages} "
                f"only rides schedule='interleaved', not "
                f"{self.schedule!r}"
            )
        if self.schedule != "gpipe" and self.pp < 2:
            raise ValueError(
                f"ParallelPlan.schedule={self.schedule!r} schedules "
                f"the pp axis, but pp={self.pp} has no pipeline — give "
                "the --plan a pp token >= 2 (e.g. pp2-1f1b)"
            )

    @property
    def num_devices(self) -> int:
        return self.pp * self.tp_or_sp * self.dp * self.ep

    @property
    def spec(self) -> str:
        """Canonical spec string (`parse_plan` round-trips it)."""
        bits = []
        if self.pp > 1:
            sched = (
                "" if self.schedule == "gpipe"
                else "-1f1b" if self.schedule == "1f1b"
                else f"-int{self.virtual_stages}"
            )
            bits.append(f"pp{self.pp}{sched}")
        if self.tp_or_sp > 1:
            bits.append(f"sp{self.tp_or_sp}")
        if self.dp > 1 or not bits:
            bits.append(("fsdp" if self.fsdp else "dp") + str(self.dp))
        if self.ep > 1:
            bits.append(f"ep{self.ep}")
        return "x".join(bits)


def parse_plan(spec: str) -> ParallelPlan:
    """`"pp2xsp2xdp2"` -> ParallelPlan(pp=2, tp_or_sp=2, dp=2).

    Tokens are axis-name + ways, joined by 'x': pp / sp (alias tp) / dp /
    fsdp (dp with parameter sharding) / ep. Each axis may appear once;
    omitted axes default to 1. The pp token may carry a pipeline schedule
    suffix — `pp2-1f1b` or `pp4-int2` (interleaved, V=2 chunks per stage)
    — default gpipe; a trailing dash before the next 'x' is tolerated
    (`pp2-1f1b-xsp2` == `pp2-1f1bxsp2`)."""
    fields: dict = {}
    fsdp = False
    schedule, virtual = "gpipe", 1
    for token in str(spec).strip().lower().split("x"):
        token = token.strip().rstrip("-")
        m = _TOKEN_RE.match(token)
        if not m:
            raise ValueError(
                f"bad plan token {token!r} in {spec!r}: expected "
                "<axis><ways> with axis in pp/sp/tp/dp/fsdp/ep and an "
                "optional pp schedule suffix (e.g. 'pp2xsp2xdp2', "
                "'fsdp4', 'pp2-1f1bxdp4', 'pp4-int2')"
            )
        name, ways, sched_sfx = m.group(1), int(m.group(2)), m.group(3)
        field = _TOKEN_FIELD[name]
        if field in fields:
            raise ValueError(
                f"plan {spec!r} names the {field} axis twice"
            )
        fields[field] = ways
        if name == "fsdp":
            fsdp = True
        if sched_sfx is not None:
            if name != "pp":
                raise ValueError(
                    f"plan {spec!r}: the schedule suffix "
                    f"'-{sched_sfx}' rides the pp token only "
                    f"(ParallelPlan.schedule schedules the pipeline "
                    f"axis), not {name!r}"
                )
            if sched_sfx == "1f1b":
                schedule = "1f1b"
            else:
                virtual = int(m.group(4))
                if virtual < 2:
                    raise ValueError(
                        f"plan {spec!r}: interleaving needs >= 2 "
                        "virtual chunks per stage (pp<S>-int<V> with "
                        "V >= 2); V=1 interleaving IS 1f1b — spell "
                        "it pp<S>-1f1b"
                    )
                schedule = "interleaved"
    return ParallelPlan(
        fsdp=fsdp, schedule=schedule, virtual_stages=virtual, **fields
    )


def param_shapes(cfg) -> dict:
    """The dense `gpt_lm` parameter tree of `cfg` as meta tensors (the
    shapes `models/gpt.init_params` draws, without drawing them)."""

    def t(*shape):
        return torch.empty(shape, device="meta")

    def linear(d_in, d_out):
        return {"w": t(d_in, d_out), "b": t(d_out)}

    def norm():
        return {"scale": t(cfg.dim), "bias": t(cfg.dim)}

    block = {"attn": {"qkv": linear(cfg.dim, 3 * cfg.dim),
                      "out": linear(cfg.dim, cfg.dim)},
             "ln1": norm(),
             "ffn": {"in": linear(cfg.dim, cfg.ffn_dim),
                     "out": linear(cfg.ffn_dim, cfg.dim)},
             "ln2": norm()}
    return {"stem": {"word": t(cfg.vocab_size, cfg.dim),
                     "position": t(cfg.max_position, cfg.dim)},
            "blocks": {str(i): tree_map(lambda a: a, block)
                       for i in range(cfg.num_layers)},
            "head": {"w": t(cfg.dim, cfg.vocab_size)}}


@dataclasses.dataclass
class ComposedPlanEngine:
    """GPT LM training under a composed ParallelPlan on the stage-major
    plan mesh of ranks (module docstring), with the reference engine's
    API: `init_state`, `shard_batch`, `train_step`, `eval_step`,
    `to_canonical`, `from_canonical`, `state_partition_specs`,
    `to_canonical_sharded`. This rank's state is its stage's part of the
    dense `gpt_lm` tree ({"stem"} on stage 0, its chunks' "blocks", the
    "head" on the last stage), each leaf its 1/dp slice under fsdp, with
    the optimizer state beside it."""

    cfg: Any  # models.gpt.GPTConfig
    optimizer: Any  # SGD | AdamW (training/optim.py)
    mesh: PlanMesh
    plan: ParallelPlan = ParallelPlan()
    # Microbatches of the tick loop (None = the stage count, or pp * V
    # under the interleaved schedule: the least that fills the pipeline).
    num_microbatches: Optional[int] = None
    attention: str = "ring"
    compute_dtype: Optional[torch.dtype] = None
    remat: bool = False
    # FFN pair as rings over 'seq' (SequenceParallelEngine's policy).
    collective_matmul: bool = False
    # The mesh's ranks compute on their CUDA device; pass "cpu" (and a
    # `make_plan_mesh(..., device="cpu")` mesh) to run on the CPU.
    device: Any = "cuda"

    #: `Trainer` gathers checkpoints through `to_canonical` on every rank
    collective_checkpoint = True

    def __post_init__(self):
        mesh, plan, cfg = self.mesh, self.plan, self.cfg
        for ax, ways in (("stage", plan.pp), ("data", plan.dp),
                         ("seq", plan.tp_or_sp)):
            if not isinstance(mesh, PlanMesh):
                raise ValueError(
                    f"composed-plan mesh needs a '{ax}' axis "
                    f"(make_plan_mesh); got {type(mesh).__name__}")
            if getattr(mesh, ax) != ways:
                raise ValueError(
                    f"plan {plan.spec!r} wants {ways}-way '{ax}' but the "
                    f"mesh carries {getattr(mesh, ax)}")
        if plan.ep > 1:
            raise NotImplementedError(
                "ComposedPlanEngine does not run the expert axis; "
                "ep > 1 plans route through "
                "parallel/expert_parallel.ExpertParallelLMEngine "
                "(build_plan_engine does this)")
        if getattr(cfg, "num_experts", 0) > 0:
            raise NotImplementedError(
                "GPTConfig.num_experts > 0 is not supported by "
                "ComposedPlanEngine; train MoE LMs with an ep plan "
                "(parallel/expert_parallel.ExpertParallelLMEngine).")
        if self.attention not in ATTENTION:
            raise ValueError(
                f"attention must be one of {sorted(ATTENTION)}, "
                f"got {self.attention!r}")
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be None, float32 or bfloat16, got "
                f"{self.compute_dtype}")
        S, V, sp = plan.pp, plan.virtual_stages, plan.tp_or_sp
        C = S * V  # logical pipeline depth (chunks across all stages)
        M = self.num_microbatches or (
            C if plan.schedule == "interleaved" else S)
        if M < S:
            raise ValueError(
                f"num_microbatches={M} (--microbatches) cannot fill "
                f"a {S}-stage pipeline (need M >= ParallelPlan.pp)")
        if plan.schedule == "interleaved" and M < C:
            raise ValueError(
                f"num_microbatches={M} (--microbatches) cannot fill "
                f"the interleaved pipeline of plan {plan.spec!r}: its "
                f"ParallelPlan.virtual_stages={V} runs pp*V={C} "
                "logical chunks (need num_microbatches >= pp*V)")
        if plan.schedule == "interleaved" and M % S:
            raise ValueError(
                f"num_microbatches={M} (--microbatches) must be divisible "
                f"by ParallelPlan.pp={S} under the interleaved schedule "
                "(Megatron's round-robin microbatch groups)")
        self.num_microbatches = M
        if cfg.num_layers % C:
            raise ValueError(
                f"plan {plan.spec!r} cuts the block stack into "
                f"pp*virtual_stages={C} uniform chunks, which must "
                f"divide cfg.num_layers={cfg.num_layers} (--layers; "
                "uneven cuts -> parallel/pipeline.LMPipelineEngine)")
        if self.attention.startswith("ulysses") and cfg.num_heads % sp:
            raise ValueError(f"ulysses needs heads ({cfg.num_heads}) "
                             f"divisible by 'seq' axis size ({sp})")
        self.device = torch.device(self.device)
        if self.device.type != torch.device(mesh.device).type:
            raise ValueError(
                f"engine device {self.device} but the plan mesh's ranks "
                f"compute on {mesh.device} (make_plan_mesh's device)")
        self._C, self._Lpc = C, cfg.num_layers // C
        self._train_rows, self._eval_rows = rank_tick_rows(
            plan.schedule, S, M, V)
        self._keep = plan.schedule == "gpipe"
        s_idx = mesh.stage_index
        #: this rank's logical chunks
        self.chunks = [l for l in range(C) if l % S == s_idx]
        self._matmul = _seq_matmul_policy(
            self.collective_matmul and sp > 1, cfg.ffn_dim, mesh)
        self._attn = (partial(ATTENTION[self.attention], causal=True,
                              group=mesh.seq_group) if sp > 1
                      else partial(dot_product_attention, causal=True))
        full = param_shapes(cfg)
        self._full_specs = (
            fsdp_specs(full, plan.dp, min_shard_elems=MIN_SHARD_ELEMS,
                       axes="data") if plan.fsdp
            else tree_map(lambda _: P(), full))
        self._specs = self._local(self._full_specs)
        self._wires: dict = {}
        #: fused gradient all-reduces issued (one a train step when the
        #: stage has more than one rank)
        self.grad_reductions = 0

    # ------------------------------------------------------------ layout

    def _blocks_of(self, l: int) -> range:
        return range(l * self._Lpc, (l + 1) * self._Lpc)

    def _owner_stage(self, path: str) -> int:
        """The stage whose ranks hold the canonical parameter `path`
        ('stem/...', 'blocks/<j>/...', 'head/...')."""
        top, _, rest = path.partition("/")
        if top == "stem":
            return 0
        if top == "head":
            return (self._C - 1) % self.plan.pp
        return (int(rest.split("/")[0]) // self._Lpc) % self.plan.pp

    def _local(self, tree) -> dict:
        """This rank's part of a canonical parameter-shaped tree."""
        out = {}
        if 0 in self.chunks:
            out["stem"] = tree["stem"]
        out["blocks"] = {str(j): tree["blocks"][str(j)]
                         for l in self.chunks for j in self._blocks_of(l)}
        if self._C - 1 in self.chunks:
            out["head"] = tree["head"]
        return out

    def _slice(self, t: torch.Tensor, spec) -> torch.Tensor:
        d, _ = _sharded_dim(spec)
        if d is None:
            return t
        n = t.shape[d] // self.plan.dp
        return t.narrow(d, self.mesh.data_index * n, n)

    def _gather(self, t: torch.Tensor, spec, grad: bool) -> torch.Tensor:
        """The full leaf of FSDP shard `t` (itself when replicated)."""
        d, _ = _sharded_dim(spec)
        if d is None:
            return t
        with torch.no_grad():
            full = (t.detach().clone() if self.mesh.group is None else
                    torch.cat(_all_gather(t, self.mesh.group, self.plan.dp),
                              dim=d))
        return full.requires_grad_(grad)

    def state_partition_specs(self) -> TrainState:
        """The partition specs of the canonical TrainState: fsdp plans
        declare their 1/dp 'data' leaves (`fsdp.P`), replicated plans
        `P()` everywhere (the reference's manifest seam)."""
        pspecs = self._full_specs
        opt = self.optimizer.init(param_shapes(self.cfg))
        return TrainState(pspecs, {}, type(opt)(*(
            pspecs if isinstance(f, dict) else P() for f in opt)), P())

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters from `seed` (`models/gpt.init_params` on the
        engine's device, the dense engines' draw); this rank keeps its
        part."""
        return self.state_from_params(
            init_params(self.cfg, seed, device=self.device))

    def state_from_params(self, params) -> TrainState:
        """A step-0 state around the FULL dense `params`: this rank's
        chunks (and FSDP slice), on the engine's device, as leaves that
        require grad."""
        local = tree_map(
            lambda t, s: self._slice(t.detach().to(self.device,
                                                   torch.float32), s)
            .clone().requires_grad_(True),
            self._local(params), self._specs)
        return TrainState(local, {}, self.optimizer.init(local), 0)

    def shard_batch(self, ids, labels=None):
        """The GLOBAL ids (B, T) host array -> this rank's block of ids
        and of their next-token targets, on the device: the data index's
        rows, their targets built from the whole rows, then the seq
        index's columns of both (replicated over the stages). `labels`
        is ignored (the targets are the shifted ids)."""
        _check_seq_len(ids, self.cfg.max_position, "GPTConfig")
        ids = np.asarray(ids)
        d, n = self.plan.dp, self.plan.tp_or_sp
        if ids.shape[0] % d:
            raise ValueError(
                f"batch size {ids.shape[0]} must be divisible by the "
                f"'data' mesh axis ({d} ranks)")
        if ids.shape[1] % n:
            raise ValueError(
                f"sequence length {ids.shape[1]} must be divisible by the "
                f"'seq' mesh axis ({n} shards)")
        b, t = ids.shape[0] // d, ids.shape[1] // n
        r, q = self.mesh.data_index, self.mesh.seq_index
        rows = ids[r * b:(r + 1) * b]
        targets = lm_targets(rows, pad_token_id=self.cfg.pad_token_id)
        to = partial(torch.as_tensor, device=self.device)
        cols = slice(q * t, (q + 1) * t)
        return (to(np.ascontiguousarray(rows[:, cols])).long(),
                to(np.ascontiguousarray(targets[:, cols])).long())

    # ------------------------------------------------------------- steps

    def _wire(self, mb: int, tl: int) -> Optional[StageWire]:
        if self.plan.pp == 1:
            return None
        if (mb, tl) not in self._wires:
            act = self.compute_dtype or torch.float32
            self._wires[(mb, tl)] = StageWire(
                [WireLeaf((mb, tl, self.cfg.dim), act),
                 WireLeaf((mb, tl), torch.bool)],
                act, self.mesh.stage_ranks, self.device)
        return self._wires[(mb, tl)]

    @property
    def wire_hops(self) -> int:
        """Payloads this rank has put on the stage wire."""
        return sum(w.hops for w in self._wires.values())

    def _key(self, step):
        key = step_key(step, self.mesh.data_index)
        return (L.fold_in(key, self.mesh.seq_index) if self.plan.tp_or_sp > 1
                else key)

    def _ticks(self, mat, ids, targets, step, train: bool):
        """Run this rank's ticks on the execution tree `mat` (the state's
        parameters, gathered under fsdp). Returns (metric sums or None,
        {chunk: summed gradients of `_chunk_leaves`})."""
        cfg, M = self.cfg, self.num_microbatches
        bl, tl = ids.shape
        if bl % M:
            raise ValueError(f"local batch {bl} not divisible by "
                             f"num_microbatches {M}")
        mb = bl // M
        ids_mbs, tg_mbs = ids.split(mb), targets.split(mb)
        key = self._key(step) if train else None
        q = self.mesh.seq_index
        C = self._C

        def apply(l, m, x):
            ctx = L.Context(train=train, dtype=self.compute_dtype, rng=key,
                            rng_path=(l, m), matmul=self._matmul)
            if l == 0:
                pos = mat["stem"]["position"][q * tl:(q + 1) * tl]
                x = stem_apply(mat["stem"], x, cfg, ctx.child(0),
                               positions=pos)
            else:
                x = tuple(x)
            block_ctx = ctx.child(1)
            for j in self._blocks_of(l):
                x = block_apply(mat["blocks"][str(j)], x, cfg,
                                block_ctx.child(j), self._attn,
                                remat=self.remat)
            if l == C - 1:
                return head_apply(mat["head"], x[0])
            return list(x)

        def last(m, logits):
            sums = CausalLMSequenceParallelEngine.local_sums(logits,
                                                             tg_mbs[m])
            return sums["loss_sum"], sums

        return run_stage_ticks(
            self._train_rows if train else self._eval_rows,
            num_stages=self.plan.pp, num_chunks=C,
            stage_index=self.mesh.stage_index, wire=self._wire(mb, tl),
            first=lambda m: ids_mbs[m], apply=apply, last=last,
            params=lambda l: self._chunk_leaves(mat, l), train=train,
            keep=self._keep)

    def _chunk_leaves(self, mat, l: int) -> list:
        sub = {"blocks": {str(j): mat["blocks"][str(j)]
                          for j in self._blocks_of(l)}}
        if l == 0:
            sub["stem"] = mat["stem"]
        if l == self._C - 1:
            sub["head"] = mat["head"]
        return list(tree_leaves(sub))

    def train_step(self, ts: TrainState, ids, targets, lr):
        """One optimizer step: this rank's ticks, ONE fused all-reduce of
        its gradients and the valid-token count over its stage's (data,
        seq) ranks, the division by that global count, the FSDP slice,
        and the in-place update of this rank's parameters and optimizer
        state. Returns (state, metric sums over the plan)."""
        mat = tree_map(lambda t, s: self._gather(t, s, True), ts.params,
                       self._specs)
        sums, grads = self._ticks(mat, ids, targets, ts.step, True)
        leaves = list(tree_leaves(mat))
        where = {id(t): i for i, t in enumerate(leaves)}
        acc = [None] * len(leaves)
        for l, gl in grads.items():
            for t, g in zip(self._chunk_leaves(mat, l), gl):
                acc[where[id(t)]] = g
        acc = [torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, acc)]
        count = (targets != -1).sum().to(acc[0].dtype).reshape(1)
        flat = torch.cat([g.reshape(-1) for g in acc] + [count])
        if self.mesh.data_seq_group is not None:
            self.grad_reductions += 1
            dist.all_reduce(flat, group=self.mesh.data_seq_group)
        g = flat[:-1] / flat[-1:].clamp_min(1.0)
        g_tree = tree_like(mat, iter(
            p.view(t.shape) for p, t in
            zip(g.split([t.numel() for t in leaves]), leaves)))
        g_tree = tree_map(self._slice, g_tree, self._specs)
        params, opt_state = self.optimizer.update(
            ts.params, ts.opt_state, g_tree, lr)
        return (TrainState(params, ts.model_state, opt_state, ts.step + 1),
                plan_metric_sums(self.mesh, sums, flat.device))

    @torch.no_grad()
    def eval_step(self, ts: TrainState, ids, targets) -> dict:
        mat = tree_map(lambda t, s: self._gather(t, s, False), ts.params,
                       self._specs)
        sums, _ = self._ticks(mat, ids, targets, ts.step, False)
        return plan_metric_sums(self.mesh, sums, ids.device)

    # ------------------------------------------------ checkpoint seams

    def _full_local(self, ts: TrainState) -> TrainState:
        """This rank's part of the state with every FSDP leaf gathered
        over the data group (collective over it)."""
        def full(f):
            return (tree_map(lambda t, s: self._gather(t, s, False), f,
                             self._specs) if isinstance(f, dict) else f)

        return TrainState(full(ts.params), {},
                          type(ts.opt_state)(*map(full, ts.opt_state)),
                          ts.step)

    def to_canonical(self, ts: TrainState):
        """The reference's canonical checkpoint tree (numpy, the dense
        `gpt_lm` layout) on the plan's first rank, None on the others:
        the FSDP leaves gathered over each data group, then each stage's
        tree (from its data 0, seq 0 rank) gathered onto the first rank.
        Collective: every rank of the plan calls it."""
        return gather_stage_trees(self.mesh,
                                  train_state_to_jax(self._full_local(ts)))

    def _full_meta(self, step=0) -> TrainState:
        params = param_shapes(self.cfg)
        return TrainState(params, {}, self.optimizer.init(params), step)

    def canonical_spec(self, ts: TrainState) -> dict:
        """`to_canonical`'s shapes and dtypes, without a collective (the
        restore template)."""
        return train_state_spec(self._full_meta(ts.step))

    def from_canonical(self, tree, like: Optional[TrainState] = None
                       ) -> TrainState:
        """A canonical tree (every rank holding the same values, as
        `training/checkpoint.restore_checkpoint` broadcasts them) ->
        this rank's chunks and FSDP slice, on the engine's device, in the
        layouts of `like` (default: a fresh `init_state()`): the
        cross-plan reshard seam."""
        like = like or self.init_state()

        def keep(sub):
            local = self._local(sub)
            return tree_map(lambda a, s: self._slice(
                torch.from_numpy(np.asarray(a)), s).numpy(), local,
                self._specs)

        opt = like.opt_state
        local = {"params": keep(tree["params"]), "model_state": {},
                 "opt_state": {f: (keep(tree["opt_state"][f])
                                   if isinstance(getattr(opt, f), dict)
                                   else tree["opt_state"][f])
                               for f in opt._fields},
                 "step": tree["step"]}
        return train_state_from_jax(local, like)

    def to_canonical_sharded(self, ts: TrainState) -> ShardedState:
        """The sharded checkpoint's view of `ts` (`checkpointing/
        sharded.py`): every canonical leaf's regions with the ranks that
        hold them (its stage's ranks; under fsdp a sharded leaf's k-th
        1/dp block on the stage's data index k), and this rank's own
        regions. No collective and no copy."""
        mesh = self.mesh
        meta = flatten_tree(_tree(self._full_meta(ts.step)))
        specs = flatten_tree(_tree(self.state_partition_specs()))
        mine = flatten_tree(_tree(ts))
        everyone = tuple(mesh.ranks)
        me = dist.get_rank() if dist.is_initialized() else 0
        leaves = {}
        for path, m in meta.items():
            data = _canonical_data(mine[path]) if path in mine else None
            shape = tuple(int(n) for n in getattr(m, "shape", ()))
            whole = tuple((0, n) for n in shape)
            top, _, rest = path.partition("/")
            if top == "opt_state":
                rest = rest.partition("/")[2]
            owner = (self._owner_stage(rest)
                     if top in ("params", "opt_state") and rest else None)
            if owner is None:
                leaves[path] = ShardedLeaf(shape, _dtype_name(mine[path]),
                                           [], {whole: everyone},
                                           {whole: data})
                continue
            d, _ = _sharded_dim(specs[path])
            dtype = "float32"
            if d is None:
                holders = {whole: mesh.stage_holders(owner)}
                local = {whole: data} if data is not None else {}
                leaves[path] = ShardedLeaf(shape, dtype, [], holders, local)
                continue
            n = shape[d] // mesh.data
            holders, local = {}, {}
            for k in range(mesh.data):
                region = tuple((k * n, (k + 1) * n) if i == d else (0, s)
                               for i, s in enumerate(shape))
                holders[region] = mesh.stage_holders(owner, k)
                if data is not None and me in holders[region]:
                    local[region] = data
            spec = [None] * len(shape)
            spec[d] = "data"
            leaves[path] = ShardedLeaf(shape, dtype, spec, holders, local)
        world = dist.get_world_size() if dist.is_initialized() else 1
        return ShardedState(leaves, {"stage": mesh.stage, "data": mesh.data,
                                     "seq": mesh.seq}, world)


def _tree(ts) -> dict:
    opt = ts.opt_state
    return {"params": ts.params, "model_state": ts.model_state,
            "opt_state": {f: getattr(opt, f) for f in opt._fields},
            "step": ts.step}


def plan_route(cfg: Any, plan: ParallelPlan, *,
               force_composed: bool = False) -> str:
    """The name of the engine `build_plan_engine` runs `plan` with (the
    degenerate-plan map), with the reference's refusals: ep composes with
    dp only, and an ep plan needs a config with experts."""
    moe = getattr(cfg, "num_experts", 0) > 0
    if plan.ep > 1 or (moe and not force_composed):
        if plan.pp > 1 or plan.tp_or_sp > 1 or plan.fsdp:
            offending = ", ".join(
                f"{name}={v}" for name, v in (
                    ("pp", plan.pp), ("tp_or_sp", plan.tp_or_sp),
                    ("fsdp", plan.fsdp),
                ) if v not in (1, False))
            raise NotImplementedError(
                f"plan {plan.spec!r}: ParallelPlan.ep={plan.ep} "
                "composes with the dp field only (experts ride the "
                "data fabric through ExpertParallelLMEngine), but "
                f"this --plan also sets {offending} — drop those "
                "tokens from --plan, or drop its ep token")
        if not moe:
            raise ValueError(
                f"plan {plan.spec!r} has ep={plan.ep} but the config "
                "has no experts (GPTConfig.num_experts == 0)")
        return "ExpertParallelLMEngine"
    axes_used = sum(1 for w in (plan.pp, plan.tp_or_sp, plan.dp) if w > 1)
    if not (force_composed or plan.fsdp or axes_used > 1):
        if plan.pp > 1:
            return "LMPipelineEngine"
        if plan.tp_or_sp > 1:
            return "CausalLMSequenceParallelEngine"
    return "ComposedPlanEngine"


def build_plan_engine(
    cfg: Any,
    optimizer: Any,
    plan: ParallelPlan | str,
    *,
    ranks=None,
    device: Any = "cuda",
    num_microbatches: Optional[int] = None,
    attention: str = "ring",
    collective_matmul: bool = False,
    compute_dtype: Any = None,
    remat: bool = False,
    force_composed: bool = False,
):
    """The one engine entry point: a GPT(-MoE) config plus a ParallelPlan
    (or its spec string) returns the engine that runs it on this rank,
    the composed engine for genuinely multi-axis plans and the existing
    single-axis engine when the plan is its degenerate form:

        pp-only           -> LMPipelineEngine on stage ranks
        sp-only (x dp)    -> CausalLMSequenceParallelEngine
        ep (x dp)         -> ExpertParallelLMEngine (hierarchical,
                             experts riding the data ranks)
        dp-only / fsdp /
        multi-axis        -> ComposedPlanEngine on make_plan_mesh

    The plan occupies `ranks` (default: the world's first
    plan.num_devices ranks; the port's ranks are its devices), and every
    rank of the world calls this (the mesh's groups are collective). The
    single-axis engines' meshes span the world, so their routes need a
    world the plan fills. `force_composed=True` skips the degenerate
    routing."""
    if isinstance(plan, str):
        plan = parse_plan(plan)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if plan.num_devices > world:
        raise ValueError(
            f"plan {plan.spec!r} needs {plan.num_devices} devices, "
            f"{world} present")
    n = plan.num_devices
    route = plan_route(cfg, plan, force_composed=force_composed)
    if route in ("ExpertParallelLMEngine",
                 "CausalLMSequenceParallelEngine") and n != world:
        raise ValueError(
            f"plan {plan.spec!r} routes to {route}, whose mesh spans the "
            f"world: run it on exactly {n} ranks, not {world}")
    if route == "ExpertParallelLMEngine":
        from distributed_model_parallel_tpu_torch.models.gpt import (
            gpt_lm_model,
        )
        from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
            import ExpertParallelLMEngine
        from distributed_model_parallel_tpu_torch.runtime.mesh import (
            MeshSpec,
            make_mesh,
        )

        return ExpertParallelLMEngine(
            gpt_lm_model(cfg, remat=remat), optimizer,
            make_mesh(MeshSpec(data=n)), dispatch="hierarchical",
            compute_dtype=compute_dtype, device=device,
            pad_token_id=cfg.pad_token_id)
    if route == "LMPipelineEngine":
        from distributed_model_parallel_tpu_torch.models.gpt import (
            split_stages,
        )
        from distributed_model_parallel_tpu_torch.parallel.pipeline import (
            LMPipelineEngine,
        )

        V = plan.virtual_stages
        return LMPipelineEngine(
            split_stages(plan.pp * V, cfg), optimizer,
            make_plan_mesh(plan.pp, plan.dp, 1, device, ranks),
            num_microbatches=num_microbatches or (
                plan.pp * V if plan.schedule == "interleaved" else plan.pp),
            compute_dtype=compute_dtype, remat=remat,
            pad_token_id=cfg.pad_token_id, schedule=plan.schedule,
            virtual_stages=V)
    if route == "CausalLMSequenceParallelEngine":
        from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
            import CausalLMSequenceParallelEngine
        from distributed_model_parallel_tpu_torch.runtime.mesh import (
            MeshSpec,
            make_mesh,
        )

        return CausalLMSequenceParallelEngine(
            cfg, optimizer, attention=attention,
            compute_dtype=compute_dtype, remat=remat,
            collective_matmul=collective_matmul, device=device,
            mesh=make_mesh(MeshSpec(data=plan.dp, seq=plan.tp_or_sp)))
    return ComposedPlanEngine(
        cfg, optimizer,
        make_plan_mesh(plan.pp, plan.dp, plan.tp_or_sp, device, ranks),
        plan=plan, num_microbatches=num_microbatches, attention=attention,
        compute_dtype=compute_dtype, remat=remat,
        collective_matmul=collective_matmul, device=device)


__all__ = [
    "ComposedPlanEngine",
    "MIN_SHARD_ELEMS",
    "PLAN_SCHEDULES",
    "ParallelPlan",
    "build_plan_engine",
    "param_shapes",
    "parse_plan",
    "plan_route",
]
