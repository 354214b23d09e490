"""Lint driver: run engine x model x mode combos as one rank of their
world and check the rule registry against the collectives that rank
issued (port of `analysis/lint.py`; the reference's CLI is
`tools/hlolint`).

Where the reference lowers each combo on a virtual mesh of CPU devices
and reads the compiled HLO, this driver plays rank 0 of the combo's
world in this one process (`analysis/record.fake_world`: torch's fake
process group, whose collectives move no data), builds the port's engine
on the combo's mesh, records one train (or decode) step
(`analysis/record.recording`) and runs `rules.run_rules` over the
record. A combo at world N costs one process, not N. The fake group
returns every receive untouched, so a rank computes on stale values;
the engines decide which collectives to issue from shapes and the mesh
alone, never from received values, which `tests/test_torch_port_
analysis.py` shows by recording one combo a family on real gloo ranks
too and comparing the two records.

Per-combo results stream as one partial-JSON line each (`{"leg": ...,
"partial": true}`), then one summary JSON object, as the reference's
driver prints them. `main` exits 1 when an error-severity rule is
violated (or a combo fails to run), naming the rule.

    python -m distributed_model_parallel_tpu_torch.analysis.lint --pregate
    python -m distributed_model_parallel_tpu_torch.analysis.lint --pregate \\
        --device cpu
    python -m distributed_model_parallel_tpu_torch.analysis.lint \\
        --filter 'ddp.*dcn'
    python -m distributed_model_parallel_tpu_torch.analysis.lint --list-rules

The engines compute on the card (`--device cuda`, the default: CUDA
tensors, the NCCL path's calls, K4 launches counted); without one the
CLI refuses to start unless `--device cpu` is given.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import sys
from typing import Callable, List, Optional, Sequence, Tuple

from distributed_model_parallel_tpu_torch.analysis.collectives import (
    MeshModel,
)
from distributed_model_parallel_tpu_torch.analysis.rules import (
    DCN_WIRE_TOKEN,
    REGISTRY,
    Finding,
    LintContext,
    LintTarget,
    run_rules,
)

_DTYPE_TOKEN = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
                "float64": "f64", "int8": "s8", "uint8": "u8"}


@dataclasses.dataclass(frozen=True)
class Combo:
    """One cell of the engine x mode x mesh matrix (the reference's
    fields and names). `size` is the engine's PRIMARY parallel axis: the
    data axis for dp/ddp/fsdp/sp_lm, 'model' for tp, serve and the cm_*
    op kernels, 'seq' for sp, 'stage' for pipeline, the plan's device
    count for plan, and 'expert' (gspmd) or the data fabric
    (hierarchical) for ep. `model_shards` > 1 on an ep combo is the
    port's EP x TP cell (`MeshSpec(model=M, expert=S)`)."""

    engine: str
    size: int
    grad_reduction: str = "monolithic"
    dcn: int = 1
    collective_matmul: bool = False
    bf16: bool = False
    model: str = "mlp"
    moe_dispatch: str = "gspmd"
    moe_overlap: bool = False
    dcn_compression: str = "none"
    # the tuner's reducer knobs (`tuning/`): None / 0 keep BUCKET_MB and
    # the engines' auto segment count, and every older combo name
    bucket_mb: Optional[float] = None
    overlap_stages: int = 0
    page_size: Optional[int] = None
    # shapes the serve host's ingest loop only (the same decode step);
    # rides the name for the tuner's plan identity
    prefill_chunk: int = 0
    compute_dtype: Optional[str] = None
    speculative_k: int = 0
    plan: Optional[str] = None
    num_microbatches: int = 0
    model_shards: int = 1

    @property
    def name(self) -> str:
        bits = [self.engine, f"S{self.size}"]
        if self.dcn > 1:
            bits.append(f"dcn{self.dcn}")
        if self.engine in ("ddp", "fsdp", "sp_lm"):
            bits.append(self.grad_reduction)
        if self.engine == "ep":
            bits.append(self.moe_dispatch)
            if self.moe_overlap:
                bits.append("ov")
            if self.model_shards > 1:
                bits.append(f"tp{self.model_shards}")
        if self.plan is not None:
            bits.append(self.plan)
        if self.num_microbatches:
            bits.append(f"M{self.num_microbatches}")
        if self.dcn_compression != "none":
            bits.append(f"wire-{self.dcn_compression}")
        if self.bucket_mb is not None:
            bits.append(f"b{self.bucket_mb:g}")
        if self.overlap_stages:
            bits.append(f"seg{self.overlap_stages}")
        if self.page_size is not None:
            bits.append(f"pg{self.page_size}")
        if self.prefill_chunk:
            bits.append(f"ck{self.prefill_chunk}")
        if self.model != "mlp":
            bits.append(self.model)
        if self.collective_matmul:
            bits.append("cm")
        if self.bf16:
            bits.append("bf16")
        if self.compute_dtype is not None:
            bits.append(f"q-{self.compute_dtype}")
        if self.speculative_k:
            bits.append(f"spec{self.speculative_k}")
        return "/".join(bits)


@dataclasses.dataclass
class LintReport:
    combo: Combo
    target: LintTarget
    findings: List[Finding]
    n_collectives: int

    @property
    def violations(self) -> List[Finding]:
        return [f for f in self.findings if not f.exempted]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.violations if f.severity == "error"]


@dataclasses.dataclass
class Run:
    """One combo ready to record: the mesh the rules read, the engine's
    step (a no-argument callable), the target, and an optional finishing
    touch on the target after the step (facts only the step shows, as
    K4's launches)."""

    mesh: MeshModel
    step: Callable[[], object]
    target: LintTarget
    after: Optional[Callable[[LintTarget], LintTarget]] = None


# ------------------------------------------------------------ models


def staged_mlp(n_blocks=8, width=32, classes=4):
    """BN-free stem/blocks/head MLP over an (N, 8, 8, 3) batch: no model
    state, so the only data-fabric all-reduces an opted-in step may
    carry are the pinned bucket hops (the reference's lint model)."""
    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models import staging

    stem = L.sequential(L.flatten(), L.linear(192, width), L.relu())
    blocks = [L.sequential(L.linear(width, width), L.relu())
              for _ in range(n_blocks)]
    return staging.staged_model(stem, blocks, L.linear(width, classes))


def moe_classifier(num_experts: int, dim: int = 16, num_classes: int = 4,
                   top_k: int = 2, capacity_factor: float = 1.25):
    """One-block MoE classifier (tokens (B, T, D) -> logits): ONE routed
    layer, so the moe_ring hop pin is exact (the reference's)."""
    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models.moe import (
        moe_encoder_layer,
    )

    block = moe_encoder_layer(dim, 2, 2 * dim, num_experts, top_k=top_k,
                              capacity_factor=capacity_factor,
                              dropout_rate=0.0)
    head = L.linear(dim, num_classes)

    def init(gen):
        bp, bs = block.init(gen)
        return {"block": bp, "head": head.init(gen)[0]}, {"block": bs}

    def apply(params, state, x, ctx):
        (h, _), bs = block.apply(params["block"], state.get("block", {}),
                                 (x, None), ctx)
        logits, _ = head.apply(params["head"], {}, h.mean(dim=1), ctx)
        return logits, {"block": bs}

    return L.Layer(init, apply)


def _bert_cfg(model_size: int):
    from distributed_model_parallel_tpu_torch.models.bert import BertConfig

    return BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                      num_heads=max(2, model_size), intermediate_size=64,
                      max_position=16, dropout_rate=0.0)


def _gpt_cfg(**kw):
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**{**dict(vocab_size=61, dim=16, num_layers=4,
                               num_heads=2, ffn_dim=32, max_position=16,
                               dropout_rate=0.0), **kw})


def image_batch(n, hw=8, classes=4, seed=0):
    """Deterministic fake image batch (NHWC) and labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.rand(n, hw, hw, 3).astype(np.float32),
            rng.randint(0, classes, size=(n,)).astype(np.int64))


# ------------------------------------------------------- expectations


def _token(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return _DTYPE_TOKEN.get(name, "f32")


def _bucket_plan(leaves, bucket_mb: float, pad_multiple: int):
    """[(padded_elems, dtype_token)] for one segment's gradient leaves
    (anything with .shape and a torch .dtype): the shape the per-bucket
    collectives are pinned against."""
    from distributed_model_parallel_tpu_torch.ops.grad_reduction import (
        plan_buckets,
    )

    return tuple((b.size + (-b.size % pad_multiple), _token(b.dtype))
                 for b in plan_buckets(leaves, bucket_mb))


def _reducer_plans(params, state, n_blocks: int, grad_reduction: str,
                   bucket_mb: float, ici_size: int, dcn_size: int = 1,
                   dcn_compression: str = "none", overlap_stages: int = 0):
    """Per-segment bucket plans, segment count and BN state shapes of a
    staged model's (params, state) trees: one segment for 'bucketed',
    one a stagewise segment for 'overlapped', one whole-tree bucket per
    dtype for compressed 'monolithic'; no plan for uncompressed
    'monolithic'."""
    from distributed_model_parallel_tpu_torch.models import staging
    from distributed_model_parallel_tpu_torch.ops.grad_reduction import (
        MONOLITHIC_BUCKET_MB,
        bucket_pad_multiple,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    pad = bucket_pad_multiple(ici_size, dcn_size, dcn_compression)
    state_shapes = tuple(tuple(t.shape) for t in tree_leaves(state))
    if grad_reduction == "monolithic" and dcn_compression != "none":
        return ((_bucket_plan(list(tree_leaves(params)),
                              MONOLITHIC_BUCKET_MB, pad),), 0, state_shapes)
    if grad_reduction == "bucketed":
        return ((_bucket_plan(list(tree_leaves(params)), bucket_mb, pad),),
                0, state_shapes)
    if grad_reduction == "overlapped":
        n = staging.resolve_overlap_segments(n_blocks, overlap_stages,
                                             "lint")
        cuts = staging.split_points(n, None, n_blocks)
        return (tuple(_bucket_plan(list(tree_leaves(sp)), bucket_mb, pad)
                      for sp in staging.partition_tree(params, cuts)),
                n, state_shapes)
    return (), 0, state_shapes


def _wire_chunk_expectations(plans, ici_size: int, dcn_size: int,
                             dcn_compression: str):
    """Expected (elems, wire_dtype_token) multiset of the compressed 'dcn'
    payload hops: each bucket's 1/ici shard re-chunks across the K
    slices and crosses 2(K-1) times (exchange + gather,
    `grad_reduction.compressed_dcn_psum`)."""
    if dcn_compression == "none" or dcn_size <= 1:
        return ()
    wire = DCN_WIRE_TOKEN[dcn_compression]
    chunks = []
    for plan in plans:
        for padded, _dt in plan:
            chunks += [(padded // (ici_size * dcn_size), wire)] * \
                (2 * (dcn_size - 1))
    return tuple(chunks)


def _fsdp_gather_chunk_expectations(full_leaf_shapes, dcn_size: int,
                                    dcn_compression: str,
                                    gathers_per_leaf: int):
    """Expected (n_elems, wire_dtype) multiset of FSDP's compressed
    weight-gather ring hops (`parallel/fsdp._coded_dcn_gather`): each
    dcn-crossing leaf crosses 'dcn' in (K-1) coded hops of full_leaf/K
    elements a gather; `gathers_per_leaf` is 1 for the single-entry
    steps, 2 under "overlapped" (forward gather + backward regather)."""
    if dcn_compression == "none" or dcn_size <= 1:
        return ()
    wire = DCN_WIRE_TOKEN[dcn_compression]
    chunks = []
    for shape in full_leaf_shapes:
        chunks += [(math.prod(shape) // dcn_size, wire)] * \
            ((dcn_size - 1) * gathers_per_leaf)
    return tuple(chunks)


def _n_state_leaves(ts) -> int:
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    opt = sum(len(list(tree_leaves(f))) for f in ts.opt_state
              if isinstance(f, dict))
    return len(list(tree_leaves(ts.params))) + opt


def _mesh_facts(mesh) -> dict:
    if mesh.dcn > 1:
        return dict(data_axes=("dcn", "ici"), ici_axis="ici",
                    dcn_axis="dcn", ici_size=mesh.ici, dcn_size=mesh.dcn)
    return dict(data_axes=("data",), ici_axis="data", dcn_axis=None,
                ici_size=mesh.data, dcn_size=1)


def _rows(a, mesh):
    n = a.shape[0] // mesh.data
    return a[mesh.data_index * n:(mesh.data_index + 1) * n]


# ----------------------------------------------------------- builders

BUCKET_MB = 0.02  # small enough that every lint model splits > 1 bucket


def _build_data_engine(combo: Combo, device) -> Run:
    """ddp / fsdp / dp over a data(-factored) mesh."""
    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.parallel import fsdp as F
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    s = combo.size
    mesh = make_mesh(MeshSpec(data=s, dcn=combo.dcn))
    facts = _mesh_facts(mesh)
    model = (tiny_cnn(4) if combo.model == "tinycnn"
             else staged_mlp(width=128 if combo.engine == "fsdp" else 32))
    import torch

    cdt = torch.bfloat16 if combo.bf16 else None
    bmb = BUCKET_MB if combo.bucket_mb is None else combo.bucket_mb
    full_leaf_shapes: Tuple = ()
    if combo.engine == "dp":
        eng = DataParallelEngine(model, SGD(), mesh, compute_dtype=cdt,
                                 device=device)
    elif combo.engine == "ddp":
        eng = DDPEngine(model, SGD(), mesh, sync_bn=True, compute_dtype=cdt,
                        grad_reduction=combo.grad_reduction,
                        bucket_mb=bmb, overlap_stages=combo.overlap_stages,
                        dcn_compression=combo.dcn_compression,
                        device=device)
    else:
        eng = F.FSDPEngine(model, SGD(), mesh, min_shard_elems=64,
                           compute_dtype=cdt,
                           grad_reduction=combo.grad_reduction,
                           bucket_mb=bmb,
                           overlap_stages=combo.overlap_stages,
                           dcn_compression=combo.dcn_compression,
                           device=device)
    ts = eng.init_state(0)
    params, state = model.init(torch.Generator())
    if combo.engine == "fsdp":
        full_leaf_shapes = tuple(
            tuple(t.shape) for t, s_ in zip(tree_leaves(params),
                                            tree_leaves(eng._specs))
            if s_ is not None)
    plans, n_seg, state_shapes = _reducer_plans(
        params, state, len(model.parts.blocks), combo.grad_reduction,
        bmb, facts["ici_size"], facts["dcn_size"],
        combo.dcn_compression, combo.overlap_stages)
    im, lb = image_batch(16 * (s // 2 or 1))
    batch = eng.shard_batch(_rows(im, mesh), _rows(lb, mesh))
    target = LintTarget(
        name=combo.name, engine=combo.engine,
        grad_reduction=combo.grad_reduction, bf16=combo.bf16, donate=True,
        bucket_plans=plans, overlap_segments=n_seg,
        state_leaf_shapes=state_shapes,
        fsdp_full_leaf_shapes=full_leaf_shapes,
        at_rest_shapes=tuple(tuple(t.shape) for t in tree_leaves(ts.params)),
        dcn_compression=combo.dcn_compression,
        dcn_wire_chunks=_wire_chunk_expectations(
            plans, facts["ici_size"], facts["dcn_size"],
            combo.dcn_compression),
        dcn_gather_chunks=_fsdp_gather_chunk_expectations(
            full_leaf_shapes, facts["dcn_size"], combo.dcn_compression,
            2 if combo.grad_reduction == "overlapped" else 1),
        n_param_leaves=_n_state_leaves(ts), **facts)
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


def _token_batch(rows: int, seq: int, vocab: int, classes: int = 4):
    import numpy as np

    rng = np.random.RandomState(0)
    return (rng.randint(1, vocab, size=(rows, seq)).astype(np.int64),
            rng.randint(0, classes, size=(rows,)).astype(np.int64))


def _build_tp(combo: Combo, device) -> Run:
    import torch

    from distributed_model_parallel_tpu_torch.models.bert import (
        bert_for_classification,
    )
    from distributed_model_parallel_tpu_torch.parallel.tensor_parallel import (
        TensorParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    s = combo.size
    dp = 2 if 2 * s <= 8 else 1
    mesh = make_mesh(MeshSpec(data=dp, model=s))
    eng = TensorParallelEngine(
        bert_for_classification(4, _bert_cfg(s)), SGD(), mesh,
        collective_matmul=combo.collective_matmul,
        compute_dtype=torch.bfloat16 if combo.bf16 else None, device=device)
    ts = eng.init_state(0)
    ids, lb = _token_batch(4 * dp, 8, 64)
    batch = eng.shard_batch(_rows(ids, mesh), _rows(lb, mesh))
    target = LintTarget(
        name=combo.name, engine="tp", donate=True, bf16=combo.bf16,
        collective_matmul=combo.collective_matmul,
        cm_axis="model" if combo.collective_matmul else None,
        # 1 block = 4 opted-in projections: forward 4(S-1) ring hops +
        # the dual backward rings' >= 6(S-1)
        cm_min_ring_permutes=10 * (s - 1),
        n_param_leaves=_n_state_leaves(ts), **_mesh_facts(mesh))
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


def _build_sp(combo: Combo, device) -> Run:
    import torch

    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import SequenceParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    s = combo.size
    dp = 2 if 2 * s <= 8 else 1
    mesh = make_mesh(MeshSpec(data=dp, seq=s))
    eng = SequenceParallelEngine(
        _bert_cfg(4), 4, SGD(), mesh,
        collective_matmul=combo.collective_matmul,
        compute_dtype=torch.bfloat16 if combo.bf16 else None, device=device)
    ts = eng.init_state(0)
    ids, lb = _token_batch(4 * dp, 16, 64)
    batch = eng.shard_batch(_rows(ids, mesh), _rows(lb, mesh))
    target = LintTarget(
        name=combo.name, engine="sp", donate=True, bf16=combo.bf16,
        collective_matmul=combo.collective_matmul,
        cm_axis="seq" if combo.collective_matmul else None,
        # 1 block's FFN pair a step: forward 2(S-1) ring hops + the dual
        # backward's 3(S-1); the KV ring rides the same axis, so a floor
        cm_min_ring_permutes=5 * (s - 1),
        n_param_leaves=_n_state_leaves(ts), **_mesh_facts(mesh))
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


def _build_sp_lm(combo: Combo, device) -> Run:
    import torch

    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    s, seq = combo.size, 2
    mesh = make_mesh(MeshSpec(data=s, seq=seq, dcn=combo.dcn))
    facts = _mesh_facts(mesh)
    cfg = _gpt_cfg()
    bmb = BUCKET_MB if combo.bucket_mb is None else combo.bucket_mb
    eng = CausalLMSequenceParallelEngine(
        cfg, SGD(), grad_reduction=combo.grad_reduction,
        bucket_mb=bmb, overlap_stages=combo.overlap_stages,
        collective_matmul=combo.collective_matmul,
        dcn_compression=combo.dcn_compression, mesh=mesh, device=device)
    ts = eng.init_state(0)
    plans, n_seg, _ = _reducer_plans(
        ts.params, {}, cfg.num_layers, combo.grad_reduction, bmb,
        facts["ici_size"], facts["dcn_size"], combo.dcn_compression,
        combo.overlap_stages)
    ids, _ = _token_batch(4 * s, 16, 61)
    batch = eng.shard_batch(ids)
    target = LintTarget(
        name=combo.name, engine="sp_lm",
        grad_reduction=combo.grad_reduction, donate=True,
        collective_matmul=combo.collective_matmul,
        cm_axis="seq" if combo.collective_matmul else None,
        cm_min_ring_permutes=5 * (seq - 1) * cfg.num_layers,
        bucket_plans=plans, overlap_segments=n_seg,
        dcn_compression=combo.dcn_compression,
        dcn_wire_chunks=_wire_chunk_expectations(
            plans, facts["ici_size"], facts["dcn_size"],
            combo.dcn_compression),
        n_param_leaves=_n_state_leaves(ts), **facts)
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


def _build_ep(combo: Combo, device) -> Run:
    """MoE expert-parallel train steps (`parallel/expert_parallel.py`):
    gspmd on a (data=2, expert=S) mesh (on (data, model, expert) with
    `model_shards`), judged by the generic rules; hierarchical (+overlap)
    over a (data=S[, dcn]) fabric, whose moe_ring chain
    `moe-hierarchical-a2a` pins exactly."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models.bert import (
        bert_for_classification,
    )
    from distributed_model_parallel_tpu_torch.ops.expert_dispatch import (
        exchange_permutes,
    )
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import EXPERT_RULES, MEGATRON_RULES, ExpertParallelEngine
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    s, dim, seq = combo.size, 16, 8
    m = combo.model_shards
    if combo.moe_dispatch == "hierarchical":
        mesh = make_mesh(MeshSpec(data=s, dcn=combo.dcn))
        eng = ExpertParallelEngine(
            moe_classifier(s, dim=dim), SGD(), mesh, device=device,
            dispatch="hierarchical", overlap=combo.moe_overlap,
            dcn_compression=combo.dcn_compression)
        facts = _mesh_facts(mesh)
        # one MoE layer: the forward exchange pair + mirrored backward
        expected = 2 * exchange_permutes(facts["ici_size"],
                                         facts["dcn_size"])
        world = s
    else:
        dp = 2 if 2 * s * m <= 8 else 1
        mesh = make_mesh(MeshSpec(data=dp, model=m, expert=s))
        # EP x TP runs the MoE BERT classifier: Megatron's layout needs
        # its attention and FFN, Megatron-SP its stem / blocks / head.
        model = (moe_classifier(s, dim=dim) if m == 1 else
                 bert_for_classification(4, dataclasses.replace(
                     _bert_cfg(m), num_layers=2, num_experts=s)))
        eng = ExpertParallelEngine(
            model, SGD(), mesh, device=device,
            collective_matmul=combo.collective_matmul,
            rules=EXPERT_RULES + MEGATRON_RULES if m > 1 else EXPERT_RULES)
        facts = _mesh_facts(mesh)
        expected = None
        world = dp * m * s
    ts = eng.init_state(0)
    rng = np.random.RandomState(0)
    n = max(8, mesh.data)
    if m > 1:
        x, lb = _token_batch(n, seq, 64)
    else:
        x = rng.randn(n, seq, dim).astype(np.float32)
        lb = rng.randint(0, 4, size=(n,)).astype(np.int64)
    batch = eng.shard_batch(_rows(x, mesh), _rows(lb, mesh))
    target = LintTarget(
        name=combo.name, engine="ep", donate=True,
        moe_dispatch=combo.moe_dispatch, moe_ring_permutes=expected,
        dcn_compression=combo.dcn_compression,
        # the compressed exchange: per routed layer the 'dcn' stage
        # crosses 2(K-1) hops a direction pair, doubled by the backward
        dcn_wire_hops=(4 * (facts["dcn_size"] - 1)
                       if combo.dcn_compression != "none" else None),
        n_param_leaves=_n_state_leaves(ts), **facts)
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


def _build_pipeline(combo: Combo, device) -> Run:
    """The one-process pipeline (every stage in each data rank's process)
    over data ranks: only the data axis crosses ranks."""
    from distributed_model_parallel_tpu_torch.models.tinycnn import (
        split_stages,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        PipelineEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    s = combo.size
    dp = max(1, 8 // s)
    mesh = make_mesh(MeshSpec(data=dp, stage=s), devices=[device])
    eng = PipelineEngine(split_stages(s, 4), SGD(), mesh,
                         num_microbatches=2)
    ts = eng.init_state(0)
    im, lb = image_batch(4 * dp)
    batch = eng.shard_batch(_rows(im, mesh), _rows(lb, mesh))
    target = LintTarget(name=combo.name, engine="pipeline", donate=True,
                        n_param_leaves=1, **_mesh_facts(mesh))
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


def _build_cm_op(combo: Combo, device) -> Run:
    """Op-level ring targets: the exact S-1 hop pin on ag_matmul /
    matmul_rs, forward only, over a world of S ranks."""
    import torch

    from distributed_model_parallel_tpu_torch.ops.collective_matmul import (
        ag_matmul,
        matmul_rs,
    )

    import torch.distributed as dist

    s = combo.size
    dt = torch.bfloat16 if combo.bf16 else torch.float32
    group = dist.group.WORLD
    if combo.engine == "cm_ag":
        x = torch.zeros((2, 4, 16), dtype=dt, device=device)
        w = torch.zeros((16, 8), dtype=dt, device=device)
        step = lambda: ag_matmul(x, w, group)  # noqa: E731
    else:
        x = torch.zeros((2, 4 * s, 8), dtype=dt, device=device)
        w = torch.zeros((8, 16), dtype=dt, device=device)
        step = lambda: matmul_rs(x, w, group)  # noqa: E731
    target = LintTarget(
        name=combo.name, engine=combo.engine, bf16=combo.bf16,
        data_axes=(), ici_axis=None, ici_size=1, cm_axis="model",
        expected_permutes=s - 1)
    return Run(MeshModel.from_axes((("model", s),)), step, target)


def _build_serve(combo: Combo, device) -> Run:
    """Serving decode (or speculative verify) steps under the tp layout,
    declarative or on the decode rings; quantized projections note their
    GEMMs (`decode-quantized-matmul`)."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.serving.decode import (
        decode_ring_permutes,
    )
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )

    s = combo.size
    mesh = make_mesh(MeshSpec(data=1, model=s))
    cfg = _gpt_cfg(num_layers=2, num_heads=max(4, s))
    eng = ServingEngine(
        cfg, mesh, layout="tp", num_slots=2 * s, max_len=16, prefill_len=8,
        collective_matmul=combo.collective_matmul,
        compute_dtype=combo.compute_dtype or ("bf16" if combo.bf16
                                              else None),
        page_size=combo.page_size, speculative_k=combo.speculative_k,
        device=device)
    params = eng.init_params(0)
    cache = eng.init_cache()
    dev = torch.device(device)
    tokens = torch.zeros((eng.num_slots,), dtype=torch.int64, device=dev)
    active = torch.ones((eng.num_slots,), dtype=torch.bool, device=dev)
    expected = (decode_ring_permutes(cfg.num_layers, s)
                if combo.collective_matmul else None)
    if combo.page_size is not None:
        host = eng.new_host()
        extra = combo.speculative_k + 1 if combo.speculative_k else 0
        for slot in range(eng.num_slots):
            host.ensure_pages(slot, 8 + extra)
        bt = host.device_table()
        positions = torch.full((eng.num_slots,), 8, dtype=torch.int64,
                               device=dev)
        if combo.speculative_k:
            chunk = torch.zeros((eng.num_slots, combo.speculative_k + 1),
                                dtype=torch.int64, device=dev)
            step = lambda: eng.paged_verify_step(  # noqa: E731
                params, cache, bt, positions, chunk, active)
        else:
            step = lambda: eng.paged_decode_step(  # noqa: E731
                params, cache, bt, positions, tokens, active)
    else:
        step = lambda: eng.decode_step(  # noqa: E731
            params, cache, tokens, active)
    quant = (4 * cfg.num_layers * (s if combo.collective_matmul else 1)
             if combo.compute_dtype else None)
    target = LintTarget(
        name=combo.name, engine="serve", donate=True, bf16=combo.bf16,
        collective_matmul=combo.collective_matmul,
        cm_axis="model" if combo.collective_matmul else None,
        cm_min_ring_permutes=expected or 0,
        serve_decode_permutes=None if combo.speculative_k else expected,
        speculative_k=combo.speculative_k,
        spec_verify_permutes=expected if combo.speculative_k else None,
        n_param_leaves=2 if combo.page_size is not None else 3,
        compute_dtype=combo.compute_dtype, quant_dot_count=quant,
        head_weight_shape=(cfg.dim, cfg.vocab_size), **_mesh_facts(mesh))
    start = qm.int8_matmul.launches

    def after(t: LintTarget) -> LintTarget:
        if dev.type != "cuda":
            return t
        return dataclasses.replace(
            t, k4_launches=qm.int8_matmul.launches - start)

    return Run(MeshModel.from_mesh(mesh), step, target, after)


def _build_plan(combo: Combo, device) -> Run:
    """Composed-plan train steps (`parallel/plan.py`) on the stage-major
    plan mesh of ranks; the plan-* rules read its wire, ring, gradient
    and FSDP-gather scopes."""
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        build_plan_engine,
        parse_plan,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    plan = parse_plan(combo.plan)
    if plan.num_devices != combo.size:
        raise ValueError(f"combo size {combo.size} != plan {plan.spec!r} "
                         f"device count {plan.num_devices}")
    chunks = plan.pp * plan.virtual_stages
    cfg = _gpt_cfg()
    if cfg.num_layers % chunks:
        cfg = dataclasses.replace(cfg, num_layers=chunks)
    eng = build_plan_engine(cfg, SGD(), combo.plan, device=device,
                            num_microbatches=combo.num_microbatches or None,
                            force_composed=True)
    ts = eng.init_state(0)
    ids, _ = _token_batch(4 * plan.dp * plan.pp, 16, 61)
    batch = eng.shard_batch(ids)
    mesh = eng.mesh
    target = LintTarget(
        name=combo.name, engine="plan", donate=True,
        plan_axes=(("stage", plan.pp), ("data", plan.dp),
                   ("seq", plan.tp_or_sp)),
        plan_schedule=plan.schedule, plan_virtual=plan.virtual_stages,
        plan_microbatches=eng.num_microbatches,
        plan_stage_index=mesh.stage_index,
        n_param_leaves=_n_state_leaves(ts),
        data_axes=("data",), ici_axis="data", ici_size=plan.dp)
    return Run(MeshModel.from_mesh(mesh),
               lambda: eng.train_step(ts, *batch, 0.1), target)


_BUILDERS = {
    "dp": _build_data_engine, "ddp": _build_data_engine,
    "fsdp": _build_data_engine, "tp": _build_tp, "sp": _build_sp,
    "sp_lm": _build_sp_lm, "pipeline": _build_pipeline,
    "cm_ag": _build_cm_op, "cm_rs": _build_cm_op, "serve": _build_serve,
    "ep": _build_ep, "plan": _build_plan,
}


def world_of(combo: Combo) -> int:
    """The world a combo's mesh spans."""
    s, e = combo.size, combo.engine
    if e in ("tp", "sp"):
        return s * (2 if 2 * s <= 8 else 1)
    if e == "sp_lm":
        return 2 * s
    if e == "pipeline":
        return max(1, 8 // s)
    if e == "ep" and combo.moe_dispatch == "gspmd":
        m = combo.model_shards
        return s * m * (2 if 2 * s * m <= 8 else 1)
    return s


def record_step(combo: Combo, device: str):
    """(target, recording, mesh model) of one step of `combo` on this
    process's world, which must be the combo's (`world_of`)."""
    from distributed_model_parallel_tpu_torch.analysis.record import (
        recording,
    )

    built = _BUILDERS[combo.engine](combo, device)
    with recording() as rec:
        built.step()
    target = built.after(built.target) if built.after else built.target
    return target, rec, built.mesh


def record_combo(combo: Combo, device: str, rank: int = 0):
    """`record_step` as rank `rank` of the combo's world on the fake
    process group."""
    from distributed_model_parallel_tpu_torch.analysis.record import (
        fake_world,
    )

    with fake_world(rank, world_of(combo)):
        return record_step(combo, device)


def lint_recorded(combo: Combo, target: LintTarget, rec, mesh
                  ) -> LintReport:
    ctx = LintContext.build(target, rec.events, mesh)
    return LintReport(combo, target, run_rules(ctx), len(ctx.collectives))


def lint_combo(combo: Combo, device: str, rank: int = 0) -> LintReport:
    return lint_recorded(combo, *record_combo(combo, device, rank))


# ------------------------------------------------------------ matrix


def full_matrix() -> List[Combo]:
    """The reference's engine x mode matrix (`analysis/lint.full_matrix`),
    combo for combo, plus the port's EP x TP cell."""
    combos: List[Combo] = []
    for s in (2, 4, 8):
        combos += [Combo("cm_ag", s), Combo("cm_rs", s)]
        combos.append(Combo("dp", s))
        for gr in ("monolithic", "bucketed", "overlapped"):
            combos.append(Combo("ddp", s, grad_reduction=gr))
            combos.append(Combo("fsdp", s, grad_reduction=gr))
        combos.append(Combo("tp", s))
        combos.append(Combo("tp", s, collective_matmul=True))
        combos.append(Combo("sp", s))
        combos.append(Combo("sp", s, collective_matmul=True))
    for s in (4, 8):
        for gr in ("bucketed", "overlapped"):
            combos.append(Combo("ddp", s, grad_reduction=gr, dcn=2))
            combos.append(Combo("fsdp", s, grad_reduction=gr, dcn=2))
    for s in (2, 4):
        for gr in ("monolithic", "bucketed", "overlapped"):
            combos.append(Combo("sp_lm", s, grad_reduction=gr))
    combos.append(Combo("sp_lm", 4, grad_reduction="bucketed", dcn=2))
    combos.append(Combo("sp_lm", 2, collective_matmul=True))
    for s in (2, 4):
        combos.append(Combo("serve", s))
        combos.append(Combo("serve", s, collective_matmul=True))
    combos.append(Combo("serve", 2, page_size=8))
    combos.append(Combo("serve", 2, page_size=8, collective_matmul=True))
    combos.append(Combo("serve", 4, page_size=8, collective_matmul=True))
    combos.append(Combo("serve", 2, compute_dtype="int8"))
    combos.append(Combo("serve", 4, collective_matmul=True,
                        compute_dtype="int8"))
    combos.append(Combo("serve", 2, compute_dtype="bf16"))
    combos.append(Combo("serve", 2, collective_matmul=True,
                        compute_dtype="bf16"))
    combos.append(Combo("serve", 2, page_size=8, collective_matmul=True,
                        compute_dtype="int8"))
    combos.append(Combo("serve", 2, page_size=8, speculative_k=2))
    combos.append(Combo("serve", 4, page_size=8, collective_matmul=True,
                        speculative_k=2))
    combos.append(Combo("serve", 2, page_size=8, collective_matmul=True,
                        speculative_k=4))
    combos += [Combo("pipeline", 2), Combo("pipeline", 4)]
    combos.append(Combo("plan", 8, plan="pp2xsp2xdp2"))
    combos.append(Combo("plan", 8, plan="pp2xsp2xfsdp2"))
    combos.append(Combo("plan", 8, plan="pp2-1f1bxsp2xdp2"))
    combos.append(Combo("plan", 8, plan="pp2-int2xfsdp4"))
    combos.append(Combo("plan", 8, plan="pp2xdp4", num_microbatches=4))
    combos.append(Combo("plan", 8, plan="pp2-1f1bxdp4", num_microbatches=4))
    combos.append(Combo("plan", 8, plan="pp2-int2xdp4", num_microbatches=4))
    combos.append(Combo("tp", 4, collective_matmul=True, bf16=True))
    combos.append(Combo("sp", 4, collective_matmul=True, bf16=True))
    combos.append(Combo("ep", 4))
    combos.append(Combo("ep", 4, moe_dispatch="hierarchical"))
    combos.append(Combo("ep", 4, moe_dispatch="hierarchical",
                        moe_overlap=True))
    combos.append(Combo("ep", 8, dcn=2, moe_dispatch="hierarchical",
                        moe_overlap=True))
    combos.append(Combo("ddp", 4, grad_reduction="bucketed", dcn=2,
                        dcn_compression="bf16"))
    combos.append(Combo("ddp", 8, grad_reduction="overlapped", dcn=2,
                        dcn_compression="int8"))
    combos.append(Combo("ddp", 4, grad_reduction="monolithic", dcn=2,
                        dcn_compression="int8"))
    combos.append(Combo("fsdp", 4, grad_reduction="bucketed", dcn=2,
                        dcn_compression="bf16"))
    combos.append(Combo("fsdp", 8, grad_reduction="overlapped", dcn=2,
                        dcn_compression="int8"))
    combos.append(Combo("fsdp", 8, grad_reduction="monolithic", dcn=2,
                        dcn_compression="int8"))
    combos.append(Combo("sp_lm", 4, grad_reduction="bucketed", dcn=2,
                        dcn_compression="bf16"))
    combos.append(Combo("sp_lm", 4, grad_reduction="overlapped", dcn=2,
                        dcn_compression="int8"))
    combos.append(Combo("ep", 4, dcn=2, moe_dispatch="hierarchical",
                        dcn_compression="bf16"))
    combos.append(Combo("ep", 8, dcn=2, moe_dispatch="hierarchical",
                        moe_overlap=True, dcn_compression="int8"))
    # the port's EP x TP cells, with Megatron's f / g and on the rings
    combos.append(Combo("ep", 2, model_shards=2))
    combos.append(Combo("ep", 2, model_shards=2, collective_matmul=True))
    combos += pregate_matrix()
    return combos


def pregate_matrix() -> List[Combo]:
    """The reference's pre-gate subset: tinycnn DDP + FSDP overlapped
    (rings + overlap order + BN allowlist + at-rest), one hierarchical
    MoE combo on a hybrid fabric, one compressed hybrid combo, one
    quantized ringed serve combo, one speculative paged ringed serve
    combo and one composed plan."""
    return [
        Combo("ddp", 8, grad_reduction="overlapped", model="tinycnn"),
        Combo("fsdp", 8, grad_reduction="overlapped", model="tinycnn"),
        Combo("ep", 4, dcn=2, moe_dispatch="hierarchical",
              moe_overlap=True),
        Combo("ddp", 4, grad_reduction="bucketed", dcn=2,
              dcn_compression="int8", model="tinycnn"),
        Combo("serve", 2, collective_matmul=True, compute_dtype="int8"),
        Combo("serve", 2, page_size=8, collective_matmul=True,
              speculative_k=2),
        Combo("plan", 4, plan="pp2xsp2"),
    ]


# ------------------------------------------------------------ report


def format_report(rep: LintReport) -> str:
    exempt = len(rep.findings) - len(rep.violations)
    lines = [f"[hlolint] {rep.combo.name}: {rep.n_collectives} collectives, "
             f"{len(rep.violations)} violation(s)"
             + (f", {exempt} exempted" if exempt else "")]
    for f in rep.findings:
        mark = "EXEMPT" if f.exempted else f.severity.upper()
        lines.append(f"[hlolint]   {mark} {f.rule}: {f.message}"
                     + (f" (exempt: {f.exemption_reason})"
                        if f.exempted else ""))
    return "\n".join(lines)


def run(combos: Sequence[Combo], device: str,
        emit: Callable[[str], None] = print) -> dict:
    """Lint each combo, streaming one partial-JSON line per finished
    combo; returns (and emits) the final summary object."""
    reports = []
    for combo in combos:
        try:
            rep = lint_combo(combo, device)
        except Exception as e:  # a combo that fails to run is a finding
            emit(f"[hlolint] {combo.name}: RUN FAILED: {e!r}")
            emit(json.dumps({"leg": {"name": combo.name, "error": repr(e)},
                             "partial": True}))
            reports.append(None)
            continue
        emit(format_report(rep))
        emit(json.dumps({"leg": {
            "name": combo.name, "violations": len(rep.violations),
            "exempted": len(rep.findings) - len(rep.violations),
            "collectives": rep.n_collectives,
            "rules": sorted({f.rule for f in rep.violations}),
            "k4_launches": rep.target.k4_launches},
            "partial": True}))
        reports.append(rep)
    ok = [r for r in reports if r is not None]
    summary = {"hlo_lint": {
        "targets": len(combos),
        "lowered": len(ok),
        "rules": len(REGISTRY),
        "violations": sum(len(r.violations) for r in ok),
        "errors": sum(len(r.errors) for r in ok) + (len(combos) - len(ok)),
        "exempted": sum(len(r.findings) - len(r.violations) for r in ok),
        "failed_targets": sorted(
            {r.combo.name for r in ok if r.errors}
            | {c.name for c, r in zip(combos, reports) if r is None}),
        "failed_rules": sorted({f.rule for r in ok for f in r.errors}),
    }}
    emit(json.dumps(summary))
    return summary


def build_parser():
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m distributed_model_parallel_tpu_torch.analysis.lint",
        description=(
            "Collective-contract linter: run engine x mode combos as one "
            "rank of their world and check the rule registry against the "
            "collectives it issues."))
    parser.add_argument("--pregate", action="store_true",
                        help="the pre-gate subset of the matrix")
    parser.add_argument("--filter", default=None,
                        help="regex over combo names (e.g. 'ddp.*dcn')")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the engines compute")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in REGISTRY.values():
            extra = (f" (no counterpart: {r.no_counterpart})"
                     if r.no_counterpart else "")
            print(f"{r.id:32s} {r.severity:5s} {r.contract}{extra}")
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to lint on the CPU")
    combos = pregate_matrix() if args.pregate else full_matrix()
    if args.filter:
        combos = [c for c in combos if re.search(args.filter, c.name)]
    if not combos:
        print("[hlolint] no combos match", file=sys.stderr)
        return 2
    summary = run(combos, args.device)["hlo_lint"]
    if summary["errors"]:
        print("[hlolint] error-severity violations: "
              + ", ".join(summary["failed_rules"] or ["(a combo failed to "
                                                      "run)"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
