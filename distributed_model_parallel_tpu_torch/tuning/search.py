"""Deterministic enumerate-and-score search over one tuning cell (port of
`tuning/search.py`).

Two tiers of scoring, as in the reference:

1. **Closed-form pruning**: every candidate of the cell's space is
   priced with the alpha-beta closed forms (`observability/cost.py`)
   over the cell's payload model (gradient bytes and blocks counted from
   the port's own lint proxies). Cheap enough to score the whole
   cross-product.
2. **Recorded pricing of the argmin finalists**: the K best-ranked
   candidates run one step each as rank 0 of their world through the
   linter's builders (`analysis/lint.record_combo`: the same models,
   meshes and steps the rules and the costgate ledger judge), and the
   cost engine prices the collectives that rank issued
   (`cost.price_recorded`). The argmin over the finalists is the plan.
   The reference lowers its finalists and prices their compiled HLO.

The winner is then verified, not trusted: the linter's full rule
registry runs over the winner's own recorded step, and an error-severity
violation raises `PlanLintError` naming the rule instead of emitting the
plan.

Determinism contract (the reference's): candidates enumerate in
`space.candidates`'s sorted order, ties break on (score,
`space.preference`, canonical key), predicted times come from the
ledger-rounded `as_row()` form, so two searches of the same cell give
byte-identical plans (`plan.dumps_plan`), which `plangate` gates on.
Recording needs a process without a process group (`analysis/record.
fake_world`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from distributed_model_parallel_tpu_torch.tuning import space as tspace
from distributed_model_parallel_tpu_torch.tuning.plan import Cell, make_plan

#: How many closed-form-ranked candidates are recorded and priced (the
#: reference's 4; the brute-force test holds the pruned search to it).
DEFAULT_FINALISTS = 4


class PlanLintError(RuntimeError):
    """The searched argmin's recorded step violates a collective
    contract: the plan is NOT emitted."""


# ----------------------------------------------------- payload models


def _tree_bytes(params) -> int:
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def cell_payload(cell: Cell) -> dict:
    """The closed-form scorer's inputs for one cell, from the same lint
    proxies the finalists run: gradient bytes and block count for the
    reducer families (counted from the port's models, built at their
    tiny lint sizes), the dispatch buffer's elements for ep, the serve
    proxy's facts. tp has no closed-form payload (both its candidates
    are recorded)."""
    import torch

    from distributed_model_parallel_tpu_torch.analysis import lint as L

    if cell.family == "tp":
        return {}
    if cell.family == "serve":
        # `lint._build_serve`: GPT dim 16, 2 layers, 2S slots of a
        # 16-position cache; K+V f32 bytes a token across the stack, a
        # half-full batch of live tokens, one 8-token prompt, 8 new.
        return {
            "live_tokens": 2 * cell.size * 8,
            "prompt_tokens": 8,
            "new_tokens": 8,
            "token_bytes": 2 * 2 * 16 * 4,
            "n_slots": 2 * cell.size,
            "shards": cell.size,
        }
    if cell.family == "ep":
        # the moe_classifier's dispatch buffer a device
        ici = cell.size // cell.dcn
        n = max(8, ici * cell.dcn)
        seq, dim, top_k, cap = 8, 16, 2, 1.25
        return {"elems": int(top_k * cap * (n * seq / cell.size) * dim),
                "itemsize": 4}
    if cell.family == "plan":
        # `lint._build_plan`: sp_lm's tiny GPT fed ids of shape
        # (4 * dp * pp, 16), so every plan's microbatch carries 4 rows.
        from distributed_model_parallel_tpu_torch.models.gpt import (
            init_params,
        )

        cfg = L._gpt_cfg()
        grad_bytes = _tree_bytes(init_params(cfg))
        return {"grad_bytes": grad_bytes, "mb": 4,
                "seq_len": cfg.max_position, "dim": cfg.dim,
                "vocab": cfg.vocab_size, "n_layers": cfg.num_layers,
                "params": grad_bytes // 4}
    if cell.family in ("ddp", "fsdp"):
        if cell.model == "tinycnn":
            from distributed_model_parallel_tpu_torch.models.tinycnn import (
                tiny_cnn,
            )

            model = tiny_cnn(4)
        else:
            model = L.staged_mlp(width=128 if cell.family == "fsdp" else 32)
    else:  # sp_lm
        from distributed_model_parallel_tpu_torch.models.gpt import (
            gpt_lm_model,
        )

        model = gpt_lm_model(L._gpt_cfg())
    params, _ = model.init(torch.Generator().manual_seed(0))
    return {"grad_bytes": _tree_bytes(params),
            "n_blocks": len(model.parts.blocks)}


# --------------------------------------------------- closed-form tier


def reducer_closed_form_s(knobs: dict, grad_bytes: int, ici: int, dcn: int,
                          n_blocks: int = 4,
                          constants: Optional[Dict[str, float]] = None
                          ) -> float:
    """Predicted gradient-reduction comm time a step for one reducer
    candidate: the ring / two-level forms keyed off the knobs, with
    ceil(bytes / bucket) buckets (at least one a stagewise segment under
    'overlapped')."""
    from distributed_model_parallel_tpu_torch.observability import cost

    gr = knobs["grad_reduction"]
    wire = knobs["dcn_compression"]
    size = ici * dcn
    if gr == "monolithic":
        if wire == "none":
            bw_ici, a_ici, bw_dcn, a_dcn = cost._resolve_constants(constants)
            if dcn > 1:
                # one fused all-reduce across nodes: the slow fabric
                # gates the whole ring
                return cost.ring_all_reduce_s(grad_bytes, size, n_ops=1,
                                              bw=bw_dcn, alpha=a_dcn)
            return cost.ring_all_reduce_s(grad_bytes, size, n_ops=1,
                                          bw=bw_ici, alpha=a_ici)
        # compressed monolithic rides ONE flat bucket
        return cost.two_level_all_reduce_s(grad_bytes, ici, dcn,
                                           n_buckets=1, wire=wire,
                                           constants=constants)
    n_seg = 1
    if gr == "overlapped":
        n_seg = knobs["overlap_stages"] or min(4, n_blocks)
    n_buckets = max(n_seg,
                    math.ceil(grad_bytes / (knobs["bucket_mb"] * 2 ** 20)))
    return cost.two_level_all_reduce_s(grad_bytes, ici, dcn,
                                       n_buckets=n_buckets, wire=wire,
                                       constants=constants)


def moe_closed_form_s(knobs: dict, elems: int, itemsize: int, ici: int,
                      dcn: int,
                      constants: Optional[Dict[str, float]] = None) -> float:
    """Predicted dispatch + combine comm time for one ep candidate.
    Overlap reshapes the schedule, not the asks: it prices the same and
    wins on the tie-break."""
    from distributed_model_parallel_tpu_torch.observability import cost

    if knobs["dispatch"] == "gspmd":
        return 2 * cost.flat_all_to_all_s(elems, itemsize, ici, dcn,
                                          constants=constants)
    wire = knobs["dcn_compression"]
    return 2 * cost.hierarchical_all_to_all_s(
        elems, itemsize, ici, dcn, wire=None if wire == "none" else wire,
        constants=constants)


def serve_closed_form_s(knobs: dict, payload: dict,
                        constants: Optional[Dict[str, float]] = None
                        ) -> float:
    """Predicted per-request cost for one paged serving candidate: the
    paged form over the serve proxy's payload plus the compute mode's
    roofline over the request's decode steps (under this module's
    compute constants: `constants` is the fabric set), or the
    speculative form for k >= 1."""
    from distributed_model_parallel_tpu_torch.observability import cost

    mode = knobs.get("compute_dtype") or "f32"
    spec_k = knobs.get("speculative_k") or 0
    decode_c = cost.serve_decode_compute_s(
        layers=2, dim=16, ffn_dim=32, n_slots=payload["n_slots"],
        mode=mode, shards=payload.get("shards", 1))
    if spec_k:
        return cost.serve_speculative_request_s(
            payload["prompt_tokens"], payload["new_tokens"],
            payload["token_bytes"], knobs["page_size"],
            knobs["prefill_chunk"], spec_k,
            decode_compute_s=decode_c,
            verify_compute_s=cost.serve_verify_compute_s(
                layers=2, dim=16, ffn_dim=32, n_slots=payload["n_slots"],
                speculative_k=spec_k, mode=mode,
                shards=payload.get("shards", 1)),
            constants=constants)
    comm = cost.serve_paged_request_s(
        payload["live_tokens"], payload["prompt_tokens"],
        payload["new_tokens"], payload["token_bytes"], knobs["page_size"],
        knobs["prefill_chunk"], constants=constants)
    return comm + payload["new_tokens"] * decode_c


def plan_closed_form_s(knobs: dict, payload: dict, ici: int, dcn: int,
                       constants: Optional[Dict[str, float]] = None
                       ) -> float:
    """Predicted step time for one composed-plan candidate:
    `cost.composed_plan_step_s` over the spec's factorization, with the
    proxy's ideal compute under the schedule's bubble factor."""
    from distributed_model_parallel_tpu_torch.observability import cost

    ax = tspace.plan_spec_axes(knobs["plan"])
    m = knobs.get("num_microbatches") or 0
    mb = payload["mb"]
    if m:
        # the proxy batch is fixed; a deeper fill splits it thinner
        mb = max(1, payload["mb"] * ax["pp"] // m)
    compute_s = cost.plan_step_compute_s(
        payload["params"],
        payload["mb"] * ax["dp"] * ax["pp"] * payload["seq_len"],
        ax["pp"] * ax["sp"] * ax["dp"],
        constants=constants) if "params" in payload else 0.0
    return cost.composed_plan_step_s(
        ax["pp"], ax["sp"], ax["dp"], payload["grad_bytes"], mb,
        payload["seq_len"], payload["dim"], payload["vocab"],
        payload["n_layers"], ici, dcn, fsdp=ax["fsdp"], constants=constants,
        schedule=ax["schedule"], virtual_stages=ax["virtual"],
        num_microbatches=m, compute_s=compute_s)


def closed_form_step_s(family: str, knobs: dict, payload: dict, ici: int,
                       dcn: int,
                       constants: Optional[Dict[str, float]] = None
                       ) -> float:
    if family in ("ddp", "fsdp", "sp_lm"):
        return reducer_closed_form_s(knobs, payload["grad_bytes"], ici, dcn,
                                     n_blocks=payload.get("n_blocks", 4),
                                     constants=constants)
    if family == "ep":
        return moe_closed_form_s(knobs, payload["elems"],
                                 payload["itemsize"], ici, dcn,
                                 constants=constants)
    if family == "serve":
        return serve_closed_form_s(knobs, payload, constants)
    if family == "plan":
        return plan_closed_form_s(knobs, payload, ici, dcn, constants)
    return 0.0  # tp: both candidates are finalists; the record decides


def rank_candidates(family: str, cands: Sequence[dict], payload: dict,
                    ici: int, dcn: int,
                    constants: Optional[Dict[str, float]] = None
                    ) -> List[Tuple[float, dict]]:
    """[(closed_form_s, knobs)] in the search's deterministic order:
    score, then `space.preference`, then the canonical key."""
    scored = [(closed_form_step_s(family, k, payload, ici, dcn, constants),
               tspace.preference(family, k), tspace.canonical_key(k), k)
              for k in cands]
    scored.sort(key=lambda t: t[:3])
    return [(s, k) for s, _, _, k in scored]


def closed_form_argmin(family: str, payload: dict, ici: int, dcn: int,
                       constants: Optional[Dict[str, float]] = None,
                       allow_cm: bool = True) -> Tuple[dict, float]:
    """(argmin knobs, predicted seconds) under the closed forms alone."""
    ranked = rank_candidates(
        family, tspace.candidates(family, dcn, allow_cm=allow_cm,
                                  size=ici * dcn),
        payload, ici, dcn, constants)
    score, knobs = ranked[0]
    return knobs, score


# ------------------------------------------------------- recorded tier


def candidate_combo(cell: Cell, knobs: dict):
    """One candidate in the lint matrix's Combo vocabulary, so that it
    is recorded, priced and linted through the same builders as the
    matrix."""
    from distributed_model_parallel_tpu_torch.analysis.lint import Combo

    if cell.family in ("ddp", "fsdp", "sp_lm"):
        return Combo(cell.family, cell.size,
                     grad_reduction=knobs["grad_reduction"], dcn=cell.dcn,
                     model=cell.model,
                     dcn_compression=knobs["dcn_compression"],
                     collective_matmul=bool(knobs.get("collective_matmul")),
                     bucket_mb=knobs["bucket_mb"],
                     overlap_stages=knobs["overlap_stages"] or 0)
    if cell.family == "ep":
        return Combo("ep", cell.size, dcn=cell.dcn,
                     moe_dispatch=knobs["dispatch"],
                     moe_overlap=knobs["overlap"],
                     dcn_compression=knobs["dcn_compression"])
    if cell.family == "tp":
        return Combo("tp", cell.size,
                     collective_matmul=knobs["collective_matmul"])
    if cell.family == "plan":
        return Combo("plan", cell.size, plan=knobs["plan"],
                     num_microbatches=knobs.get("num_microbatches") or 0)
    if cell.family == "serve":
        # prefill_chunk shapes the host loop only: it rides the name and
        # the closed form decides it; "f32" is the Combo's None
        mode = knobs.get("compute_dtype") or "f32"
        return Combo("serve", cell.size, page_size=knobs["page_size"],
                     prefill_chunk=knobs["prefill_chunk"],
                     compute_dtype=None if mode == "f32" else mode,
                     speculative_k=knobs.get("speculative_k") or 0)
    raise ValueError(f"no combo mapping for family {cell.family!r}")


def _record_and_price(combo, device: str, constants):
    """(target, recording, mesh model, ledger row): ONE recorded step
    feeds both the pricing and, for the winner, the lint pass."""
    from distributed_model_parallel_tpu_torch.analysis.lint import (
        record_combo,
    )
    from distributed_model_parallel_tpu_torch.observability.cost import (
        price_recorded,
    )

    target, rec, mesh = record_combo(combo, device)
    return target, rec, mesh, price_recorded(combo, target, rec, mesh,
                                             constants)


def search_cell(cell: Cell,
                constants: Optional[Dict[str, float]] = None,
                constants_source: str = "hand",
                finalists: Optional[int] = DEFAULT_FINALISTS,
                space_knobs: Optional[Sequence[dict]] = None,
                allow_cm: bool = True,
                device: str = "cuda",
                emit=None) -> dict:
    """Search one cell and return its validated plan dict.

    `finalists=None` (or 0) records EVERY candidate (the brute-force
    mode the tests hold the pruned search to). `space_knobs` overrides
    the family's space. `constants` is a CONSTANTS-shaped dict (e.g.
    `cost.load_calibration(path)`) and `constants_source` names where it
    came from ("hand" = this tree's committed constants, the reference's
    name). The finalists' steps run on `device`."""
    from distributed_model_parallel_tpu_torch.analysis.lint import (
        lint_recorded,
    )
    from distributed_model_parallel_tpu_torch.analysis.rules import REGISTRY
    from distributed_model_parallel_tpu_torch.observability.cost import (
        CONSTANTS,
    )
    from distributed_model_parallel_tpu_torch.tuning.plan import (
        validate_plan,
    )

    say = emit if emit is not None else (lambda s: None)
    if space_knobs is not None:
        cands = list(space_knobs)
    elif cell.family == "plan" and cell.model == "sched":
        # the scheduled cell is a scoped comparison: gpipe vs 1f1b vs
        # int2 at fixed pp x M
        cands = tspace.scheduled_plan_candidates(cell.size)
    else:
        cands = list(tspace.candidates(cell.family, cell.dcn,
                                       allow_cm=allow_cm, size=cell.size))
    if not cands:
        raise ValueError(f"{cell.name}: empty candidate space")
    ici = cell.size // cell.dcn
    payload = cell_payload(cell)
    ranked = rank_candidates(cell.family, cands, payload, ici, cell.dcn,
                             constants)
    k = len(ranked) if not finalists else min(finalists, len(ranked))
    say(f"[tuning] {cell.name}: {len(ranked)} candidate(s), "
        f"recording the top {k}")

    recorded = []
    for closed_s, knobs in ranked[:k]:
        combo = candidate_combo(cell, knobs)
        target, rec, mesh, row = _record_and_price(combo, device, constants)
        say(f"[tuning]   {combo.name}: closed-form "
            f"{closed_s * 1e3:.4f} ms -> recorded "
            f"{row['predicted_step_s'] * 1e3:.4f} ms/step")
        recorded.append((row["predicted_step_s"],
                         tspace.preference(cell.family, knobs),
                         tspace.canonical_key(knobs), knobs, combo, row,
                         target, rec, mesh))
    recorded.sort(key=lambda t: t[:3])
    (_, _, _, best_knobs, best_combo, best_row, target, rec,
     mesh) = recorded[0]

    # Verify, don't trust: the full registry over the winner's own step.
    report = lint_recorded(best_combo, target, rec, mesh)
    if report.errors:
        raise PlanLintError(
            f"{cell.name}: the searched argmin {best_combo.name} violates "
            "collective contract(s) "
            f"{', '.join(sorted({f.rule for f in report.errors}))} — plan "
            "NOT emitted (analysis/lint.py --list-rules has the catalog)")
    say(f"[tuning] {cell.name}: argmin {best_combo.name} "
        f"({best_row['predicted_step_s'] * 1e3:.4f} ms/step), "
        f"lint clean over {len(REGISTRY)} rules")

    plan = make_plan(
        cell, best_knobs, best_combo.name, best_row, constants_source,
        dict(CONSTANTS) if constants is None else dict(constants),
        search={
            "candidates": len(ranked),
            "lowered": k,
            "finalist_combos": [t[4].name for t in recorded],
            "lint_violations": len(report.violations),
            "lint_rules": len(REGISTRY),
        })
    return validate_plan(plan)


__all__ = [
    "DEFAULT_FINALISTS", "PlanLintError", "candidate_combo", "cell_payload",
    "closed_form_argmin", "closed_form_step_s", "moe_closed_form_s",
    "plan_closed_form_s", "rank_candidates", "reducer_closed_form_s",
    "search_cell", "serve_closed_form_s",
]
