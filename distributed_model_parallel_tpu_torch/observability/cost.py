"""Static alpha-beta cost engine over the port's recorded collectives
(port of `observability/cost.py`).

One home for the per-fabric alpha / beta constants and the compute
roofline constants of the card the port runs on, and two layers on top
of them:

1. **Closed-form compositions**: the ring, two-level, all-to-all, plan,
   serve and speculative forms of the reference, formula for formula.
   Each multi-fabric form takes an optional `constants` dict (the
   CONSTANTS key set), so that a caller can price under another set (a
   loaded calibration, or the reference's own constants in the parity
   tests).

2. **The walker** (`predict_collectives` / `combo_cost`): where the
   reference prices the collectives of a combo's compiled HLO, this one
   prices what one rank of the combo really issues in one step, as the
   linter records it (`analysis/lint.record_combo`: rank 0 of the
   combo's world on torch's fake process group). Each record is priced
   on the fabric it crosses with the ring model of its kind:

     send            one ring hop (the reference's collective-permute)
     recv            free: its sender pays
     all_reduce      2(g - 1) hops, 2(g - 1)/g of the payload
     all_gather      (g - 1) hops; the payload a rank hands to it is its
                     shard, so the gathered whole is g x the record's
     reduce_scatter, all_to_all, broadcast
                     (g - 1) hops, (g - 1)/g of the payload

   A rank's record holds every collective of an SPMD step once, as the
   reference's program does; a pipeline's stage-0 rank holds its sends
   and only receives the other stages' hops, which are free here.

Payload bytes, by design: the port records each call's real wire dtype,
so a bf16 collective costs bf16 bytes. The reference's CPU lowering
float-normalizes bf16 collectives and prices their f32 envelope
(reference `cost.py:23-27`); a bf16 combo's beta term here is the half
of the reference's for that reason alone. The prediction is comm time
(plus the plan and serve combos' compute roofline terms, as in the
reference); it ranks configurations and gates regressions in what a
program asks the network for, it does not predict wall clock.

The constants are an NVIDIA H100 SXM5 80GB HBM3 at 700 W, each with its
source beside it. No datasheet gives a per-hop latency: the two alphas
are priors, to be replaced by a fit of measured legs
(`observability/calibrate.py`, `cost.load_calibration`). The key names
and the calibration schema are the reference's, so either package reads
the other's calibration files.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Sequence

# ------------------------------------------------- per-fabric constants
#
# 'ici' is the fast fabric inside a node: NVLink 4. NVIDIA H100 SXM5
# datasheet: 18 NVLink links, 900 GB/s of bidirectional bandwidth a GPU,
# i.e. 450 GB/s each way.
BW_ICI_EFFECTIVE = 450e9  # bytes/s a ring direction (H100 SXM5 datasheet)
# Per-hop latency of one collective step on NVLink (alpha): a PRIOR, not
# a measurement (no datasheet gives it); calibrate.py fits it from
# measured legs.
ALPHA_HOP_S = 2e-6  # prior
# 'dcn' is the network between nodes: one 400 Gb/s NDR InfiniBand NIC a
# GPU (the DGX H100 / HGX H100 reference design: eight ConnectX-7 400G
# ports for eight GPUs), i.e. 50 GB/s each way.
BW_DCN_EFFECTIVE = 50e9  # bytes/s across nodes (400 Gb/s NDR, one a GPU)
# Per-hop latency across nodes (alpha): a PRIOR, not a measurement (a
# routed InfiniBand hop plus the NIC's, set above NVLink's).
ALPHA_DCN_HOP_S = 5e-6  # prior

# Wire itemsize per `dcn_compression` mode (`ops/wire_codec.py`): what
# one element of a compressed cross-node payload costs on the wire.
WIRE_ITEMSIZE = {"none": 4, "f32": 4, "bf16": 2, "int8": 1}

# Decode- and train-compute roofline constants (`ops/quant_matmul.py`,
# `plan_step_compute_s`), H100 SXM5 datasheet:
BW_HBM_EFFECTIVE = 3.35e12  # bytes/s HBM3 (H100 SXM5 datasheet)
# flop/s (multiply-accumulate = 2 flop) a compute mode. bf16 and int8 are
# the dense tensor-core peaks (989 TFLOP/s, 1,979 TOP/s, H100 SXM5
# datasheet, without sparsity). f32 is the CUDA cores' 67 TFLOP/s (the
# datasheet's FP32 row): `cli/common.set_device_numerics` switches TF32
# off, so no f32 product runs on the tensor cores. The name is the
# reference's (its keys read `mxu_*`).
MXU_RATE = {
    "f32": 67e12,     # H100 SXM5 FP32 (CUDA cores; TF32 off)
    "bf16": 989e12,   # H100 SXM5 dense BF16 tensor core
    "int8": 1979e12,  # H100 SXM5 dense INT8 tensor core
}
# What one weight element costs on the HBM stream per compute mode.
COMPUTE_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}

# Speculative-decoding workload assumptions (`serving/speculative.py`),
# the reference's: not physics but a model pairing's accept rate and the
# serve CLI's default draft (layers // 2 of the target at its width).
SPEC_MODEL_ACCEPT = 0.7
DRAFT_COST_RATIO = 0.5

#: Every constant the predictions depend on, by name (the reference's
#: keys): CONSTANTS is the fabric set `calibrate.py` fits;
#: COMPUTE_CONSTANTS the roofline set and the speculative assumptions.
#: The ledger records and drift-checks both.
CONSTANTS: Dict[str, float] = {
    "bw_ici_effective_bytes_per_s": BW_ICI_EFFECTIVE,
    "bw_dcn_effective_bytes_per_s": BW_DCN_EFFECTIVE,
    "alpha_hop_s": ALPHA_HOP_S,
    "alpha_dcn_hop_s": ALPHA_DCN_HOP_S,
}

COMPUTE_CONSTANTS: Dict[str, float] = {
    "bw_hbm_effective_bytes_per_s": BW_HBM_EFFECTIVE,
    "mxu_f32_flop_per_s": MXU_RATE["f32"],
    "mxu_bf16_flop_per_s": MXU_RATE["bf16"],
    "mxu_int8_flop_per_s": MXU_RATE["int8"],
    "spec_model_accept_rate": SPEC_MODEL_ACCEPT,
    "spec_draft_cost_ratio": DRAFT_COST_RATIO,
}


@dataclasses.dataclass(frozen=True)
class Fabric:
    """One link class in the alpha-beta model."""

    name: str
    alpha_s: float
    bw_bytes_per_s: float


ICI = Fabric("ici", ALPHA_HOP_S, BW_ICI_EFFECTIVE)
DCN = Fabric("dcn", ALPHA_DCN_HOP_S, BW_DCN_EFFECTIVE)


def load_calibration(path: str) -> Dict[str, float]:
    """The fabric constants of a `calibrate.py` artifact (schema
    `dmpt.calibration.v1`, either package's). Every CONSTANTS key must
    have a fitted value."""
    with open(path) as f:
        data = json.load(f)
    constants = data.get("constants")
    if not isinstance(constants, dict):
        raise ValueError(f"{path}: not a calibration file "
                         "(no 'constants' object)")
    missing = sorted(set(CONSTANTS) - set(constants))
    if missing:
        raise ValueError(
            f"{path}: calibration is missing constants "
            f"{', '.join(missing)} — refit with calibrate.py")
    return {k: float(constants[k]) for k in CONSTANTS}


def fabrics_from_constants(constants: Dict[str, float]
                           ) -> "tuple[Fabric, Fabric]":
    """(ICI, DCN) fabrics under explicit constants."""
    return (Fabric("ici", constants["alpha_hop_s"],
                   constants["bw_ici_effective_bytes_per_s"]),
            Fabric("dcn", constants["alpha_dcn_hop_s"],
                   constants["bw_dcn_effective_bytes_per_s"]))


# ------------------------------------------- closed-form compositions


def _resolve_constants(constants: Optional[Dict[str, float]]):
    """(bw_ici, alpha_ici, bw_dcn, alpha_dcn) under explicit constants
    (validated against the CONSTANTS key set) or this module's."""
    if constants is None:
        return (BW_ICI_EFFECTIVE, ALPHA_HOP_S, BW_DCN_EFFECTIVE,
                ALPHA_DCN_HOP_S)
    missing = sorted(set(CONSTANTS) - set(constants))
    if missing:
        raise ValueError(
            f"constants set is missing {', '.join(missing)} — pass a "
            "full CONSTANTS-shaped dict (cost.load_calibration "
            "validates calibration files into one)")
    return (constants["bw_ici_effective_bytes_per_s"],
            constants["alpha_hop_s"],
            constants["bw_dcn_effective_bytes_per_s"],
            constants["alpha_dcn_hop_s"])


def ring_all_reduce_s(nbytes: float, size: int, n_ops: int = 1,
                      bw: float = BW_ICI_EFFECTIVE,
                      alpha: float = ALPHA_HOP_S) -> float:
    """Single-fabric ring all-reduce: 2(S-1)/S of the payload on the
    wire, 2(S-1) latency hops an op (`n_ops` ops unfused)."""
    if size <= 1:
        return 0.0
    beta = 2 * (size - 1) / size * nbytes / bw
    return beta + n_ops * 2 * (size - 1) * alpha


def two_level_all_reduce_s(nbytes: float, ici: int, dcn: int,
                           n_buckets: int = 1, wire: str = "none",
                           constants: Optional[Dict[str, float]] = None
                           ) -> float:
    """Hierarchical bucketed reduction over a dcn x ici fabric: ring
    reduce-scatter + all-gather over 'ici' at the full payload, the 1/ici
    shard across 'dcn' at the wire itemsize (int8 adds one sidecar hop a
    payload hop, counted in alpha)."""
    bw_ici, a_ici, bw_dcn, a_dcn = _resolve_constants(constants)
    wb = WIRE_ITEMSIZE[wire]
    sidecar_hops = 1 if wire == "int8" else 0
    beta = 2 * (ici - 1) / ici * nbytes / bw_ici
    if dcn > 1:
        beta += 2 * (dcn - 1) / dcn * (nbytes / ici) * (wb / 4) / bw_dcn
    alpha = n_buckets * (2 * (ici - 1) * a_ici
                         + (1 + sidecar_hops) * 2 * (dcn - 1) * a_dcn)
    return beta + alpha


def plan_bubble_factor(pp: int, schedule: str = "gpipe",
                       virtual_stages: int = 1,
                       num_microbatches: int = 0) -> float:
    """Pipeline-span stretch over ideal compute, (V*M + pp - 1) / (V*M);
    gpipe and 1F1B share the fill-drain span, interleaving divides the
    bubble by V. M defaults to pp (pp*V interleaved)."""
    if pp <= 1:
        return 1.0
    v = virtual_stages if schedule == "interleaved" else 1
    m = num_microbatches or pp * v
    return (v * m + pp - 1.0) / (v * m)


def composed_plan_step_s(pp: int, sp: int, dp: int, grad_bytes: float,
                         mb: int, seq_len: int, dim: int, vocab: int,
                         n_layers: int, ici: int, dcn: int,
                         fsdp: bool = False,
                         constants: Optional[Dict[str, float]] = None,
                         schedule: str = "gpipe", virtual_stages: int = 1,
                         num_microbatches: int = 0,
                         compute_s: float = 0.0) -> float:
    """Asked-bytes step time of one composed plan training step
    (`parallel/plan.py`): the stage wire (M + pp - 1 ticks under gpipe,
    2*M*V + 2*(pp-1) under a scheduled plan, each one microbatch's
    mb x (seq_len/sp) x max(dim, vocab) f32 activations; across 'dcn'
    when the fabric is factored), the ring-attention KV hops on 'ici',
    ONE fused gradient reduction (two-level at dcn > 1, else a flat
    ring), FSDP's parameter gather over 'data', and `compute_s` under the
    schedule's bubble factor."""
    bw_ici, a_ici, bw_dcn, a_dcn = _resolve_constants(constants)
    v = virtual_stages if schedule == "interleaved" else 1
    m = num_microbatches or pp * v
    scheduled = schedule != "gpipe" and pp > 1
    ticks = 2 * m * v + 2 * (pp - 1) if scheduled else m + pp - 1
    total = 0.0
    if pp > 1:
        wire_bytes = mb * (seq_len // sp) * max(dim, vocab) * 4
        bw, a = (bw_dcn, a_dcn) if dcn > 1 else (bw_ici, a_ici)
        total += ticks * (a + wire_bytes / bw)
    if sp > 1:
        kv_bytes = 2 * mb * (seq_len // sp) * dim * 4
        total += (ticks * (n_layers // (pp * v)) * (sp - 1)
                  * (a_ici + kv_bytes / bw_ici))
    group = pp * sp * dp
    if group > 1:
        if dcn > 1:
            total += two_level_all_reduce_s(grad_bytes, group // dcn, dcn,
                                            n_buckets=1, constants=constants)
        else:
            total += ring_all_reduce_s(grad_bytes, group, 1, bw_ici, a_ici)
    if fsdp and dp > 1:
        bw, a = ((bw_dcn, a_dcn) if (dcn > 1 and pp == 1)
                 else (bw_ici, a_ici))
        total += (dp - 1) * a + (dp - 1) / dp * grad_bytes / bw
    if compute_s:
        total += compute_s * plan_bubble_factor(pp, schedule, virtual_stages,
                                                num_microbatches)
    return total


def _resolve_compute_constants(constants: Optional[Dict[str, float]]
                               ) -> Dict[str, float]:
    """A full COMPUTE_CONSTANTS-shaped dict, validated, or this
    module's."""
    if constants is None:
        return COMPUTE_CONSTANTS
    missing = sorted(set(COMPUTE_CONSTANTS) - set(constants))
    if missing:
        raise ValueError(
            f"compute constants set is missing {', '.join(missing)} — "
            "pass a full COMPUTE_CONSTANTS-shaped dict")
    return constants


def plan_step_compute_s(n_params: float, tokens: float, shards: int,
                        mode: str = "f32",
                        constants: Optional[Dict[str, float]] = None
                        ) -> float:
    """Ideal per-device arithmetic of one dense train step: 6 flop a
    parameter a token (2 forward + 4 backward), over the plan's shards,
    at the mode's rate."""
    if mode not in MXU_RATE:
        raise ValueError(
            f"mode must be one of {sorted(MXU_RATE)}, got {mode!r}")
    c = _resolve_compute_constants(constants)
    return 6.0 * n_params * tokens / shards / c[f"mxu_{mode}_flop_per_s"]


def flat_all_to_all_s(elems: int, itemsize: int, ici: int, dcn: int,
                      constants: Optional[Dict[str, float]] = None
                      ) -> float:
    """One flat token exchange over the joint dcn x ici fabric: (K-1)/K
    of the payload crosses nodes in (K-1)*I fragments; the intra-node
    share rides 'ici'."""
    bw_ici, a_ici, bw_dcn, a_dcn = _resolve_constants(constants)
    x_bytes = elems * itemsize
    n = ici * dcn
    return ((dcn - 1) / dcn * x_bytes / bw_dcn
            + (ici - 1) / n * x_bytes / bw_ici
            + (dcn - 1) * ici * a_dcn + (ici - 1) * a_ici)


def hierarchical_all_to_all_s(elems: int, itemsize: int, ici: int,
                              dcn: int, wire: Optional[str] = None,
                              constants: Optional[Dict[str, float]] = None
                              ) -> float:
    """One two-level token exchange (`ops/expert_dispatch.py`): the flat
    form's cross-node bytes in K-1 contiguous messages of the
    1/ici-regrouped shard, at the wire itemsize when compressed, and the
    intra-node share on 'ici' alone."""
    bw_ici, a_ici, bw_dcn, a_dcn = _resolve_constants(constants)
    x_bytes = elems * itemsize
    dcn_itemsize = (itemsize if wire in (None, "none")
                    else WIRE_ITEMSIZE[wire])
    return ((dcn - 1) / dcn * (elems * dcn_itemsize) / bw_dcn
            + (ici - 1) / ici * x_bytes / bw_ici
            + (dcn - 1) * a_dcn + (ici - 1) * a_ici)


def serve_paged_request_s(live_tokens: int, prompt_tokens: int,
                          new_tokens: int, token_bytes: int,
                          page_size: int, prefill_chunk: int,
                          constants: Optional[Dict[str, float]] = None
                          ) -> float:
    """Per-request cost of one paged, chunked serving configuration: one
    page of write-back a generated token and one allocation a page of
    the sequence's lifetime (page_size), ceil(prompt/c) chunk launches
    over the padded positions (prefill_chunk), priced with the 'ici'
    constant pair as the on-device proxy. `live_tokens` is accepted for
    the payload's shape and not priced (the batch's gather reads the
    whole block table whatever the page size). Both knobs must be >= 1
    (0 is the contiguous / monolithic sentinel)."""
    if page_size < 1 or prefill_chunk < 1:
        raise ValueError(
            "serve_paged_request_s prices paged+chunked serving: "
            f"page_size ({page_size}) and prefill_chunk "
            f"({prefill_chunk}) must be >= 1 (0 is the "
            "contiguous/monolithic sentinel, which this form cannot "
            "price)")
    del live_tokens
    bw_ici, a_ici, _, _ = _resolve_constants(constants)
    total_tokens = prompt_tokens + new_tokens
    decode_writes = new_tokens * (a_ici + page_size * token_bytes / bw_ici)
    allocations = -(-total_tokens // page_size) * a_ici
    chunks = -(-prompt_tokens // prefill_chunk)
    prefill = chunks * a_ici + chunks * prefill_chunk * token_bytes / bw_ici
    return prefill + decode_writes + allocations


def quant_matmul_s(m: int, k: int, n: int, mode: str = "f32",
                   constants: Optional[Dict[str, float]] = None) -> float:
    """Roofline time of ONE decode projection GEMM (m, k) x (k, n) in
    `mode` arithmetic (`ops/quant_matmul.py`): the larger of the weight
    stream's HBM time and the products' time at the mode's rate."""
    if mode not in MXU_RATE:
        raise ValueError(
            f"mode must be one of {sorted(MXU_RATE)}, got {mode!r}")
    c = _resolve_compute_constants(constants)
    hbm_s = k * n * COMPUTE_ITEMSIZE[mode] / c["bw_hbm_effective_bytes_per_s"]
    mxu_s = 2.0 * m * k * n / c[f"mxu_{mode}_flop_per_s"]
    return max(hbm_s, mxu_s)


def serve_decode_compute_s(layers: int, dim: int, ffn_dim: int,
                           n_slots: int, mode: str = "f32",
                           shards: int = 1,
                           constants: Optional[Dict[str, float]] = None
                           ) -> float:
    """Projection-GEMM compute of one decode step: qkv, attention out,
    FFN in and out a block, each 1/shards a device under the tp layout.
    The head and the attention products are mode-neutral and not
    priced."""
    projections = ((dim, 3 * dim), (dim, dim), (dim, ffn_dim),
                   (ffn_dim, dim))
    per_block = sum(quant_matmul_s(n_slots, k, -(-n // shards), mode,
                                   constants)
                    for k, n in projections)
    return layers * per_block


def serve_combo_compute_s(combo,
                          constants: Optional[Dict[str, float]] = None
                          ) -> float:
    """The decode-compute roofline of one lint serve combo (the proxy of
    `analysis/lint._build_serve`: GPT dim 16, FFN 32, 2 layers, 2*S
    slots over S 'model' shards)."""
    return serve_decode_compute_s(
        layers=2, dim=16, ffn_dim=32, n_slots=2 * combo.size,
        mode=combo.compute_dtype or "f32", shards=combo.size,
        constants=constants)


# ------------------------------------------------ speculative decoding


def speculative_expected_tokens(accept_rate: float, k: int) -> float:
    """Expected accepted tokens a speculative round (Leviathan et al.,
    ICML'23 eq. 1): (1 - acc^(k+1)) / (1 - acc); k = 0 gives 1, acc = 1
    gives k + 1."""
    if k <= 0:
        return 1.0
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(
            f"accept_rate must be in [0, 1], got {accept_rate!r}")
    if accept_rate >= 1.0:
        return float(k + 1)
    return (1.0 - accept_rate ** (k + 1)) / (1.0 - accept_rate)


def serve_verify_compute_s(layers: int, dim: int, ffn_dim: int,
                           n_slots: int, speculative_k: int,
                           mode: str = "f32", shards: int = 1,
                           constants: Optional[Dict[str, float]] = None
                           ) -> float:
    """Projection-GEMM roofline of one verify step: the decode form at
    m = n_slots * (k + 1)."""
    return serve_decode_compute_s(layers, dim, ffn_dim,
                                  n_slots * (speculative_k + 1), mode,
                                  shards, constants)


def serve_speculative_token_s(decode_step_s: float, verify_step_s: float,
                              speculative_k: int,
                              accept_rate: Optional[float] = None,
                              draft_cost_ratio: Optional[float] = None,
                              constants: Optional[Dict[str, float]] = None
                              ) -> float:
    """Per-accepted-token cost of one speculative round: k draft steps at
    the draft-cost ratio of a target step plus one verify step, over the
    round's expected accepted tokens."""
    if speculative_k < 1:
        raise ValueError(
            "serve_speculative_token_s prices k >= 1 rounds (a plain "
            "decode step IS the k=0 per-token cost)")
    c = _resolve_compute_constants(constants)
    acc = c["spec_model_accept_rate"] if accept_rate is None else accept_rate
    ratio = (c["spec_draft_cost_ratio"] if draft_cost_ratio is None
             else draft_cost_ratio)
    e = speculative_expected_tokens(acc, speculative_k)
    return (speculative_k * ratio * decode_step_s + verify_step_s) / e


def serve_speculative_request_s(prompt_tokens: int, new_tokens: int,
                                token_bytes: int, page_size: int,
                                prefill_chunk: int, speculative_k: int,
                                decode_compute_s: float = 0.0,
                                verify_compute_s: float = 0.0,
                                constants: Optional[Dict[str, float]] = None,
                                compute_constants: Optional[
                                    Dict[str, float]] = None) -> float:
    """Per-request cost of speculative paged serving: the paged form's
    prefill (the draft's at its cost ratio too) and allocations, and
    new_tokens speculative tokens at `serve_speculative_token_s`, each
    step one page of write-back plus its compute."""
    if page_size < 1 or prefill_chunk < 1:
        raise ValueError(
            "serve_speculative_request_s prices paged+chunked serving: "
            f"page_size ({page_size}) and prefill_chunk "
            f"({prefill_chunk}) must be >= 1")
    if speculative_k < 1:
        raise ValueError(
            "serve_speculative_request_s prices k >= 1 "
            "(serve_paged_request_s is the k=0 form)")
    bw_ici, a_ici, _, _ = _resolve_constants(constants)
    cc = _resolve_compute_constants(compute_constants)
    total_tokens = prompt_tokens + new_tokens
    chunks = -(-prompt_tokens // prefill_chunk)
    prefill = chunks * a_ici + chunks * prefill_chunk * token_bytes / bw_ici
    allocations = -(-total_tokens // page_size) * a_ici
    step_comm = a_ici + page_size * token_bytes / bw_ici
    token_s = serve_speculative_token_s(
        step_comm + decode_compute_s, step_comm + verify_compute_s,
        speculative_k, constants=compute_constants)
    return ((1.0 + cc["spec_draft_cost_ratio"]) * prefill + allocations
            + new_tokens * token_s)


# ----------------------------------------------------------- the walker


@dataclasses.dataclass
class CostBreakdown:
    """One combo's prediction: the alpha / beta split and per-fabric
    totals. `total_s` is the predicted comm time a step, the ledger's
    gated number."""

    alpha_s: float = 0.0
    beta_s: float = 0.0
    n_collectives: int = 0
    bytes_by_fabric: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds_by_fabric: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def total_s(self) -> float:
        return self.alpha_s + self.beta_s

    def as_row(self) -> dict:
        """The ledger row (rounded, so regenerated ledgers diff
        cleanly)."""
        return {
            "predicted_step_s": round(self.total_s, 9),
            "alpha_s": round(self.alpha_s, 9),
            "beta_s": round(self.beta_s, 9),
            "n_collectives": self.n_collectives,
            "bytes_by_fabric": {k: int(v) for k, v in
                                sorted(self.bytes_by_fabric.items())},
            "seconds_by_fabric": {k: round(v, 9) for k, v in
                                  sorted(self.seconds_by_fabric.items())},
        }


def _collective_cost(kind: str, nbytes: int, group: int,
                     fabric: Fabric) -> tuple:
    """(alpha_s, beta_s, wire bytes) of ONE recorded call under the ring
    model on its fabric (module docstring)."""
    if kind == "send":
        return fabric.alpha_s, nbytes / fabric.bw_bytes_per_s, nbytes
    if kind == "recv" or group <= 1:
        return 0.0, 0.0, 0
    if kind == "all_reduce":
        return (2 * (group - 1) * fabric.alpha_s,
                2 * (group - 1) / group * nbytes / fabric.bw_bytes_per_s,
                nbytes)
    if kind == "all_gather":
        nbytes = group * nbytes  # the record holds this rank's shard
    return ((group - 1) * fabric.alpha_s,
            (group - 1) / group * nbytes / fabric.bw_bytes_per_s, nbytes)


def predict_collectives(collectives: Sequence, mesh,
                        dcn_axis: Optional[str] = None,
                        fabrics: Optional["tuple[Fabric, Fabric]"] = None
                        ) -> CostBreakdown:
    """Price every classified record (`analysis/collectives.
    ClassifiedCollective`) and sum. A collective whose membership crosses
    `dcn_axis` is priced on DCN; everything else rides ICI. Unknown
    membership (axes None) is priced as crossing every non-trivial axis.
    A receive is free and not counted (its sender pays). `fabrics` is an
    explicit (ici, dcn) pair; None keeps this module's constants."""
    ici_fabric, dcn_fabric = fabrics if fabrics is not None else (ICI, DCN)
    nontrivial = frozenset(a for a, s in zip(mesh.axis_names, mesh.shape)
                           if s > 1)
    out = CostBreakdown()
    for c in collectives:
        if c.kind == "recv":
            continue
        axes = c.axes if c.axes is not None else nontrivial
        if not axes:
            continue  # one rank's membership: free
        fabric = (dcn_fabric if (dcn_axis is not None and dcn_axis in axes)
                  else ici_fabric)
        group = math.prod(mesh.size(a) for a in axes)
        alpha, beta, nbytes = _collective_cost(c.kind, c.payload_bytes,
                                               group, fabric)
        out.alpha_s += alpha
        out.beta_s += beta
        out.n_collectives += 1
        out.bytes_by_fabric[fabric.name] = (
            out.bytes_by_fabric.get(fabric.name, 0) + nbytes)
        out.seconds_by_fabric[fabric.name] = (
            out.seconds_by_fabric.get(fabric.name, 0.0) + alpha + beta)
    return out


def price_recorded(combo, target, rec, mesh,
                   constants: Optional[Dict[str, float]] = None) -> dict:
    """The ledger row of one recorded step (`analysis/lint.record_combo`'s
    (target, recording, mesh model)): the walker over its records, with
    the serve and plan combos' compute terms folded in. `constants`
    prices under another fabric set; as in the reference, the serve
    compute term stays under this module's compute set and the plan term
    takes `constants` (so a plan combo's set must carry the compute keys
    too)."""
    from distributed_model_parallel_tpu_torch.analysis.collectives import (
        classify,
    )

    breakdown = predict_collectives(
        classify(rec.records, mesh), mesh, target.dcn_axis,
        fabrics=(fabrics_from_constants(constants)
                 if constants is not None else None))
    row = breakdown.as_row()
    if combo.engine == "serve":
        row = add_serve_compute(row, combo)
    elif combo.engine == "plan":
        row = add_plan_compute(row, combo, constants)
    return row


def combo_cost(combo, device: str = "cuda", constants=None) -> dict:
    """Record ONE lint-matrix combo as rank 0 of its world (the linter's
    builders: the same model, mesh and step the rules judge) and return
    its ledger row. Needs a process without a process group."""
    from distributed_model_parallel_tpu_torch.analysis.lint import (
        record_combo,
    )

    target, rec, mesh = record_combo(combo, device)
    return price_recorded(combo, target, rec, mesh, constants)


def plan_combo_compute_s(combo,
                         constants: Optional[Dict[str, float]] = None
                         ) -> float:
    """The ideal (bubble-free) per-device compute of one lint plan combo:
    `lint._build_plan`'s proxy GPT (its stack widened to a pp*V
    multiple) fed ids of shape (4 * dp * pp, 16), its parameters counted
    from the port's own model (small enough to build)."""
    from distributed_model_parallel_tpu_torch.analysis.lint import _gpt_cfg
    from distributed_model_parallel_tpu_torch.models.gpt import init_params
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )
    from distributed_model_parallel_tpu_torch.tuning.space import (
        plan_spec_axes,
    )

    ax = plan_spec_axes(combo.plan)
    chunks = ax["pp"] * ax["virtual"]
    cfg = _gpt_cfg()
    if cfg.num_layers % chunks:
        cfg = dataclasses.replace(cfg, num_layers=chunks)
    tokens = 4 * ax["dp"] * ax["pp"] * cfg.max_position
    shards = ax["pp"] * ax["sp"] * ax["dp"]
    n_params = sum(t.numel() for t in tree_leaves(init_params(cfg)))
    return plan_step_compute_s(n_params, tokens, shards,
                               constants=constants)


def add_plan_compute(row: dict, combo,
                     constants: Optional[Dict[str, float]] = None) -> dict:
    """Fold the train-compute roofline, stretched by the schedule's
    bubble factor, into one plan ledger row (the term the schedule knob
    moves)."""
    from distributed_model_parallel_tpu_torch.tuning.space import (
        plan_spec_axes,
    )

    compute_s = plan_combo_compute_s(combo, constants)
    ax = plan_spec_axes(combo.plan)
    bubble = plan_bubble_factor(ax["pp"], ax["schedule"], ax["virtual"],
                                getattr(combo, "num_microbatches", 0))
    row = dict(row)
    row["train_compute_s"] = round(compute_s, 12)
    row["bubble_factor"] = round(bubble, 9)
    row["predicted_step_s"] = round(row["predicted_step_s"]
                                    + compute_s * bubble, 9)
    return row


def add_serve_compute(row: dict, combo,
                      constants: Optional[Dict[str, float]] = None) -> dict:
    """Fold the decode-compute roofline into one serve ledger row. A
    speculative combo's recorded step is the verify step, and its gated
    number becomes the per-accepted-token cost of one round, comparable
    with a plain combo's per-step (= per-token) number."""
    compute_s = serve_combo_compute_s(combo, constants)
    row = dict(row)
    row["compute_dtype"] = combo.compute_dtype or "f32"
    row["decode_compute_s"] = round(compute_s, 12)
    k = getattr(combo, "speculative_k", 0)
    if not k:
        row["predicted_step_s"] = round(row["predicted_step_s"] + compute_s,
                                        9)
        return row
    comm_s = row["predicted_step_s"]  # the verify step's recorded comm
    verify_s = serve_verify_compute_s(
        layers=2, dim=16, ffn_dim=32, n_slots=2 * combo.size,
        speculative_k=k, mode=combo.compute_dtype or "f32",
        shards=combo.size, constants=constants)
    cc = _resolve_compute_constants(constants)
    row["verify_compute_s"] = round(verify_s, 12)
    row["speculative"] = {
        "k": k,
        "accept_rate": cc["spec_model_accept_rate"],
        "draft_cost_ratio": cc["spec_draft_cost_ratio"],
        "expected_tokens_per_round": round(speculative_expected_tokens(
            cc["spec_model_accept_rate"], k), 6),
        "verify_step_s": round(comm_s + verify_s, 9),
    }
    row["predicted_step_s"] = round(serve_speculative_token_s(
        comm_s + compute_s, comm_s + verify_s, k, constants=constants), 9)
    return row


__all__ = [
    "ALPHA_DCN_HOP_S", "ALPHA_HOP_S", "BW_DCN_EFFECTIVE", "BW_HBM_EFFECTIVE",
    "BW_ICI_EFFECTIVE", "COMPUTE_CONSTANTS", "COMPUTE_ITEMSIZE", "CONSTANTS",
    "CostBreakdown", "DCN", "DRAFT_COST_RATIO", "Fabric", "ICI", "MXU_RATE",
    "SPEC_MODEL_ACCEPT", "WIRE_ITEMSIZE", "add_plan_compute",
    "add_serve_compute", "combo_cost", "composed_plan_step_s",
    "fabrics_from_constants", "flat_all_to_all_s",
    "hierarchical_all_to_all_s", "load_calibration", "plan_bubble_factor",
    "plan_combo_compute_s", "plan_step_compute_s", "predict_collectives",
    "price_recorded", "quant_matmul_s", "ring_all_reduce_s",
    "serve_combo_compute_s", "serve_decode_compute_s",
    "serve_paged_request_s", "serve_speculative_request_s",
    "serve_speculative_token_s", "serve_verify_compute_s",
    "speculative_expected_tokens", "two_level_all_reduce_s",
]
