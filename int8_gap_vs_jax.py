#!/usr/bin/env python3
"""The int8 decode gap at GPT-2-small width: the port against the JAX
reference, on the CPU.

Both packages' `ServingEngine`s (replicated layout, 8 slots, prefill
128, cache 1024) run the first decode step of `GPTConfig()`'s widths
(vocab 50257, dim 768, 12 layers, 12 heads, ffn 3072) in f32 and in
int8, on the same weights (the port's `init_params(seed 0)` drawn on
the CPU, carried to the JAX tree by `models/convert.to_jax_params`),
the same eight prompts (the serve CLI's synthetic trace at seed 0,
16-128 tokens) and the same fed tokens (the f32 prefill's argmax). On
the CPU the port runs its kernels' plain versions and the JAX int8
GEMM its XLA path (`ops/quant_matmul._int8_matmul_xla`).

Printed, one JSON object: the int8-vs-f32 gap (max|int8 - f32| /
max|f32|) of each package, and its excess over the reference's
elementwise decode-logit check (tests/test_serving.py, rtol 5e-2 /
atol 1e-2); the port against JAX in each mode; how many int8
activation codes of the 48 decode GEMMs differ between the packages;
and how many weight and activation codes the JAX engine's compiled
decode step computes otherwise than its own `quantize_weight` /
`quantize_rows` run op by op (IEEE division, what the port computes).

    python3 int8_gap_vs_jax.py          # about 30 s on the CPU, ~6 GB of RAM

It imports both packages, as the parity tests do; the port itself
never imports JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_model_parallel_tpu.models.gpt import (  # noqa: E402
    GPTConfig as JaxGPTConfig,
)
from distributed_model_parallel_tpu.ops import (  # noqa: E402
    quant_matmul as jqm,
)
from distributed_model_parallel_tpu.serving.engine import (  # noqa: E402
    ServingEngine as JaxEngine,
)
from distributed_model_parallel_tpu_torch.cli import serve  # noqa: E402
from distributed_model_parallel_tpu_torch.models.convert import (  # noqa: E402
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    init_params,
)
from distributed_model_parallel_tpu_torch.ops import (  # noqa: E402
    quant_matmul as tqm,
)
from distributed_model_parallel_tpu_torch.serving.engine import (  # noqa: E402
    ServingEngine,
)

SLOTS = 8
WIDTHS = dict(vocab_size=50257, dim=768, num_layers=12, num_heads=12,
              ffn_dim=3072, max_position=1024, dropout_rate=0.0,
              pad_token_id=0)
ENGINE_KW = dict(num_slots=SLOTS, max_len=1024, prefill_len=128)
SERVE_FLAGS = ["--vocab-size", "50257", "--num-requests", "16",
               "--prompt-len-min", "16", "--prompt-len-max", "128",
               "--seed", "0"]


def port_first_step(mode, host, prompts, tokens, inputs=None):
    eng = ServingEngine(GPTConfig(**WIDTHS), compute_dtype=mode,
                        device="cpu", **ENGINE_KW)
    p = eng.place_params(host)
    cache = eng.init_cache()
    pre = []
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, row = eng.prefill(p, cache, ids, length, slot)
        pre.append(row)
    calls = {name: getattr(tqm.QuantMatmul, name) for name in ("column",
                                                               "row")}

    def recording(call):
        def recorded(self, h, w, b):
            inputs.append(h.detach().reshape(-1, h.shape[-1]).numpy().copy())
            return call(self, h, w, b)
        return recorded

    if inputs is not None:
        for name, call in calls.items():
            setattr(tqm.QuantMatmul, name, recording(call))
    try:
        logits = eng.decode_step(p, cache, torch.as_tensor(tokens),
                                 torch.ones(SLOTS, dtype=torch.bool))[1]
    finally:
        for name, call in calls.items():
            setattr(tqm.QuantMatmul, name, call)
    return torch.stack(pre).numpy(), logits.numpy()


def jax_first_step(mode, jparams, prompts, tokens, inputs=None):
    eng = JaxEngine(JaxGPTConfig(**WIDTHS), compute_dtype=mode, **ENGINE_KW)
    p = eng.place_params(jparams)
    cache = eng.init_cache()
    pre = []
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, row = eng.prefill(p, cache, ids, length, jnp.int32(slot))
        pre.append(np.asarray(row))
    saved = {name: getattr(jqm, name)
             for name in ("quantize_rows", "quantize_weight")}

    def recording(name):
        def recorded(x):
            q, scale = saved[name](x)
            # Traced once: jax.debug.callback hands each decode GEMM's
            # operand and the codes the compiled step made from it to the
            # host, in program order.
            jax.debug.callback(
                lambda v, c: inputs[name].append((np.asarray(v),
                                                  np.asarray(c))),
                x, q, ordered=True)
            return q, scale
        return recorded

    if inputs is not None:
        for name in saved:
            setattr(jqm, name, recording(name))
    try:
        _, logits = eng.decode_step(p, cache, jnp.asarray(tokens),
                                    jnp.ones((SLOTS,), bool))
        logits = np.asarray(logits)
    finally:
        for name, fn in saved.items():
            setattr(jqm, name, fn)
    return np.stack(pre), logits


def compiled_vs_exact(recorded, quantize) -> dict:
    """Codes the compiled step made against `quantize` run op by op on
    the same operands: how many differ, in how many GEMMs."""
    diffs = [int((c != np.asarray(quantize(jnp.asarray(v))[0])).sum())
             for v, c in recorded]
    return {"gemms": len(diffs), "codes": int(sum(c.size for _, c in
                                                  recorded)),
            "differ": sum(diffs), "gemms_with_differences":
                sum(bool(d) for d in diffs)}


def gap(got, ref) -> dict:
    diff = np.abs(got.astype(np.float64) - ref)
    excess = float((diff - (1e-2 + 5e-2 * np.abs(ref))).max())
    return {"rel": float(diff.max() / np.abs(ref).max()),
            "max_abs": float(diff.max()),
            "reference_allclose_excess": excess}


def main() -> int:
    t0 = time.perf_counter()
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    prompts = [r.prompt for r in serve.synthetic_trace(args)[:SLOTS]]
    host = init_params(GPTConfig(**WIDTHS), 0, device="cpu")
    jparams = jax.tree.map(jnp.asarray, to_jax_params(host))

    t_pre_f32, _ = port_first_step("f32", host, prompts,
                                   np.zeros(SLOTS, np.int64))
    tokens = t_pre_f32.argmax(-1)
    _, t_f32 = port_first_step("f32", host, prompts, tokens)
    t_in, j_rec = [], {"quantize_rows": [], "quantize_weight": []}
    _, t_i8 = port_first_step("int8", host, prompts, tokens, t_in)
    j_pre_f32, j_f32 = jax_first_step("f32", jparams, prompts, tokens)
    _, j_i8 = jax_first_step("int8", jparams, prompts, tokens, j_rec)
    j_in = [v.reshape(-1, v.shape[-1]) for v, _ in j_rec["quantize_rows"]]

    def codes(x):
        return jqm.quantize_rows(jnp.asarray(x))[0]

    flips = []
    for xt, xj in zip(t_in, j_in):
        dq = np.abs(np.asarray(codes(xt), np.int32)
                    - np.asarray(codes(xj), np.int32))
        flips.append({"x_rel_diff": float(np.abs(xt - xj).max()
                                          / np.abs(xj).max()),
                      "flipped_codes": int((dq > 0).sum()),
                      "max_code_diff": int(dq.max())})
    out = {
        "config": "GPTConfig() widths, 12 layers, 8 slots, prefill 128, "
                  "seed-0 port weights drawn on the CPU",
        "port_int8_vs_f32": gap(t_i8, t_f32),
        "jax_int8_vs_f32": gap(j_i8, j_f32),
        "port_vs_jax_f32_prefill_max_abs": float(
            np.abs(t_pre_f32 - j_pre_f32).max()),
        "port_vs_jax_f32_decode_max_abs": float(np.abs(t_f32 - j_f32).max()),
        "port_vs_jax_int8_decode": gap(t_i8, j_i8),
        "greedy_tokens_int8_vs_f32_differ": {
            "port": int((t_i8.argmax(-1) != t_f32.argmax(-1)).sum()),
            "jax": int((j_i8.argmax(-1) != j_f32.argmax(-1)).sum())},
        "int8_gemms_recorded": {"port": len(t_in), "jax": len(j_in)},
        "int8_codes_port_vs_jax": {
            "codes": int(sum(x.size for x in t_in)),
            "flipped": sum(f["flipped_codes"] for f in flips),
            "gemms_with_flips": sum(bool(f["flipped_codes"]) for f in flips),
            "first_flipped": next((dict(f, call=i)
                                   for i, f in enumerate(flips)
                                   if f["flipped_codes"]), None)},
        "jax_compiled_step_vs_op_by_op_codes": {
            "weights": compiled_vs_exact(j_rec["quantize_weight"],
                                         jqm.quantize_weight),
            "activations": compiled_vs_exact(
                [(v.reshape(-1, v.shape[-1]), c.reshape(-1, c.shape[-1]))
                 for v, c in j_rec["quantize_rows"]], jqm.quantize_rows)},
        "port_weight_codes_vs_jax_op_by_op_differ": sum(
            int((tqm.prepare_weight(torch.from_numpy(v))[0].t().numpy()
                 != np.asarray(jqm.quantize_weight(jnp.asarray(v))[0])
                 ).sum()) for v, _ in j_rec["quantize_weight"]),
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
