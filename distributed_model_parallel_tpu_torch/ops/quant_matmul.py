"""Quantized decode projections (port of `ops/quant_matmul.py`).

Scale layout, the reference's int8 contract, unchanged:

* weights — per-OUTPUT-CHANNEL absmax: `w (K, N)` quantizes against
  `wscale (N,) = max(|w|, axis=0) / 127`, floored at `ABSMAX_FLOOR`.
  Static per weight, so the serving engine quantizes each weight once
  when parameters are placed (`QuantMatmul.prepare`) instead of on
  every call; a call with an unprepared weight quantizes it then.
* activations — per-TOKEN dynamic absmax: `x (M, K)` quantizes against
  `xscale (M, 1) = max(|x|, axis=-1) / 127`, recomputed every call.
* accumulate in int32, dequantize on exit: `y = acc * xscale * wscale`
  in f32, left to right as the reference kernel does.

  mode | CUDA tensor                          | CPU tensor
  -----|--------------------------------------|-----------------------
  int8 | `csrc/int8_matmul.cu` (quantize rows | `int8_matmul_plain`:
       | + __dp4a int32 dot + dequantize, one | the same arithmetic in
       | launch)                              | torch
  f32  | `x @ w`                              | the same
  bf16 | `torch.matmul` on bf16 operands (the | the same
       | reference computes bf16 as a plain   |
       | XLA dot, outside any kernel)         |

The kernel keeps the quantized weight transposed, `wq_t (N, K)`, so
each output column's K axis is contiguous; `prepare_weight` produces it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# The wire codec's denormal guard, copied from the reference's
# `ops/wire_codec.py` (127 * smallest normal f32): a floored scale stays
# normal, so an all-zero row or column decodes to exact zeros. Stored as
# the f32 value every implementation compares against.
ABSMAX_FLOOR = float(np.float32(127 * 1.1754944e-38))

# The engine/CLI surface (`compute_dtype` / `--compute-dtype`).
COMPUTE_DTYPES = ("f32", "bf16", "int8")

_SOURCE = "int8_matmul.cu"


def check_compute_dtype(name: str) -> str:
    if name not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
            f"{name!r}"
        )
    return name


def normalize_compute_dtype(value) -> str:
    """Engine-surface normalization: None (= f32), one of
    COMPUTE_DTYPES, or a dtype object (`torch.bfloat16` -> "bf16",
    `torch.float32` -> "f32"), as the reference accepts its dtypes."""
    if value is None:
        return "f32"
    if isinstance(value, str):
        return check_compute_dtype(value)
    if value == torch.bfloat16:
        return "bf16"
    if value == torch.float32:
        return "f32"
    raise ValueError(
        f"compute_dtype must be one of {COMPUTE_DTYPES} or a dtype "
        f"(torch.bfloat16 / torch.float32), got {value!r}"
    )


# ------------------------------------------------------------ quantize


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division, like the reference and the kernel.
    On CUDA, torch divides by a Python scalar as a multiplication by its
    reciprocal, which rounds differently for some t; dividing by a
    tensor of 127s keeps the true quotient on every device."""
    return t / torch.full_like(t, 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (wq int8 (K, N), wscale f32 (N,)): per-output-channel
    absmax scales, floored so an all-zero column decodes to zeros."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = _div127(torch.clamp_min(absmax, ABSMAX_FLOOR))
    q = torch.clamp(torch.round(wf / scale[None, :]), -127.0, 127.0)
    return q.to(torch.int8), scale


def quantize_rows(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (q int8 (M, K), xscale f32 (M, 1)): per-token dynamic
    absmax scales. `torch.round` rounds half to even, like `jnp.round`.
    `absmax` (M,) replaces each row's own absmax (a tensor-parallel slice
    of a row quantizes with the whole row's, `row_absmax`)."""
    xf = x.float()
    absmax = (xf.abs().amax(dim=-1, keepdim=True) if absmax is None
              else absmax.float().reshape(-1, 1))
    scale = _div127(torch.clamp_min(absmax, ABSMAX_FLOOR))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def prepare_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (wq_t int8 (N, K) contiguous, wscale f32 (N,)): the
    kernel's operand layout of `quantize_weight`."""
    wq, wscale = quantize_weight(w)
    return wq.t().contiguous(), wscale.contiguous()


# ------------------------------------------------------- the int8 GEMM


def int8_matmul_plain(
    x: torch.Tensor, wq_t: torch.Tensor, wscale: torch.Tensor,
    absmax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain torch, same arithmetic: quantize
    the rows (against `absmax` when given), exact integer dot,
    `float(acc) * xscale * wscale`.

    The integer dot runs as a float64 matmul of the int8 values, which
    is exact here (every partial sum is an integer below 2**53) and
    works on CUDA, where torch has no integer matmul."""
    q, xscale = quantize_rows(x, absmax)
    acc = (q.double() @ wq_t.double().t()).to(torch.int32)
    return acc.float() * xscale * wscale[None, :]


def row_absmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """(M,) f32 absmax of each row of x (M, K), taken over the rows'
    slices on every rank of `group` (an all-reduce MAX, exact): the
    reference's partitioned int8 projection quantizes a row sharded over
    the model axis with the whole row's absmax."""
    amax = x.float().abs().amax(dim=-1).contiguous()
    if group is not None and torch.distributed.get_world_size(group) > 1:
        torch.distributed.all_reduce(
            amax, op=torch.distributed.ReduceOp.MAX, group=group)
    return amax


def _check_operands(x, wq_t, wscale, absmax=None) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "int8_matmul: x must be a contiguous 2-D float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype}"
            + ("" if x.is_contiguous() else " (non-contiguous)")
        )
    if wq_t.dim() != 2 or wq_t.dtype != torch.int8 \
            or not wq_t.is_contiguous():
        raise ValueError(
            "int8_matmul: wq_t must be a contiguous 2-D int8 tensor "
            f"(N, K), got {tuple(wq_t.shape)} {wq_t.dtype}"
        )
    if wscale.dim() != 1 or wscale.dtype != torch.float32 \
            or not wscale.is_contiguous():
        raise ValueError(
            "int8_matmul: wscale must be a contiguous 1-D float32 "
            f"tensor (N,), got {tuple(wscale.shape)} {wscale.dtype}"
        )
    if wq_t.data_ptr() % 4:
        raise ValueError(
            "int8_matmul: wq_t must start on a 4-byte boundary (the kernel "
            "reads it as 4-byte words); got a view at an odd offset"
        )
    (m, k), (n, k2) = x.shape, wq_t.shape
    if k != k2 or wscale.shape[0] != n:
        raise ValueError(
            f"int8_matmul: shapes disagree: x {tuple(x.shape)}, wq_t "
            f"{tuple(wq_t.shape)} (N, K), wscale {tuple(wscale.shape)}"
        )
    if absmax is not None and (
            absmax.shape != (m,) or absmax.dtype != torch.float32
            or not absmax.is_contiguous() or absmax.device != x.device):
        raise ValueError(
            f"int8_matmul: absmax must be a contiguous float32 (M,) = ({m},) "
            f"tensor on {x.device}, got {tuple(absmax.shape)} "
            f"{absmax.dtype} on {absmax.device}")
    if not (x.device == wq_t.device == wscale.device):
        raise ValueError(
            f"int8_matmul: operands on different devices: {x.device}, "
            f"{wq_t.device}, {wscale.device}"
        )


def _library() -> ctypes.CDLL:
    from distributed_model_parallel_tpu_torch.ops import _cuda

    lib = _cuda.load(_SOURCE)
    if not getattr(lib, "_dmp_bound", False):
        lib.dmp_int8_matmul.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.dmp_int8_matmul.restype = ctypes.c_int
        lib.dmp_int8_matmul_max_k.argtypes = []
        lib.dmp_int8_matmul_max_k.restype = ctypes.c_int
        lib._dmp_bound = True
    return lib


def int8_matmul(
    x: torch.Tensor,
    wq_t: torch.Tensor,
    wscale: torch.Tensor,
    *,
    absmax: Optional[torch.Tensor] = None,
    return_codes: bool = False,
):
    """x (M, K) f32 @ prepared weight (wq_t (N, K) int8, wscale (N,) f32)
    -> (M, N) f32, in the int8 contract's arithmetic; `absmax` (M,) f32,
    when given, is what each row's scale is computed from in place of the
    row's own absmax (`row_absmax`).

    On CPU tensors this is `int8_matmul_plain`. On CUDA tensors it
    launches `csrc/int8_matmul.cu` on the current stream (and raises if
    the launch fails) — there is no fallback. `int8_matmul.launches`
    counts kernel launches. `return_codes=True` also returns the
    activation codes (M, K) int8 and scales (M, 1) f32 the kernel (or
    the plain version) computed, for checking them."""
    _check_operands(x, wq_t, wscale, absmax)
    if x.device.type == "cpu":
        y = int8_matmul_plain(x, wq_t, wscale, absmax)
        return (y, *quantize_rows(x, absmax)) if return_codes else y
    if x.device.type != "cuda":
        raise ValueError(
            f"int8_matmul: no kernel for device {x.device} (cuda or cpu)"
        )
    m, k = x.shape
    n = wq_t.shape[0]
    lib = _library()
    if m == 0 or n == 0 or k == 0 or k % 4 or k > lib.dmp_int8_matmul_max_k() \
            or -(-m // 8) > 65535:
        raise ValueError(
            f"int8_matmul kernel takes M in [1, 524280], N >= 1 and K a "
            f"positive multiple of 4 up to {lib.dmp_int8_matmul_max_k()}; "
            f"got M={m} N={n} K={k}"
        )
    with torch.cuda.device(x.device):
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        codes = scales = None
        if return_codes:
            codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
            scales = torch.empty((m, 1), dtype=torch.float32,
                                 device=x.device)
        rc = lib.dmp_int8_matmul(
            x.data_ptr(), wq_t.data_ptr(), wscale.data_ptr(),
            out.data_ptr(),
            codes.data_ptr() if codes is not None else None,
            scales.data_ptr() if scales is not None else None,
            absmax.data_ptr() if absmax is not None else None,
            m, n, k, ABSMAX_FLOOR,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"int8_matmul kernel launch failed: cudaError {rc} "
            f"(M={m} N={n} K={k})"
        )
    int8_matmul.launches += 1
    return (out, codes, scales) if return_codes else out


int8_matmul.launches = 0


# --------------------------------------------------------------- public


def quant_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    mode: str = "int8",
    *,
    prepared: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    absmax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (..., K) @ w (K, N) in `mode` arithmetic.

    "f32" is the identity dot; "bf16" casts both operands and returns
    bf16 (downstream layers follow x.dtype); "int8" quantizes per the
    module contract and returns f32. `prepared` is `prepare_weight(w)`
    (or its slice of a whole weight's) when the caller cached it;
    `absmax` (one per row of x) replaces the rows' own absmax."""
    check_compute_dtype(mode)
    if mode == "f32":
        return x @ w
    if mode == "bf16":
        return x.to(torch.bfloat16) @ w.to(torch.bfloat16)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float().contiguous()
    wq_t, wscale = prepared if prepared is not None else prepare_weight(w)
    y = int8_matmul(x2, wq_t, wscale, absmax=absmax)
    return y.reshape(*lead, w.shape[-1])


def quant_dot(mode: Optional[str], prepared=None) -> Optional[Callable]:
    """The chunk GEMM to inject into a collective-matmul ring's fold
    (`ops/collective_matmul.py`): None for f32 (the fold keeps its plain
    `chunk @ w`), else a 2-argument dot in `mode` arithmetic; under int8
    `prepared` is the weight's kernel operands, made once."""
    if mode is None or mode == "f32":
        return None
    check_compute_dtype(mode)
    return lambda a, b: quant_matmul(a, b, mode, prepared=prepared)


class PreparedWeights:
    """int8 kernel operands made once per weight tensor and kept for its
    lifetime (keyed on the tensor's identity, checked through a weak
    reference so a recycled id never hits a stale entry)."""

    def __init__(self):
        self._prepared: Dict[int, tuple] = {}

    def put(self, w: torch.Tensor, operands=None) -> None:
        """Keep `operands` (default `prepare_weight(w)`) for `w`."""
        self._prepared[id(w)] = (weakref.ref(w),
                                 operands or prepare_weight(w))

    def get(self, w: torch.Tensor):
        entry = self._prepared.get(id(w))
        if entry is not None and entry[0]() is w:
            return entry[1]
        return None


@dataclasses.dataclass
class QuantMatmul:
    """`Context.matmul` policy for NON-ring quantized decode (replicated
    and tp without rings): every projection runs through `quant_matmul`.

    Under a tensor-parallel model group (`group`) each rank holds the
    Megatron shards, and the arithmetic is the reference's, whose
    partitioner keeps the unsharded semantics: a column projection (qkv,
    ffn-in) sees whole rows and a column shard of the weight, whose
    per-column scales are the whole weight's, so it runs locally; a row
    projection (attn-out, ffn-out) sees a slice of each row and a row
    shard of the weight, so each row quantizes with the WHOLE row's
    absmax (`row_absmax`, an all-reduce MAX), the weight's codes and
    scales are the whole weight's, sliced (`prepare(w, operands=...)`,
    made in `ServingEngine.place_params`), and the dequantized f32
    partial products are all-reduced (SUM) before the bias is added
    once.

    `prepare(w)` quantizes a weight once (per shard where its scales are
    local)."""

    mode: str = "int8"
    group: Any = None
    _weights: PreparedWeights = dataclasses.field(
        default_factory=PreparedWeights, repr=False, compare=False
    )

    def prepare(self, w: torch.Tensor, operands=None) -> None:
        if self.mode == "int8":
            self._weights.put(w, operands)

    def _lookup(self, w: torch.Tensor):
        return self._weights.get(w)

    def column(self, h, w, b):
        y = quant_matmul(h, w, self.mode, prepared=self._lookup(w))
        return y + b.to(y.dtype)

    def row(self, h, w, b):
        group = self.group
        sharded = (group is not None
                   and torch.distributed.get_world_size(group) > 1)
        absmax = (row_absmax(h.reshape(-1, h.shape[-1]), group)
                  if sharded and self.mode == "int8" else None)
        y = quant_matmul(h, w, self.mode, prepared=self._lookup(w),
                         absmax=absmax)
        if sharded:
            y = y.contiguous()
            torch.distributed.all_reduce(y, group=group)
        return y + b.to(y.dtype)


__all__ = [
    "ABSMAX_FLOOR",
    "COMPUTE_DTYPES",
    "PreparedWeights",
    "QuantMatmul",
    "check_compute_dtype",
    "int8_matmul",
    "int8_matmul_plain",
    "normalize_compute_dtype",
    "prepare_weight",
    "quant_dot",
    "quant_matmul",
    "quantize_rows",
    "quantize_weight",
    "row_absmax",
]
