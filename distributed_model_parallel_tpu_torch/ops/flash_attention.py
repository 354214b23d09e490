"""Flash attention, forward and backward (port of
`ops/pallas_attention.py`).

Three kernels in `csrc/flash_attention.cu`, each with a plain torch twin
of the same function here:

  kernel wrapper   | replaces (JAX package)               | plain version
  -----------------|--------------------------------------|-----------------------
  `flash_fwd`      | `_fwd_kernel`/`_flash_step` (K1)     | `flash_fwd_plain`
  `flash_bwd_dq`   | `_bwd_dq_step` (K2)                  | `flash_bwd_dq_plain`
  `flash_bwd_dkv`  | `_bwd_dkv_step` (K3)                 | `flash_bwd_dkv_plain`

A wrapper given CPU tensors computes its plain version; given CUDA
tensors it launches its kernel (and raises if the launch fails): there
is no fallback. Each counts its kernel launches in `<wrapper>.launches`.
All three copy operand rows in 16-byte chunks and refuse an operand
whose address or strides are not 16-byte aligned (`_check_aligned`);
the views of a fused qkv projection split at head boundaries are.

Contract, the reference's: (B, T, H, Dh) tensors of f32 or bf16, an
optional (B, Tkv) key-validity mask, `causal=True` for decoders; logits
`scale * q @ k^T` in f32, masked logits at finfo(f32).min (never -inf),
p rounded to v's dtype before P @ V, out in q's dtype. A row with no
valid key gets out 0 and LSE +inf, so its gradients are 0. The LSE is
(B, H, Tq) f32. delta = rowsum(dO * O) is plain torch (`flash_delta`),
outside the kernels, as the reference computes it outside Pallas.

`flash_attention` is the `attention_fn`: it sends a pair of lengths to
the kernels exactly when the reference's `_blocks_viable` does (both
multiples of 8) and runs the dense `dot_product_attention`, forward and
backward, otherwise. The two disagree on a fully masked row: the dense
path gives the mean of V there, the kernels 0 — as in the reference.
`flash_forward_lse` / `flash_backward` (external LSE) are the entry
points the sequence-parallel ring builds on.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)

_NEG = torch.finfo(torch.float32).min
_SOURCE = "flash_attention.cu"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)
# The tiles built per kernel and head dim. K1 and K2 take (rows, keys):
# a block of rows/16 warps owns `rows` query rows and loops over key
# tiles of `keys` keys; each pair is built for both kernels and both
# dtypes (csrc/flash_attention.cu's DMP_QCASE list). Dh 64 (GPT-2 small)
# has the sweep's tiles: rows {64, 128} x keys {32, 64, 128} less (128,
# 128), where the f32 K1 needs 242 KB of shared memory (227 KB is the
# limit). K3 takes (keys, rows): a block of keys/16 warps owns `keys`
# keys and streams q / dO tiles of `rows` rows (DMP_KCASE); Dh 64 has
# the sweep's keys {64, 128} x rows {32, 64}, Dh 128 only (64, 32)
# (the f32 kernel needs 237 KB of shared memory at (64, 64)).
_ROW_TILES = {16: ((64, 64),), 32: ((64, 64),),
              64: ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64)),
              128: ((64, 32), (64, 64))}
TILES = {
    "flash_fwd": _ROW_TILES,
    "flash_bwd_dq": _ROW_TILES,
    "flash_bwd_dkv": {16: ((64, 64),), 32: ((64, 64),),
                      64: ((64, 32), (64, 64), (128, 32), (128, 64)),
                      128: ((64, 32),)},
}
# Each kernel's tile per dtype and head dim, from chip_smoke.py's sweep
# at Dh 64 on one H100 80GB HBM3, 700 W (B 8, T 1024, H 12, causal;
# device ms a launch; PERF.md), rows x keys = 64x32 / 64x64 / 64x128 /
# 128x32 / 128x64:
#   K1 f32  .572 .584 .794 .586 .607   bf16 .149 .135 .179 .163 .140
#   K2 f32  .739 .913 .905 .822 .728   bf16 .151 .146 .171 .161 .190
# (f32 fits 2 blocks an SM at 64x32 and 8 warps at 128x64; 128 keys
# doubles the ring). K3, keys x rows = 64x32 / 64x64 / 128x32 / 128x64:
#   K3 f32  .832 1.176 .862 .808          bf16 .192 .155 .199 .167
# (f32 64x64 holds one block of 4 warps an SM: 136 KB of shared memory).
_F32, _BF16 = torch.float32, torch.bfloat16
DEFAULT_TILE = {
    "flash_fwd": {
        _F32: {16: (64, 64), 32: (64, 64), 64: (64, 32), 128: (64, 64)},
        _BF16: {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 64)},
    },
    "flash_bwd_dq": {
        _F32: {16: (64, 64), 32: (64, 64), 64: (128, 64), 128: (64, 32)},
        _BF16: {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 32)},
    },
    "flash_bwd_dkv": {
        _F32: {16: (64, 64), 32: (64, 64), 64: (128, 64), 128: (64, 32)},
        _BF16: {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 32)},
    },
}


def kernel_viable(tq: int, tk: int) -> bool:
    """The reference's `_blocks_viable` test: its `_pick_block` finds a
    multiple-of-8 divisor of a length exactly when the length is a
    multiple of 8, for both the query and the key length."""
    return tq % 8 == 0 and tk % 8 == 0 and tq > 0 and tk > 0


# ------------------------------------------------------- plain versions


def _logits(q, k, mask, scale: float, causal: bool) -> torch.Tensor:
    """(B, H, Tq, Tk) f32 logits with the mask and causal predicate at
    finfo.min; bf16 inputs widen to f32 (exact products, f32 sums)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], _NEG)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        tri = (torch.arange(tq, device=q.device)[:, None]
               >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~tri[None, None], _NEG)
    return s


def flash_fwd_plain(q, k, v, mask=None, *, scale: float, causal: bool,
                    need_lse: bool = False):
    """K1's function in dense torch: (out (B, Tq, H, Dh) in q's dtype,
    LSE (B, H, Tq) f32 or None)."""
    s = _logits(q, k, mask, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s == _NEG, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (o / denom.transpose(1, 2)).to(q.dtype)
    if not need_lse:
        return out, None
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(l, math.inf))
    return out, lse[..., 0]


def flash_bwd_dq_plain(q, k, v, g, lse, delta, mask=None, *, scale: float,
                       causal: bool):
    """K2's function in dense torch: dq in q's dtype."""
    s = _logits(q, k, mask, scale, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, mask=None, *,
                        scale: float, causal: bool):
    """K3's function in dense torch: (dk, dv) in k's and v's dtypes."""
    s = _logits(q, k, mask, scale, causal)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def flash_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, Tq) contiguous."""
    d = (g.float() * out.float()).sum(dim=-1)  # (B, Tq, H)
    return d.transpose(1, 2).contiguous()


# -------------------------------------------------------------- kernels


def _library() -> ctypes.CDLL:
    from distributed_model_parallel_tpu_torch.ops import _cuda

    lib = _cuda.load(_SOURCE)
    if not getattr(lib, "_dmp_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B Tq Tk H D, then the tile ((rows, keys) for K1/K2, (keys,
        # rows) for K3), then bf16 scale causal stream
        tail = [i, i, i, i, i, i, i, i, f, i, p]
        lib.dmp_flash_fwd.argtypes = [p] * 7 + tail
        lib.dmp_flash_bwd_dq.argtypes = [p] * 9 + tail
        lib.dmp_flash_bwd_dkv.argtypes = [p] * 10 + tail
        for fn in (lib.dmp_flash_fwd, lib.dmp_flash_bwd_dq,
                   lib.dmp_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib._dmp_bound = True
    return lib


def _check(name: str, q, k, v, g=None, mask=None, stats=()) -> None:
    """What the kernels take: (B, T, H, Dh) operands of one dtype (f32 or
    bf16) on one CUDA device, Dh contiguous; a (B, Tk) bool mask; (B, H,
    Tq) f32 stats."""
    ops = [q, k, v] + ([g] if g is not None else [])
    if any(t.dim() != 4 for t in ops):
        raise ValueError(f"{name}: q/k/v/dO must be (B, T, H, Dh)")
    b, tq, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, dh) \
            or (g is not None and g.shape != q.shape):
        raise ValueError(
            f"{name}: shapes disagree: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}"
            + ("" if g is None else f", dO {tuple(g.shape)}")
        )
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ops):
        raise ValueError(
            f"{name}: q/k/v/dO must share one dtype of {DTYPES}, got "
            f"{[t.dtype for t in ops]}"
        )
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"{name}: the kernels are built for head dims {HEAD_DIMS}, "
            f"got {dh}"
        )
    others = list(ops) + ([mask] if mask is not None else []) + list(stats)
    if any(t.device != q.device for t in others):
        raise ValueError(f"{name}: operands on different devices")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != (b, k.shape[1])):
        raise ValueError(
            f"{name}: mask must be a (B, Tkv) bool key mask, got "
            f"{tuple(mask.shape)} {mask.dtype}"
        )
    for t in stats:
        if t.dtype != torch.float32 or t.shape != (b, h, tq) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: lse/delta must be contiguous (B, H, Tq) f32, got "
                f"{tuple(t.shape)} {t.dtype}"
            )


def _dh_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_aligned(name: str, *ts) -> None:
    """The kernels copy operand rows in 16-byte chunks (cp.async): each
    operand's base address and its batch, sequence and head strides (on
    axes longer than 1) must be multiples of 16 bytes. Views of a fused
    qkv projection split at head boundaries are; anything else is
    refused here rather than copied behind the caller's back (pass
    `.contiguous()` copies)."""
    for t in ts:
        es = t.element_size()
        bad = t.data_ptr() % 16 or any(
            (t.stride(d) * es) % 16 for d in range(3) if t.shape[d] > 1)
        if bad:
            raise ValueError(
                f"{name}: operands must be 16-byte aligned (base address "
                f"and batch/seq/head strides), got address "
                f"{t.data_ptr()} % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())} of {es}-byte elements"
            )


def _strides(*ts) -> ctypes.Array:
    flat = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(flat))(*flat)


def _tile(name: str, dtype, dh: int, tile):
    """`tile`, or the kernel's default for this dtype and head dim,
    checked against what is built: (rows, keys) for K1/K2, (keys, rows)
    for K3."""
    tile = DEFAULT_TILE[name][dtype][dh] if tile is None else tile
    if tile not in TILES[name][dh]:
        raise ValueError(f"{name}: tile {tile} is not built for Dh {dh} "
                         f"({TILES[name][dh]})")
    return tile


def _raise_on(rc: int, name: str, q, k) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {rc} (q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def flash_fwd(q, k, v, mask=None, *, scale: float, causal: bool = False,
              need_lse: bool = False,
              tile: Optional[Tuple[int, int]] = None):
    """K1: (out, LSE (B, H, Tq) f32 or None unless `need_lse`). `tile`
    is (rows, keys); operands must be 16-byte aligned
    (`_check_aligned`)."""
    if not _on_cuda("flash_fwd", q):
        return flash_fwd_plain(q, k, v, mask, scale=scale, causal=causal,
                               need_lse=need_lse)
    _check("flash_fwd", q, k, v, mask=mask)
    q, k, v = (_dh_contiguous(t) for t in (q, k, v))
    _check_aligned("flash_fwd", q, k, v)
    b, tq, h, dh = q.shape
    rows, keys = _tile("flash_fwd", q.dtype, dh, tile)
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
               if need_lse else None)
        mask_c = mask.contiguous() if mask is not None else None
        rc = lib.dmp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
            mask_c.data_ptr() if mask_c is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, tq, k.shape[1], h, dh, rows, keys,
            int(q.dtype == torch.bfloat16),
            scale, int(causal), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "flash_fwd", q, k)
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, g, lse, delta, mask=None, *, scale: float,
                 causal: bool = False,
                 tile: Optional[Tuple[int, int]] = None):
    """K2: dq (B, Tq, H, Dh) in q's dtype, from the saved LSE. `tile` is
    (rows, keys); operands must be 16-byte aligned (`_check_aligned`)."""
    if not _on_cuda("flash_bwd_dq", q):
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, mask,
                                  scale=scale, causal=causal)
    _check("flash_bwd_dq", q, k, v, g, mask, (lse, delta))
    q, k, v, g = (_dh_contiguous(t) for t in (q, k, v, g))
    _check_aligned("flash_bwd_dq", q, k, v, g)
    b, tq, h, dh = q.shape
    rows, keys = _tile("flash_bwd_dq", q.dtype, dh, tile)
    lib = _library()
    with torch.cuda.device(q.device):
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        mask_c = mask.contiguous() if mask is not None else None
        rc = lib.dmp_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            _strides(q, k, v, g),
            mask_c.data_ptr() if mask_c is not None else None,
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, tq, k.shape[1], h, dh, rows, keys,
            int(q.dtype == torch.bfloat16),
            scale, int(causal), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "flash_bwd_dq", q, k)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, mask=None, *, scale: float,
                  causal: bool = False,
                  tile: Optional[Tuple[int, int]] = None):
    """K3: (dk, dv) (B, Tk, H, Dh) in k's and v's dtypes. `tile` is
    (keys, rows); operands must be 16-byte aligned (`_check_aligned`)."""
    if not _on_cuda("flash_bwd_dkv", q):
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, mask,
                                   scale=scale, causal=causal)
    _check("flash_bwd_dkv", q, k, v, g, mask, (lse, delta))
    q, k, v, g = (_dh_contiguous(t) for t in (q, k, v, g))
    _check_aligned("flash_bwd_dkv", q, k, v, g)
    b, tq, h, dh = q.shape
    keys, rows = _tile("flash_bwd_dkv", q.dtype, dh, tile)
    lib = _library()
    with torch.cuda.device(q.device):
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        mask_c = mask.contiguous() if mask is not None else None
        rc = lib.dmp_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            _strides(q, k, v, g),
            mask_c.data_ptr() if mask_c is not None else None,
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, tq, k.shape[1], h, dh, keys, rows,
            int(q.dtype == torch.bfloat16),
            scale, int(causal), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "flash_bwd_dkv", q, k)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# ------------------------------------------------ entry points, autograd


def flash_forward_lse(q, k, v, mask=None, *, scale: float,
                      causal: bool = False) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Forward that also returns the per-row LSE (B, H, Tq) f32 (+inf for
    rows with no valid key): the ring's per-hop forward."""
    return flash_fwd(q, k, v, mask, scale=scale, causal=causal,
                     need_lse=True)


def flash_backward(q, k, v, mask, out, lse, g, *, scale: float,
                   causal: bool = False):
    """(dq, dk, dv) under an external LSE (B, H, Tq) (+inf = empty row):
    delta in torch, then K2, then K3. The incoming gradient is made
    contiguous in q's dtype (a copy only where it is not already), so
    that K2 can take it whatever autograd hands in."""
    g = g.to(q.dtype).contiguous()
    delta = flash_delta(g, out)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, mask, scale=scale,
                      causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, mask, scale=scale,
                           causal=causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's `_flash` custom_vjp: the forward saves (q, k, v,
    mask, out, lse), computing the LSE only when a gradient is needed;
    the backward runs K2 then K3 and returns dq, dk, dv in the input
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float, causal: bool):
        need_lse = any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd(q, k, v, mask, scale=scale, causal=causal,
                             need_lse=need_lse)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, mask, out, lse, g,
                                    scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, *, scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """Drop-in `attention_fn` on the flash kernels. `scale` defaults to
    1/sqrt(Dh) in Python double, as the reference's does. Only (B, Tkv)
    key masks are taken."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if mask is not None and mask.dim() != 2:
        raise NotImplementedError(
            "flash_attention supports (B, Tkv) key-validity masks; use "
            "dot_product_attention for general logit masks"
        )
    if not kernel_viable(q.shape[1], k.shape[1]):
        return dot_product_attention(q, k, v, mask, scale=scale,
                                     causal=causal)
    return FlashAttention.apply(q, k, v, mask, scale, causal)


__all__ = [
    "DEFAULT_TILE",
    "FlashAttention",
    "HEAD_DIMS",
    "TILES",
    "flash_attention",
    "flash_backward",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_delta",
    "flash_forward_lse",
    "flash_fwd",
    "flash_fwd_plain",
    "kernel_viable",
]
