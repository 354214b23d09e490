"""Wire compression for the cross-slice ('dcn') hop of the gradient
reduction (port of `ops/wire_codec.py`).

The bucketed reducer (`ops/grad_reduction.py`) confines the slow
cross-slice fabric to a 1/ici shard of each bucket; that hop is where a
payload is both large and on the slowest link, and so where compressing
it pays (PyTorch DDP's comm hooks on its bucketed Reducer are the same
seam). Two codecs, selected by name (`dcn_compression` on the engines,
`--dcn-compression` on the CLIs):

* `"bf16"`: encode = cast to bfloat16, decode = cast back. Half the
  bytes; one rounding per hop (<= 2**-8 relative).
* `"int8"`: one f32 scale `max(|x|, ABSMAX_FLOOR) / 127` over the whole
  chunk, the chunk quantized to int8 (round half to even, clipped to
  +-127) and the scale sent beside it; decode multiplies back. A quarter
  of the bytes plus 4 bytes; <= max(absmax, ABSMAX_FLOOR)/254 an element
  per hop. Denormal inputs count as zeros, as on the reference's
  backends (the TPU has no f32 denormals, XLA's CPU flushes them), so a
  chunk gets the same codes on the card, the CPU and the reference. The
  scale is a true division by 127, as the reference writes it and
  computes it op by op (jitted, XLA turns it into a multiplication by
  1/127, which rounds a few scales in a hundred one ulp away).

Everything inside a slice, and every accumulation, stays in the math
dtype: int8 never sums in int8. `coded_all_to_all` and
`coded_all_gather` are the group exchanges the reducer rides: encode,
move the payload and the int8 scales over the process group, decode.
`coded_ppermute` is the reference's point-to-point hop: the payload
sent along a permutation of the group's ranks (`dist.batch_isend_irecv`)
with the int8 scale riding the same permutation, as a
`torch.autograd.Function` whose backward sends the cotangent through the
same codec over the inverse permutation (the reference's custom VJP).
FSDP's compressed cross-slice weight gather (`parallel/fsdp.py`) runs
its forward; expert dispatch will differentiate through it.

A gloo group carries no CUDA tensor in these exchanges, so on the card
a gloo group's hop is staged through the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.analysis.record import (
    op_scopes,
    scope,
)

# "none" keeps the f32 wire byte for byte.
COMPRESSION_MODES: Tuple[str, ...] = ("none", "bf16", "int8")

# Zero-chunk guard: an all-zero chunk gets this absmax instead of 0, so
# its scale floor/127 stays a normal f32 (a denormal scale flushes to
# zero under FTZ and the chunk would divide by 0). 127x f32's smallest
# normal; decode of an all-zero chunk is still exactly zero.
ABSMAX_FLOOR = 127 * 1.1754944e-38
# f32's smallest normal: magnitudes below it are flushed before encoding.
_F32_TINY = 1.1754944e-38


def check_compression(name: str) -> str:
    """Validate a compression-mode name (engines call this at
    construction, so a typo fails at once)."""
    if name not in COMPRESSION_MODES:
        raise ValueError(
            f"dcn_compression must be one of {COMPRESSION_MODES}, got "
            f"{name!r}"
        )
    return name


def require_dcn_axis(name: str, dcn_group, what: str = "hop") -> str:
    """A compressed wire needs a cross-slice fabric to cross; validates
    the mode name too. `dcn_group` is the mesh's cross-slice group (None
    on a one-fabric mesh)."""
    check_compression(name)
    if name != "none" and dcn_group is None:
        raise ValueError(
            f"dcn_compression compresses the cross-slice {what}; this "
            "mesh carries no 'dcn' axis — factor the data axis with "
            "MeshSpec(dcn=K) (--dcn-slices on the CLIs)"
        )
    return name


def wire_itemsize(wire: str) -> int:
    """Bytes an element on the 'dcn' wire (scale sidecars excluded)."""
    return {"none": 4, "bf16": 2, "int8": 1}[wire]


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division, as the reference computes it. On
    CUDA, torch divides by a Python scalar as a multiplication by its
    reciprocal, which rounds differently for some t; a tensor divisor
    keeps the true quotient on every device."""
    return t / torch.full_like(t, 127.0)


def wire_encode(wire: str, x: torch.Tensor):
    """x -> (payload, scale): `scale` is None for the cast codecs and an
    f32 0-dim tensor for int8 (absmax / 127 over the whole chunk)."""
    if wire == "bf16":
        return x.to(torch.bfloat16), None
    if wire == "int8":
        xf = x.float()
        xf = torch.where(xf.abs() >= _F32_TINY, xf, 0.0)
        scale = _div127(torch.clamp_min(xf.abs().amax(), ABSMAX_FLOOR))
        q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
        return q.to(torch.int8), scale
    return x, None


def wire_decode(wire: str, payload: torch.Tensor,
                scale: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Inverse of `wire_encode`, back to the chunk's math dtype."""
    if wire == "bf16":
        return payload.to(dtype)
    if wire == "int8":
        return (payload.float() * scale).to(dtype)
    return payload


def _encode_rows(wire: str, rows: torch.Tensor):
    """Each row of `rows` (K, n) encoded on its own: (payloads (K, n),
    scales (K,) f32 or None)."""
    coded = [wire_encode(wire, r) for r in rows]
    payload = torch.stack([p for p, _ in coded])
    if wire != "int8":
        return payload, None
    return payload, torch.stack([s for _, s in coded])


def _decode_rows(wire: str, payload, scales, dtype) -> torch.Tensor:
    if wire != "int8":
        return wire_decode(wire, payload, None, dtype)
    return (payload.float() * scales[:, None]).to(dtype)


def coded_all_to_all(chunks: torch.Tensor, group, wire: str) -> torch.Tensor:
    """chunks (K, n) on each of the group's K ranks; row j goes to rank j
    through the codec. Returns (K, n) in `chunks.dtype`: row j is rank
    j's row for this rank, decoded."""
    payload, scales = _encode_rows(wire, chunks)
    recv = torch.empty_like(payload)
    with scope("dcn_wire"):
        dist.all_to_all_single(recv, payload, group=group)
    if scales is not None:
        got = torch.empty_like(scales)
        with scope("dcn_scale"):
            dist.all_to_all_single(got, scales, group=group)
        scales = got
    return _decode_rows(wire, recv, scales, chunks.dtype)


def coded_all_gather(x: torch.Tensor, group, wire: str) -> torch.Tensor:
    """x (n,) on each of the group's K ranks, encoded once and gathered.
    Returns (K, n) in `x.dtype`: row j is rank j's x, decoded."""
    payload, scale = wire_encode(wire, x)
    k = dist.get_world_size(group)
    out = payload.new_empty((k * payload.numel(),))
    with scope("dcn_wire"):
        dist.all_gather_into_tensor(out, payload.reshape(-1), group=group)
    out = out.view((k,) + tuple(payload.shape))
    scales = None
    if scale is not None:
        scales = scale.new_empty((k,))
        with scope("dcn_scale"):
            dist.all_gather_into_tensor(scales, scale.reshape(1),
                                        group=group)
    return _decode_rows(wire, out, scales, x.dtype)


def host_staged(x: torch.Tensor, group) -> bool:
    """Whether `x` crosses `group` through the host: a gloo group carries
    no CUDA tensor in send / recv, all-to-all or all-gather."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _ppermutes_start(hops, group, scopes=None):
    """Starts the sends and receives of several permutations at once, one
    `batch_isend_irecv`: `hops` is a sequence of (x, perm) pairs, each as
    `_ppermute` takes them; `scopes[i]` names hop i's records for the
    linter (`analysis/record.op_scopes`). Returns the function that
    waits for them and gives what this rank receives of each, in order,
    so that work issued in between overlaps the transfers."""
    me = dist.get_rank(group)
    ops, outs, words = [], [], []
    for i, (x, perm) in enumerate(hops):
        word = scopes[i] if scopes else ""
        host = host_staged(x, group)
        src_t = x.cpu() if host else x.contiguous()
        out = torch.zeros_like(src_t)
        for src, dst in perm:
            if src == me and dst == me:
                out = src_t.clone()
            elif src == me:
                ops.append(dist.P2POp(dist.isend, src_t, dist.get_global_rank(
                    group, dst), group))
                words.append(word)
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                    group, src), group))
                words.append(word)
        outs.append((out, x.device if host else None))
    with op_scopes(words):
        works = dist.batch_isend_irecv(ops) if ops else []

    def finish() -> list:
        for work in works:
            work.wait()
        return [out if device is None else out.to(device)
                for out, device in outs]

    return finish


def _ppermute_start(x: torch.Tensor, group, perm):
    """Starts `_ppermute`'s sends and receives and returns the function
    that waits for them and gives what this rank receives, so that work
    issued in between overlaps the transfer."""
    finish = _ppermutes_start([(x, perm)], group)
    return lambda: finish()[0]


def _ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """`x` sent along `perm`, (src, dst) pairs of ranks of `group`: what
    this rank receives, or zeros when no pair sends to it (the
    reference's `lax.ppermute`)."""
    return _ppermute_start(x, group, perm)()


def _coded_hop(x: torch.Tensor, group, perm, wire: str) -> torch.Tensor:
    """encode -> permute the payload (and the int8 scale) -> decode."""
    payload, scale = wire_encode(wire, x)
    with scope("dcn_wire"):
        payload = _ppermute(payload, group, perm)
    if scale is not None:
        with scope("dcn_scale"):
            scale = _ppermute(scale.reshape(1), group, perm).reshape(())
    return wire_decode(wire, payload, scale, x.dtype)


class _CodedPpermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm, wire):
        ctx.group, ctx.perm, ctx.wire = group, perm, wire
        return _coded_hop(x, group, perm, wire)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((dst, src) for src, dst in ctx.perm)
        return _coded_hop(g, ctx.group, inv, ctx.wire), None, None, None


def coded_ppermute(x: torch.Tensor, group, perm,
                   wire: str = "none") -> torch.Tensor:
    """A permutation hop over `group` whose payload crosses the wire
    compressed: `perm` is a tuple of (src, dst) pairs of the group's
    ranks. The backward sends the cotangent through the same codec over
    the inverse permutation."""
    return _CodedPpermute.apply(x, group, tuple(perm), check_compression(wire))


__all__ = [
    "ABSMAX_FLOOR",
    "COMPRESSION_MODES",
    "check_compression",
    "coded_all_gather",
    "coded_all_to_all",
    "coded_ppermute",
    "host_staged",
    "require_dcn_axis",
    "wire_decode",
    "wire_encode",
    "wire_itemsize",
]
