"""A recorder of the collective calls one rank issues: the port's
counterpart of the reference's `analysis/hlo.py`.

The reference lowers a train or decode step to XLA HLO and parses the
program text into instructions, their replica groups and their
named-scope tags. The port has no program text: its engines issue their
collectives one call at a time through `torch.distributed`. So the
linter reads what a rank really issues in one step. `recording()` wraps
the collective functions of `torch.distributed` for the length of a
`with` block and appends one `Record` per call:

    all_reduce, all_gather, all_gather_into_tensor, reduce_scatter,
    reduce_scatter_tensor, all_to_all, all_to_all_single, broadcast,
    send, recv, isend, irecv, and each op of a batch_isend_irecv

Each record holds the op, the global ranks of its group (a send or a
receive: this rank and its peer), the dtype, the elements and bytes
this rank hands to it, the reduce op, and the scope it was issued in. A
call that `torch.distributed` makes from inside another (the isend of a
batch, the all_gather_single behind all_gather_into_tensor) is not
recorded twice.

Scopes stand in for the reference's `named_scope` tags (`moe_ring`,
`serve_ring`, `dcn_wire`, `plan_wire`, ...), which its rules key on.
The port's hop sites name their hops through one seam, `scope(name)`;
`note(kind, **facts)` records a fact that is not a collective (a stage's
backward starting, a quantized projection GEMM). `scope` tests one
flag when no recording runs, and nothing else; a `note` site tests the
flag itself (`if record.ON: record.note(...)`), so that it builds its
facts only while a recording runs.

`fake_world(rank, world)` lets one process play rank `rank` of a world
of `world` ranks and record that rank's program. It is the one use in
this package of an internal torch API, the fake process group of
`torch.testing._internal.distributed.fake_pg`, whose collectives return
at once and move no data; keep every use of it here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

#: the flag every seam tests; True only inside `recording()`
ON = False
_SCOPES: List[str] = []
_EVENTS: List[Any] = []
_DEPTH = 0
# one scope word per op of the next batch_isend_irecv ("" = none)
_OP_SCOPES: Optional[List[str]] = None

DTYPE_TOKENS = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
    torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
}


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective call of this rank. `op` is the logical kind
    (all_reduce / all_gather / reduce_scatter / all_to_all / broadcast /
    send / recv); `call` the `torch.distributed` function; `ranks` the
    global ranks of its group, or (src, dst) for a send or a receive."""

    seq: int
    op: str
    call: str
    ranks: Tuple[int, ...]
    dtype: str
    elems: int
    nbytes: int
    scope: str
    reduce_op: str = ""
    # "path:line" of the port's call site (the first frame outside torch
    # and this module)
    site: str = ""

    @property
    def is_hop(self) -> bool:
        return self.op in ("send", "recv")


@dataclasses.dataclass(frozen=True)
class Note:
    """A fact of the step that is not a collective (`note`)."""

    seq: int
    kind: str
    scope: str
    facts: Tuple[Tuple[str, Any], ...]

    def get(self, key: str, default=None):
        return dict(self.facts).get(key, default)


class _Scope:
    __slots__ = ("name", "pushed")

    def __init__(self, name: str):
        self.name = name
        self.pushed = False

    def __enter__(self):
        if ON:
            _SCOPES.append(self.name)
            self.pushed = True
        return self

    def __exit__(self, *exc):
        if self.pushed and _SCOPES and _SCOPES[-1] == self.name:
            _SCOPES.pop()
        return False


_NULL = contextlib.nullcontext()


def scope(name: str):
    """The seam a hop site names its collectives through: a context under
    which every record carries `name` in its scope ("a/b" when nested)."""
    return _Scope(name) if ON else _NULL


class _OpScopes:
    __slots__ = ("names",)

    def __init__(self, names):
        self.names = list(names)

    def __enter__(self):
        global _OP_SCOPES
        _OP_SCOPES = self.names
        return self

    def __exit__(self, *exc):
        global _OP_SCOPES
        _OP_SCOPES = None
        return False


def op_scopes(names):
    """The seam of a batched hop site (`ops/wire_codec._ppermutes_start`):
    a context under which the next `batch_isend_irecv` gives its i-th op
    the extra scope word `names[i]` ("" for none), so that one batch can
    carry a payload and its int8 scale sidecar under their own names."""
    return _OpScopes(names) if ON else _NULL


def note(kind: str, **facts) -> None:
    """Record a fact of the step (module docstring); a no-op unless a
    recording runs."""
    if ON:
        _EVENTS.append(Note(len(_EVENTS), kind, "/".join(_SCOPES),
                            tuple(sorted(facts.items()))))


# ------------------------------------------------------------ wrapping

def _group_ranks(group) -> Tuple[int, ...]:
    if group is None or group is dist.group.WORLD:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _global_peer(group, peer, group_peer) -> int:
    if group_peer is not None:
        if group is None or group is dist.group.WORLD:
            return int(group_peer)
        return dist.get_global_rank(group, group_peer)
    return int(peer)


def _numel(x) -> Tuple[int, int, str]:
    if isinstance(x, (list, tuple)):
        ts = [t for t in x if isinstance(t, torch.Tensor)]
        if not ts:
            return 0, 0, "f32"
        return (sum(t.numel() for t in ts),
                sum(t.numel() * t.element_size() for t in ts),
                DTYPE_TOKENS.get(ts[0].dtype, str(ts[0].dtype)))
    return (x.numel(), x.numel() * x.element_size(),
            DTYPE_TOKENS.get(x.dtype, str(x.dtype)))


def _site() -> str:
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if path != __file__ and f"{os.sep}torch{os.sep}" not in path:
            return f"{path}:{frame.f_lineno}"
        frame = frame.f_back
    return ""


def _append(op, call, ranks, payload, reduce_op="") -> None:
    elems, nbytes, dt = _numel(payload)
    _EVENTS.append(Record(len(_EVENTS), op, call, tuple(ranks), dt, elems,
                          nbytes, "/".join(_SCOPES), reduce_op, _site()))


def _op_name(op) -> str:
    if op is None:
        return "sum"
    name = getattr(op, "name", None)
    return (name if isinstance(name, str) else str(op)).lower().split(".")[-1]


# name -> (logical op, the argument that carries this rank's payload)
_COLLECTIVES = {
    "all_reduce": ("all_reduce", "tensor"),
    "all_gather": ("all_gather", "tensor"),
    "all_gather_into_tensor": ("all_gather", "input_tensor"),
    "reduce_scatter": ("reduce_scatter", "input_list"),
    "reduce_scatter_tensor": ("reduce_scatter", "input"),
    "all_to_all": ("all_to_all", "input_tensor_list"),
    "all_to_all_single": ("all_to_all", "input"),
    "broadcast": ("broadcast", "tensor"),
}
_P2P = {"send": ("send", "dst", "group_dst"),
        "isend": ("send", "dst", "group_dst"),
        "recv": ("recv", "src", "group_src"),
        "irecv": ("recv", "src", "group_src")}


def _wrap(name, fn):
    sig = inspect.signature(fn)

    def wrapper(*args, **kwargs):
        global _DEPTH
        if _DEPTH == 0:
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            group = a.get("group")
            if name in _COLLECTIVES:
                op, key = _COLLECTIVES[name]
                _append(op, name, _group_ranks(group), a[key],
                        _op_name(a.get("op")) if op in
                        ("all_reduce", "reduce_scatter") else "")
            else:
                op, peer, group_peer = _P2P[name]
                me = dist.get_rank()
                other = _global_peer(group, a.get(peer), a.get(group_peer))
                pair = (me, other) if op == "send" else (other, me)
                _append(op, name, pair, a["tensor"])
        _DEPTH += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH -= 1

    wrapper.__name__ = name
    wrapper.__wrapped__ = fn
    return wrapper


def _wrap_batch(fn, isend):
    def batch_isend_irecv(p2p_op_list):
        global _DEPTH
        if _DEPTH == 0:
            me = dist.get_rank()
            extra = _OP_SCOPES or [""] * len(p2p_op_list)
            for p, word in zip(p2p_op_list, extra):
                send = p.op is isend
                pair = (me, p.peer) if send else (p.peer, me)
                if word:
                    _SCOPES.append(word)
                try:
                    _append("send" if send else "recv", "batch_isend_irecv",
                            pair, p.tensor)
                finally:
                    if word:
                        _SCOPES.pop()
        _DEPTH += 1
        try:
            return fn(p2p_op_list)
        finally:
            _DEPTH -= 1

    batch_isend_irecv.__wrapped__ = fn
    return batch_isend_irecv


@dataclasses.dataclass
class Recording:
    """What one `recording()` block saw, in issue order."""

    events: List[Any] = dataclasses.field(default_factory=list)

    @property
    def records(self) -> List[Record]:
        return [e for e in self.events if isinstance(e, Record)]

    @property
    def notes(self) -> List[Note]:
        return [e for e in self.events if isinstance(e, Note)]


@contextlib.contextmanager
def recording():
    """Record every collective this process issues inside the block
    (module docstring); yields the `Recording`, filled as calls run.
    `isend` / `irecv` are wrapped in `torch.distributed`'s own module
    too, so that a `P2POp` built inside the block passes its check and
    `batch_isend_irecv` sees the same functions."""
    global ON, _EVENTS
    from torch.distributed import distributed_c10d as c10d

    if ON:
        raise RuntimeError("recording() does not nest")
    saved: Dict[Tuple[Any, str], Any] = {}

    def patch(module, name, value):
        saved[module, name] = getattr(module, name)
        setattr(module, name, value)

    rec = Recording()
    for name in list(_COLLECTIVES) + ["send", "recv"]:
        if hasattr(dist, name):
            patch(dist, name, _wrap(name, getattr(dist, name)))
    for name in ("isend", "irecv"):
        w = _wrap(name, getattr(c10d, name))
        patch(dist, name, w)
        patch(c10d, name, w)
    patch(dist, "batch_isend_irecv",
          _wrap_batch(dist.batch_isend_irecv, c10d.isend))
    _EVENTS = rec.events
    _SCOPES.clear()
    ON = True
    try:
        yield rec
    finally:
        ON = False
        _SCOPES.clear()
        _EVENTS = []
        for (module, name), value in saved.items():
            setattr(module, name, value)


@contextlib.contextmanager
def fake_world(rank: int, world: int):
    """This process as rank `rank` of a world of `world` ranks on torch's
    fake process group (module docstring): every collective returns at
    once, and a receive leaves its buffer as it was. Refused when a
    process group is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process "
                           "group; this one has one")
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


__all__ = ["DTYPE_TOKENS", "Note", "Record", "Recording", "fake_world",
           "note", "op_scopes", "recording", "scope"]
