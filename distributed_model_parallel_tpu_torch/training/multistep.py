"""Multi-step dispatch: k optimizer steps per host dispatch (port of
`training/multistep.py`).

The reference folds k train steps into one compiled program
(`lax.scan` over stacked batches) so that the host pays one dispatch a
group instead of one a step. On CUDA the counterpart is a CUDA graph:
the engine's train step (and its eval step) is captured once and
replayed, one `cudaGraphLaunch` standing for the thousands of kernel
launches, allocator calls and Python frames a step costs the host.

`compile_multi_step(engine, k)` returns `fn(state, batches, lr) ->
(state, summed metrics)`, with the reference's contracts: `batches` is
a sequence of k batch tuples from `engine.shard_batch`, the metrics are
the SUM over the k steps of the engine's per-step sums, k = 1 passes
through (one `engine.train_step`), and k < 1 is refused.
`compile_multi_eval` is its eval twin; `group_batches` pulls a group
from an iterator (a short group means the iterator is exhausted).

* On the CPU (batches on the CPU) a dispatch is k engine steps in one
  call.
* On the card it is one captured step replayed k times. The first call
  runs the group's first step eagerly on a side stream through static
  input, lr, step and metric buffers (the warmup: it builds the kernel
  libraries, sets their shared-memory attributes, warms cuBLAS, cuDNN,
  the autograd engine and the NCCL communicator), then captures the step
  on that stream into a graph, and replays it for the remaining steps.
  Before each replay the batch is copied into the static input and the
  step's lr and step count are written into their device scalars, so
  the replay runs the kernels of an eager step on the values of an
  eager step (dropout keys fold the device step: `parallel/
  data_parallel.step_key`). The engines write every piece of state they
  update back into the state's own tensors, so replays advance the
  trainer's state. A state whose tensors moved (a resume) or a batch of
  another shape is captured again; a capture failure raises.
* The Python counters a step bumps (an engine's `grad_reductions`, the
  kernels' `launches`) count what the host issues: the warmup step's
  launches and the capture's, which the graph records. A replay runs
  no Python and bumps none of them; its kernels show in a profiler
  trace of the dispatch, by name.

A pipeline whose stages span more than one device is refused for
k > 1 (one graph per device, and copies between them, belong to ROADMAP
§A.7's multi-card runs).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from distributed_model_parallel_tpu_torch.training.optim import tree_leaves


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")


def check_capturable(engine: Any) -> None:
    """Refuse an engine whose step spans more than one device, or whose
    step on the card runs collectives over a gloo group (NCCL's
    collectives can be captured in a CUDA graph; gloo's run on the host
    and cannot)."""
    mesh = getattr(engine, "mesh", None)
    device = getattr(engine, "device", None)
    if mesh is not None and device is not None \
            and torch.device(device).type == "cuda":
        for name in ("group", "model_group", "seq_group",
                     "expert_group"):
            group = getattr(mesh, name, None)
            if group is not None and \
                    torch.distributed.get_backend(group) == "gloo":
                raise ValueError(
                    "steps_per_dispatch > 1 captures the step in one CUDA "
                    f"graph; this engine's {name} runs on gloo, whose "
                    "collectives a CUDA graph cannot capture — use NCCL "
                    "(one rank a GPU) or steps_per_dispatch 1")
    devices = getattr(engine, "devices", None)
    if devices is not None and len(set(map(str, devices))) > 1:
        raise ValueError(
            "steps_per_dispatch > 1 captures the step in one CUDA graph; "
            f"this pipeline's stages span {len(set(map(str, devices)))} "
            "devices, which belongs to ROADMAP.md §A.7 (runs on more than "
            "one card) — use steps_per_dispatch 1"
        )


def add_sums(sums: Optional[dict], m: dict) -> dict:
    """Metric sums plus one more step's (None: the first step's)."""
    return dict(m) if sums is None else {k: sums[k] + m[k] for k in sums}


def _on_cuda(batch) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in batch)


class StepGraph:
    """One engine step (train or eval) captured in a CUDA graph, replayed
    once per batch (module docstring). `captures` counts the captures,
    `capture_s` the seconds of the last (warmup step excluded), `replays`
    the replays."""

    def __init__(self, engine: Any, train: bool):
        self.engine = engine
        self.train = train
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.signature = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def _signature(self, state, batch) -> tuple:
        leaves = tree_leaves((state.params, state.model_state,
                              tuple(state.opt_state)))
        return (tuple(t.data_ptr() for t in leaves),
                tuple((tuple(b.shape), b.dtype, str(b.device))
                      for b in batch))

    def _call(self, state, lr):
        if self.train:
            return self.engine.train_step(
                state._replace(step=self.static_step), *self.static_batch,
                self.static_lr)[1]
        return self.engine.eval_step(state, *self.static_batch)

    def _load(self, batch, lr, step) -> None:
        for dst, src in zip(self.static_batch, batch):
            dst.copy_(src, non_blocking=True)
        if self.train:
            if isinstance(lr, torch.Tensor):
                self.static_lr.copy_(lr, non_blocking=True)
            else:
                self.static_lr.fill_(lr)
            self.static_step.fill_(step)

    def _capture(self, state, batch, lr, step) -> dict:
        """Warm up on the group's first batch (a real step, run eagerly),
        then capture; returns the warmup step's metrics."""
        self.graph = None  # release an older capture's memory pool
        device = batch[0].device
        self.static_batch = [torch.empty_like(b) for b in batch]
        self.static_lr = torch.zeros((), dtype=torch.float32, device=device)
        self.static_step = torch.zeros((), dtype=torch.int64, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._load(batch, lr, step)
            m = self._call(state, lr)
            first = {k: v.float().clone() for k, v in m.items()}
        torch.cuda.current_stream(device).wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            m = self._call(state, lr)
            self.keys = sorted(m)
            self.static_out = torch.stack([m[k].float() for k in self.keys])
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self.captures += 1
        return first

    def run(self, state, batches: List[tuple], lr=None, step: int = 0):
        """Each batch through the captured step, in order; returns the
        metric sums over the batches, added step after step."""
        sig = self._signature(state, batches[0])
        acc = None
        if self.graph is None or sig != self.signature:
            first = self._capture(state, batches[0], lr, step)
            acc = torch.stack([first[k] for k in self.keys])
            self.signature = sig
            batches, step = batches[1:], step + 1
        for i, batch in enumerate(batches):
            self._load(batch, lr, step + i)
            self.graph.replay()
            self.replays += 1
            acc = self.static_out.clone() if acc is None \
                else acc.add_(self.static_out)
        return dict(zip(self.keys, acc.unbind()))


def compile_multi_step(engine: Any, k: int) -> Callable:
    """`fn(state, batches, lr) -> (state, summed metrics)` running the k
    batches' train steps in one dispatch (module docstring)."""
    _check_k(k)
    if k > 1:
        check_capturable(engine)
    graph = StepGraph(engine, train=True)

    def k_steps(state, batches, lr):
        batches = list(batches)
        if k > 1 and _on_cuda(batches[0]):
            sums = graph.run(state, batches, lr, int(state.step))
            return state._replace(step=state.step + len(batches)), sums
        sums = None
        for b in batches:
            state, m = engine.train_step(state, *b, lr)
            sums = add_sums(sums, m)
        return state, sums

    k_steps.graph = graph
    return k_steps


def compile_multi_eval(engine: Any, k: int) -> Callable:
    """Eval twin of `compile_multi_step`: `fn(state, batches) -> summed
    metrics` over k batches in one dispatch; the state is read only."""
    _check_k(k)
    if k > 1:
        check_capturable(engine)
    graph = StepGraph(engine, train=False)

    def k_evals(state, batches):
        batches = list(batches)
        if k > 1 and _on_cuda(batches[0]):
            return graph.run(state, batches)
        sums = None
        for b in batches:
            sums = add_sums(sums, engine.eval_step(state, *b))
        return sums

    k_evals.graph = graph
    return k_evals


def group_batches(iterator, k: int) -> list:
    """Pull up to `k` items from `iterator`; a short list means the
    iterator was exhausted (the caller's per-step fallback path)."""
    group = []
    while len(group) < k:
        try:
            group.append(next(iterator))
        except StopIteration:
            break
    return group


__all__ = ["StepGraph", "add_sums", "check_capturable",
           "compile_multi_eval", "compile_multi_step", "group_batches"]
