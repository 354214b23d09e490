"""PyTorch + CUDA port of `distributed_model_parallel_tpu` for an NVIDIA
H100 (sm_90a).

The JAX package beside this one is the reference: every module here
mirrors a module of the same name there, keeps its public layouts
(activations (B, T, H, Dh), NHWC image batches, linear weights stored
(K, N); conv weights alone take torch's (O, I/groups, kh, kw), see
`models/convert.py`), and is held against it numerically by
`tests/test_torch_port_*.py`.

The port imports torch, numpy and the standard library only — never
jax and never the JAX package. Every Pallas TPU kernel on a ported path
becomes a hand-written Hopper kernel under `csrc/`, built with nvcc at
first use and bound with ctypes (`ops/_cuda.py`); beside each kernel
lives a plain PyTorch version with the same arithmetic, which the
wrapper takes only for tensors on the CPU.

Ported, slice by slice (all of the JAX package's modules, apart from
its two jax shims `runtime/compat.py` and `runtime/platform.py`;
`analysis/hlo.py` becomes `analysis/record.py` and
`ops/pallas_attention.py` becomes `ops/flash_attention.py`):
* slice 1, GPT serving with int8 decode projections: `cli/serve.py` ->
  `serving/engine.py::ServingEngine` on the `models/gpt.py` decoder,
  with the int8 GEMM kernel `csrc/int8_matmul.cu` (replacing
  `ops/quant_matmul.py::_int8_kernel`);
* slice 2, causal-LM training on one device: `cli/lm.py` ->
  `training/trainer.py::Trainer` -> `parallel/sequence_parallel.py::
  CausalLMSequenceParallelEngine`, with the flash-attention forward,
  dq and dk/dv kernels `csrc/flash_attention.cu` (replacing
  `ops/pallas_attention.py`'s three Pallas kernels);
* slice 5, data-parallel CIFAR training over `torch.distributed`:
  `cli/data_parallel.py` -> `parallel/data_parallel.py` ->
  `models/mobilenetv2.py`, with rank-sharded loaders and the native
  augment (`native/augment.cpp`);
* slice 6, checkpoint and resume on those CLIs (the JAX package's
  legacy format), `serve --checkpoint` and `--finetune`;
* slice 7, pipeline model parallelism (`cli/model_parallel.py`,
  `parallel/pipeline.py`); slice 8, the serving features on one card
  (paged cache, chunked prefill, prefix cache, speculative decoding,
  bf16 decode); slice 9, `--remat`, `--steps-per-dispatch` (CUDA
  graphs), `--profile-dir`, `--metrics-out`, ViT and BERT;
* slice 10, gradient reduction (`ops/grad_reduction.py`,
  `ops/wire_codec.py`); slice 11, tensor parallelism, the device cache
  and the image folders; slice 12, FSDP, the sharded checkpoint format
  (`checkpointing/`) and elastic restart; slice 13, sequence
  parallelism at N > 1 (`ops/ring_attention.py`);
* slice 14, the tp / sp serving layouts and collective matmul; slice
  15, expert parallelism (`models/moe.py`, `ops/expert_dispatch.py`,
  `parallel/expert_parallel.py`); slice 16, composed parallel plans
  (`parallel/plan.py`); slice 17, EP x TP and the collective-contract
  linter (`analysis/`); slice 18, the cost engine, its gates and the
  auto-tuner (`observability/cost.py`, `costgate.py`, `tuning/`);
* slice 19, the run report (`observability/attribution.py`,
  `observability/report.py`, over the tracer's traces and
  torch.profiler's) and the JAX package's public import surface: each
  subpackage re-exports the names its JAX counterpart does.

`MeshSpec`, `make_mesh` and `local_mesh` load `runtime/mesh.py` (and
torch) on first use, so that the torch-free modules (the report, the
tracer, the metrics registry) import without it.
"""

_MESH_NAMES = ("MeshSpec", "make_mesh", "local_mesh")


def __getattr__(name: str):
    if name in _MESH_NAMES:
        from distributed_model_parallel_tpu_torch.runtime import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_MESH_NAMES)
