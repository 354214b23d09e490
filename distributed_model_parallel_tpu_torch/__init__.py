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

Ported so far:
* slice 1, GPT serving with int8 decode projections — `cli/serve.py`
  -> `serving/engine.py::ServingEngine` on the `models/gpt.py` decoder,
  with the int8 GEMM kernel `csrc/int8_matmul.cu` (replacing
  `ops/quant_matmul.py::_int8_kernel`);
* slice 2, causal-LM training on one device — `cli/lm.py` ->
  `training/trainer.py::Trainer` -> `parallel/sequence_parallel.py::
  CausalLMSequenceParallelEngine`, with the flash-attention forward,
  dq and dk/dv kernels `csrc/flash_attention.cu` (replacing
  `ops/pallas_attention.py`'s three Pallas kernels);
* slice 5, data-parallel CIFAR training over `torch.distributed` —
  `cli/data_parallel.py` -> `parallel/data_parallel.py::
  DataParallelEngine` / `DDPEngine` -> `models/mobilenetv2.py`, with
  rank-sharded loaders and the native augment (`native/augment.cpp`);
  no TPU kernel lies on this path.
"""
