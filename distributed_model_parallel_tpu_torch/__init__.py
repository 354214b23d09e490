"""PyTorch + CUDA port of `distributed_model_parallel_tpu` for an NVIDIA
H100 (sm_90a).

The JAX package beside this one is the reference: every module here
mirrors a module of the same name there, keeps its public layouts
(activations (B, T, H, Dh), linear weights stored (K, N)), and is held
against it numerically by `tests/test_torch_port_*.py`.

The port imports torch, numpy and the standard library only — never
jax and never the JAX package. Every Pallas TPU kernel on a ported path
becomes a hand-written Hopper kernel under `csrc/`, built with nvcc at
first use and bound with ctypes (`ops/_cuda.py`); beside each kernel
lives a plain PyTorch version with the same arithmetic, which the
wrapper takes only for tensors on the CPU.

Ported so far (slice 1): GPT serving with int8 decode projections —
`cli/serve.py` -> `serving/engine.py::ServingEngine` on the
`models/gpt.py` decoder, with the int8 GEMM kernel
`csrc/int8_matmul.cu` (replacing `ops/quant_matmul.py::_int8_kernel`).
"""
