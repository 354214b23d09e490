// int8 decode GEMM for Hopper (sm_90a): y = dequant(quant_rows(x) @ wq).
//
// Replaces the Pallas TPU kernel `ops/quant_matmul.py::_int8_kernel`
// (launched by `_int8_matmul_pallas`, `pallas_call` at quant_matmul.py:190)
// of the JAX package, with the same arithmetic, bit for bit:
//   xscale[m] = max(max_k |x[m,k]|, ABSMAX_FLOOR) / 127          (f32, IEEE)
//   q[m,k]    = clip(rint(x[m,k] / xscale[m]), -127, 127)         (half to even)
//   acc[m,n]  = sum_k q[m,k] * wq[k,n]                            (int32, exact)
//   y[m,n]    = float_rn(acc[m,n]) * xscale[m] * wscale[n]        (left to right)
// The weight arrives pre-quantized and transposed, wq_t (N, K) int8, so
// that each output column's K axis is contiguous; its per-column scale
// wscale (N,) f32 is computed outside the kernel, as in the reference.
//
// What bounds it on an H100: at decode M = num_slots = 8 the kernel
// streams the int8 weight, K*N bytes per launch; the GPT-2-small decode
// step makes 48 launches (4 projections x 12 layers) moving about 85 MB
// of weight bytes, about 25 us at 3.35 TB/s, while its 2*M*K*N int8
// operations are nowhere near the 1,979 TOP/s tensor-core rate. So the
// bound is bytes, and the only lever is to read the weight once, fully
// coalesced, with enough loads in flight.
//
// What this simple design does about it: one warp owns one output column
// at a time and streams that column's K bytes as 4-byte words, adjacent
// lanes on adjacent words (coalesced 128-byte requests), accumulating
// every row of the block's row tile at once with __dp4a, so each weight
// byte is read exactly once per row tile (once in all at decode M <= 8).
// What it does not do: it issues 4-byte rather than 16-byte loads, keeps
// no loads in flight beyond what the warp scheduler overlaps, leaves SMs
// idle when N/kColsPerBlock < 132, and every column block re-quantizes
// the same x rows (cheap at M = 8, where x is 8*K floats, but redundant).
// Tensor-core s8 mma/wgmma, TMA and a separate quantize pass are for
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: the division stays IEEE).
// ABI: plain C, bound with ctypes by ops/quant_matmul.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;            // rows of x per block (decode M = 8)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerBlock = 32;   // output columns per block, 4 per warp
constexpr int kMaxSmemBytes = 48 * 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ wq_t,
                   const float* __restrict__ wscale,
                   float* __restrict__ out,
                   int8_t* __restrict__ q_out,
                   float* __restrict__ scale_out,
                   int M, int N, int K, float absmax_floor) {
  // Row tile of int8 codes, kRows x K bytes; K % 4 == 0 so each row
  // starts on a 4-byte word.
  extern __shared__ int xq_words[];
  __shared__ float s_scale[kRows];
  int8_t* xq = reinterpret_cast<int8_t*>(xq_words);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kRows;
  const bool store_codes = q_out != nullptr && blockIdx.x == 0;

  // 1. Per-row dynamic absmax quantization into shared memory, one warp
  //    per row. Rows past M (ragged last tile) get zero codes and are
  //    never stored.
  for (int r = warp; r < kRows; r += kWarps) {
    const int m = m0 + r;
    int8_t* dst = xq + r * K;
    if (m >= M) {
      for (int k = lane; k < K; k += 32) dst[k] = 0;
      if (lane == 0) s_scale[r] = 0.0f;
      continue;
    }
    const float* row = x + static_cast<size_t>(m) * K;
    float amax = 0.0f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(row[k]));
    amax = warp_max(amax);
    const float scale = fmaxf(amax, absmax_floor) / 127.0f;
    for (int k = lane; k < K; k += 32) {
      const float v = fminf(fmaxf(rintf(row[k] / scale), -127.0f), 127.0f);
      const int8_t c = static_cast<int8_t>(static_cast<int>(v));
      dst[k] = c;
      if (store_codes) q_out[static_cast<size_t>(m) * K + k] = c;
    }
    if (lane == 0) {
      s_scale[r] = scale;
      if (store_codes) scale_out[m] = scale;
    }
  }
  __syncthreads();

  // 2. One warp per output column: stream the column's K int8 weights as
  //    4-byte words and dot them against every row of the tile at once.
  const int k_words = K >> 2;
  const int n_begin = blockIdx.x * kColsPerBlock;
  const int n_end = min(n_begin + kColsPerBlock, N);
  for (int n = n_begin + warp; n < n_end; n += kWarps) {
    const int* w_words =
        reinterpret_cast<const int*>(wq_t + static_cast<size_t>(n) * K);
    int acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int kw = lane; kw < k_words; kw += 32) {
      const int w = __ldg(w_words + kw);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = __dp4a(xq_words[r * k_words + kw], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
    if (lane == 0) {
      const float ws = wscale[n];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = m0 + r;
        if (m < M) {
          out[static_cast<size_t>(m) * N + n] =
              __int2float_rn(acc[r]) * s_scale[r] * ws;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q_out (M, K) int8 and scale_out (M,) f32 may be null; when given, the
// kernel also stores the activation codes and scales it computed.
int dmp_int8_matmul(const float* x, const int8_t* wq_t, const float* wscale,
                    float* out, int8_t* q_out, float* scale_out,
                    int M, int N, int K, float absmax_floor,
                    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows) * K;
  if (M <= 0 || N <= 0 || K <= 0 || (K & 3) != 0 || smem > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock,
                  (M + kRows - 1) / kRows);
  int8_matmul_kernel<<<grid, kThreads, smem, stream>>>(
      x, wq_t, wscale, out, q_out, scale_out, M, N, K, absmax_floor);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's shared-memory budget, so the wrapper can refuse a K the
// kernel cannot take before launching.
int dmp_int8_matmul_max_k(void) { return kMaxSmemBytes / kRows; }

}  // extern "C"
