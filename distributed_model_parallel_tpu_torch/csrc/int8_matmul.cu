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
// Integer sums are exact in any order, so splitting K (below) changes no
// bit: outputs, codes and scales equal the plain version's.
// Optional input `row_absmax` (M,) f32 replaces max_k |x[m,k]| in the
// scale (the rest of the formula unchanged): a tensor-parallel rank that
// holds a slice of each row quantizes with the whole row's absmax, taken
// by an all-reduce (MAX) before the launch, as the reference's
// partitioned int8 projection does.
//
// What bounds it on an H100: at decode M = num_slots = 8 the kernel
// streams the int8 weight, K*N bytes a launch (0.6-2.4 MB at GPT-2-small
// width); the decode step's 48 launches move about 85 MB, 25 us at 3.35
// TB/s, while 2*M*K*N int8 operations are far under the 1,979 TOP/s
// rate. So the bound is bytes: 0.18-0.71 us a launch, under the time a
// launch itself takes. The whole weight of one launch is about what the
// card's memory holds in flight at once, so the kernel is bound by
// latency: it has to put (nearly) every load of the weight in flight at
// its start.
//
// The design. A cluster of S blocks (S = 2 for K <= 1024, else 8; set
// at launch) owns kCols = 64 output columns and one tile of 8 rows;
// block `rank` of the cluster owns the rank-th S-th of K. Each thread
// first issues its share of the block's weight slab (64 columns x K/S
// bytes, 4 threads a column) as 16-byte loads (4-byte words where K is
// not a multiple of 16 or an operand is not 16-byte aligned), up to
// kLoads in flight, before anything else. While they are in flight,
// warp r reads row r of x over the block's K into registers and takes
// its absmax; the S blocks push their row absmaxes into each other's
// shared memory (distributed shared memory, one cluster barrier), so x
// is read once per cluster and each block quantizes only the codes it
// uses. Then __dp4a over the codes in shared memory, int32 sums in
// registers and across the column's 4 threads by shuffles; each block
// pushes its partial sums to the rank that dequantizes those columns,
// and after a second cluster barrier that rank adds the S partials and
// dequantizes: no global scratch, no atomics, no counters to reset.
// The constants come from sweeps on the card (int8_sweep.py; PERF.md):
// S chosen by K is what matters (a 2-way split at K = 3072 or an 8-way
// one at K = 768 is 1.7-2x slower there); 64 columns tie 32 at M = 8
// and are faster at M = 256; an earlier design with 1,000-1,500 blocks
// a launch, which fill the card, was twice as slow as these grids of
// 24-96 blocks of 256 threads (12-48 clusters) at the decode shapes.
// Measured on one H100 80GB HBM3 (700 W; chip_smoke.py, device time
// from torch.profiler): 5.8-6.4 us a launch at the four decode shapes
// (qkv, attn.out, ffn.in, ffn.out), 0.297 ms for a decode step's 48
// launches, against 12.5-36 us a launch and 0.870 ms for PR 1's design,
// 0.517 ms for f32 torch.matmul on the same shapes and 0.258 ms for
// cuBLASLt's s8 x s8 -> s32 (torch._int_mm, M padded to 32) on the same
// codes, which does not quantize or dequantize.
// What still lies between it and its 0.19-0.74 us bounds: each launch
// is a chain of latencies (x from L2, a cluster barrier, the
// quantization, the weights from HBM, a second barrier), each about a
// microsecond, on a few hundred kilobytes to 2.4 MB of weight;
// overlapping successive launches (programmatic dependent launch, a
// CUDA graph of the decode step) or fusing the projections of a layer
// would hide them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: the division stays IEEE).
// ABI: plain C, bound with ctypes by ops/quant_matmul.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;        // rows of x per cluster (decode M = 8)
constexpr int kCols = 64;       // output columns per cluster
constexpr int kThreads = 256;   // 8 warps: one row of x each
constexpr int kLanes = kThreads / kCols;  // threads on one column
constexpr int kLoads = 8;       // weight loads in flight per thread
constexpr int kXPer = 4;        // x vectors a lane keeps in registers
constexpr int kMaxK = 16384;    // K bytes; a block's codes: 8 x K/8
constexpr int kChunk = kMaxK / 8;
constexpr int kSplitSmallK = 1024;  // K up to this: 2 blocks a cluster,
                                    // beyond it 8

static_assert(kThreads / 32 == kRows, "a warp per row of x");
static_assert(kLanes * kCols == kThreads && kLanes <= 32 &&
                  (kLanes & (kLanes - 1)) == 0,
              "a power-of-two group of lanes per column, inside a warp");
static_assert(kSplitSmallK / 2 <= kChunk, "codes of a 2-way split fit");

template <int V> struct Vec;  // V 4-byte words of weight per load
template <> struct Vec<4> { using W = int4; using X = float4; };
template <> struct Vec<1> { using W = int; using X = float; };

__device__ __forceinline__ float absmax_of(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ float absmax_of(float v) { return fabsf(v); }

__device__ __forceinline__ int code(float v, float scale) {
  return static_cast<int>(fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f));
}

// Four codes packed as the little-endian int8 word __dp4a reads.
__device__ __forceinline__ int codes_word(float4 v, float s) {
  const uint32_t w = (code(v.x, s) & 0xffu) | ((code(v.y, s) & 0xffu) << 8) |
                     ((code(v.z, s) & 0xffu) << 16) |
                     ((code(v.w, s) & 0xffu) << 24);
  return static_cast<int>(w);
}
__device__ __forceinline__ int codes_word(float v, float s) {
  return code(v, s);  // V == 1: one code, stored as a byte
}

__device__ __forceinline__ int dot(int4 w, const int* q, int acc) {
  acc = __dp4a(q[0], w.x, acc);
  acc = __dp4a(q[1], w.y, acc);
  acc = __dp4a(q[2], w.z, acc);
  return __dp4a(q[3], w.w, acc);
}
__device__ __forceinline__ int dot(int w, const int* q, int acc) {
  return __dp4a(q[0], w, acc);
}

// Weight loads as volatile asm, so that the compiler keeps them where
// they are written: issued before the quantization and its barriers,
// and waited for only at their first use.
__device__ __forceinline__ void load_w(int4& w, const int8_t* p) {
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
               : "l"(p));
}
__device__ __forceinline__ void load_w(int& w, const int8_t* p) {
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(w) : "l"(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// V = 4: 16-byte weight loads and float4 x reads (K % 16 == 0, operands
// 16-byte aligned); V = 1: 4-byte words (any K % 4 == 0). A "unit" is V
// words of one weight row: 4V values of k. The cluster (1, S, 1) is set
// at launch; block `rank` of it owns the rank-th S-th of each row's
// units.
template <int V, int S>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ wq_t,
                   const float* __restrict__ wscale,
                   float* __restrict__ out,
                   int8_t* __restrict__ q_out,
                   float* __restrict__ scale_out,
                   const float* __restrict__ row_absmax,
                   int M, int N, int K, float absmax_floor) {
  using W = typename Vec<V>::W;
  using X = typename Vec<V>::X;
  constexpr int kMine = kCols / S;  // columns this rank dequantizes
  static_assert(kCols % S == 0, "each rank dequantizes kCols / S columns");
  __shared__ __align__(16) int8_t s_codes[kRows][kChunk];
  __shared__ float s_amax[S][kRows];          // pushed by every rank
  __shared__ int s_part[S][kRows][kMine];     // pushed by every rank
  __shared__ float s_scale[kRows];
  cg::cluster_group cluster = cg::this_cluster();
  // Remote shared memory may be written only once every block of the
  // cluster runs: arrive now, wait just before the first remote store.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;  // warp = row
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.z * kRows;
  const int cols = min(kCols, N - n0);

  // This block's units [u0, u1) of each row's K / (4V) units.
  const int units = K / (4 * V);
  const int per = (units + S - 1) / S;
  const int u0 = min(units, rank * per), u1 = min(units, u0 + per);
  const int nu = u1 - u0;
  // Thread t works on column t / kLanes of the block with the kLanes
  // lanes beside it, on units lu, lu + kLanes, ... of that column.
  const int c = threadIdx.x / kLanes, lu = threadIdx.x % kLanes;
  const bool col_ok = c < cols;
  const int8_t* wcol =
      wq_t + static_cast<size_t>(n0 + (col_ok ? c : 0)) * K + 4 * V * u0;

  // 1. Weight loads first: they are what the kernel waits for.
  W w[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int ul = lu + j * kLanes;
    if (col_ok && ul < nu) load_w(w[j], wcol + 4 * V * ul);
  }

  // 2. Warp `row` reads its row of x over this block's K (the first
  //    32 * kXPer vectors stay in registers), takes the absmax and pushes
  //    it to every rank; the cluster's max is then local.
  const int m = m0 + row, nx = nu * 4;  // X vectors of this chunk
  const X* xrow = reinterpret_cast<const X*>(
      x + static_cast<size_t>(m < M ? m : 0) * K + 4 * V * u0);
  X xv[kXPer];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = lane + 32 * i;
    if (m < M && e < nx) {
      xv[i] = __ldg(xrow + e);
      amax = fmaxf(amax, absmax_of(xv[i]));
    }
  }
  for (int e = lane + 32 * kXPer; m < M && e < nx; e += 32) {
    amax = fmaxf(amax, absmax_of(__ldg(xrow + e)));
  }
  amax = warp_max(amax);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane < S) cluster.map_shared_rank(&s_amax[0][0], lane)[rank * kRows + row] = amax;
  cluster.sync();  // every rank's absmax has arrived
  float rmax = 0.0f;
#pragma unroll
  for (int q = 0; q < S; ++q) rmax = fmaxf(rmax, s_amax[q][row]);
  if (row_absmax != nullptr) rmax = m < M ? __ldg(row_absmax + m) : 0.0f;
  const float scale = fmaxf(rmax, absmax_floor) / 127.0f;
  if (lane == 0) {
    s_scale[row] = scale;
    if (scale_out != nullptr && blockIdx.x == 0 && rank == 0 && m < M) {
      scale_out[m] = scale;
    }
  }

  // 3. This block's codes of the tile's rows (zeros past M).
  const bool codes_out = q_out != nullptr && blockIdx.x == 0 && m < M;
  int8_t* qrow = codes_out ? q_out + static_cast<size_t>(m) * K + 4 * V * u0
                           : nullptr;
  auto put = [&](int e, int word) {
    if constexpr (V == 4) {
      reinterpret_cast<int*>(s_codes[row])[e] = word;
      if (codes_out) reinterpret_cast<int*>(qrow)[e] = word;
    } else {
      s_codes[row][e] = static_cast<int8_t>(word);
      if (codes_out) qrow[e] = static_cast<int8_t>(word);
    }
  };
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = lane + 32 * i;
    if (e < nx) put(e, m < M ? codes_word(xv[i], scale) : 0);
  }
  for (int e = lane + 32 * kXPer; e < nx; e += 32) {
    put(e, m < M ? codes_word(__ldg(xrow + e), scale) : 0);
  }
  __syncthreads();

  // 4. __dp4a of this thread's units against the 8 rows' codes, summed
  //    in registers, then over the column's kLanes lanes by shuffles
  //    (integer adds: any order is exact).
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  for (int j0 = 0; j0 * kLanes < nu; j0 += kLoads) {
    if (j0 > 0) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int ul = lu + (j0 + j) * kLanes;
        if (col_ok && ul < nu) load_w(w[j], wcol + 4 * V * ul);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int ul = lu + (j0 + j) * kLanes;
      if (col_ok && ul < nu) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = dot(w[j], reinterpret_cast<const int*>(
                                 s_codes[r] + 4 * V * ul), acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
  }

  // 5. Push the partial sums to the rank that dequantizes the column;
  //    after the barrier each rank sums its columns' S partials locally
  //    (no remote access follows, so blocks may leave at once).
  if (lu == 0) {
    int* dst = cluster.map_shared_rank(&s_part[0][0][0], c / kMine);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      dst[(rank * kRows + r) * kMine + c % kMine] = acc[r];  // 0 past N
    }
  }
  cluster.sync();
  for (int o = threadIdx.x; o < kRows * kMine; o += kThreads) {
    const int r = o / kMine, cl = o % kMine;
    const int mo = m0 + r, n = n0 + rank * kMine + cl;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < S; ++q) sum += s_part[q][r][cl];
    if (mo < M && n < N) {
      out[static_cast<size_t>(mo) * N + n] =
          __int2float_rn(sum) * s_scale[r] * wscale[n];
    }
  }
}

// A launch with the cluster (1, S, 1) set at run time.
template <int V, int S>
int launch(const float* x, const int8_t* wq_t, const float* wscale,
           float* out, int8_t* q_out, float* scale_out,
           const float* row_absmax, int M, int N, int K, float absmax_floor,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols, S, (M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, int8_matmul_kernel<V, S>, x, wq_t, wscale, out,
                         q_out, scale_out, row_absmax, M, N, K,
                         absmax_floor);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The K split: S blocks a cluster, chosen by K. A block's codes (8 x
// K / S bytes) fit kChunk.
template <int V>
int launch_split(const float* x, const int8_t* wq_t, const float* wscale,
                 float* out, int8_t* q_out, float* scale_out,
                 const float* row_absmax, int M, int N, int K,
                 float absmax_floor, cudaStream_t stream) {
  if (K <= kSplitSmallK) {
    return launch<V, 2>(x, wq_t, wscale, out, q_out, scale_out, row_absmax,
                        M, N, K, absmax_floor, stream);
  }

  return launch<V, 8>(x, wq_t, wscale, out, q_out, scale_out, row_absmax, M,
                      N, K, absmax_floor, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 =
// launched). q_out (M, K) int8 and scale_out (M,) f32 may be null; when
// given, the kernel also stores the activation codes and scales it
// computed. row_absmax (M,) f32 may be null (each row's absmax is taken
// over its K values); when given, it is the absmax each row's scale is
// computed from.
int dmp_int8_matmul(const float* x, const int8_t* wq_t, const float* wscale,
                    float* out, int8_t* q_out, float* scale_out,
                    const float* row_absmax, int M, int N, int K,
                    float absmax_floor, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (K & 3) != 0 || K > kMaxK ||
      (M + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = K % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq_t) % 16 == 0 &&
                   (q_out == nullptr ||
                    reinterpret_cast<uintptr_t>(q_out) % 16 == 0);
  return vec ? launch_split<4>(x, wq_t, wscale, out, q_out, scale_out,
                               row_absmax, M, N, K, absmax_floor, stream)
             : launch_split<1>(x, wq_t, wscale, out, q_out, scale_out,
                               row_absmax, M, N, K, absmax_floor, stream);
}

// The largest K the kernel takes, so the wrapper can refuse a larger one
// before launching.
int dmp_int8_matmul_max_k(void) { return kMaxK; }

}  // extern "C"
