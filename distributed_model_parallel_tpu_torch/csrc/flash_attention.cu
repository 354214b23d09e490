// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// `ops/pallas_attention.py`:
//   K1 flash_fwd_kernel      <- _fwd_kernel / _flash_step   (pallas_call :260)
//   K2 flash_bwd_dq_kernel   <- _bwd_dq_step               (pallas_call :420)
//   K3 flash_bwd_dkv_kernel  <- _bwd_dkv_step              (pallas_call :459)
// with the same function, written anew for the card (nothing is carried
// over block by block):
//   s   = scale * q @ k^T  (f32 sums of exact f32 products; bf16 inputs
//         are widened to f32, as the MXU's bf16 x bf16 -> f32)
//   masked logits (key mask, causal row < col) = FLT_MIN_NEG (finfo.min,
//   never -inf); p = 0 where s == FLT_MIN_NEG; online softmax in f32;
//   p is rounded to v's dtype before P @ V; out = acc / (l > 0 ? l : 1)
//   in q's dtype; LSE = m + log(l), or +inf for a row with no valid key
//   (its out is 0, and the backward's exp(s - LSE) gives it zero grads).
//   K2: p = exp(s - LSE), dS = p * (dO @ V^T - delta), dq = scale*dS@K
//   K3: dv = p^T @ dO, dk = scale * dS^T @ Q
// delta = rowsum(dO * O) is computed outside (plain torch), as the
// reference computes it outside Pallas. LSE is stored (B, H, Tq) f32,
// not the reference's 128-lane broadcast (a TPU layout artifact).
//
// What bounds them on an H100: in causal training at GPT-2-small width
// (B 8, T 1024, H 12, Dh 64) each kernel touches a few MB (q, k, v, dO
// and the outputs, read once) but does 4*Dh (K1), 6*Dh (K2) or 8*Dh (K3)
// flops per visible (q, k) pair, ~13-26 GFLOP per call: operations bound,
// ~0.2-0.4 ms at the 67 TFLOP/s f32 rate outside the tensor cores (f32
// inputs) and ~0.01-0.03 ms at the 989 TFLOP/s bf16 tensor-core rate.
//
// What this simple design does about it: nothing O(T^2) leaves the SM —
// each block keeps one tile of rows in registers (q / dO, or k / v for
// K3) and streams the other side's tiles through shared memory, skipping
// tiles wholly above the causal frontier (about half of them). The math
// is scalar f32 FMAs: four threads share a row, each owning Dh/4 of its
// columns as float4s, so one 16-byte shared-memory broadcast feeds four
// FMAs, and row dots reduce with two lane shuffles. It does not use the
// tensor cores (mma.sync / wgmma) or TMA/cp.async double buffering: both
// are later work, and bf16 runs at the f32 scalar rate here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf/logf stay accurate).
// ABI: plain C, bound with ctypes by ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr unsigned kFull = 0xffffffffu;

// One (B, T, H, Dh) operand: base pointer and element strides of its
// batch, sequence and head axes (the Dh axis is contiguous).
struct Operand {
  const void* p;
  long long sb, st, sh;
};

struct Args {
  Operand q, k, v, g;        // g = dO (backward only)
  const uint8_t* mask;       // (B, Tk) key validity, or null
  const float* lse_in;       // (B, H, Tq) (backward)
  const float* delta;        // (B, H, Tq) (backward)
  void* out0;                // out | dq | dk, contiguous (B, T, H, Dh)
  void* out1;                // dv
  float* lse_out;            // (B, H, Tq) or null (forward)
  int Tq, Tk, H;
  float scale;
  int causal;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the reference's `.astype(v.dtype)` before a
// product): identity for f32, round-to-nearest-even for bf16.
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ const char* row_ptr(const Operand& o, int b,
                                               int t, int h, int esize) {
  return static_cast<const char*>(o.p) +
         (static_cast<long long>(b) * o.sb + static_cast<long long>(t) * o.st +
          static_cast<long long>(h) * o.sh) * esize;
}

// This thread's Dh/4 columns of one row: float4 chunks part, part+4, ...
// (so the four threads of a row read 64 contiguous bytes together).
template <typename T, int D>
__device__ __forceinline__ void load_slice(const Operand& o, int b, int t,
                                           int h, int part, float4* dst) {
  const T* r = reinterpret_cast<const T*>(row_ptr(o, b, t, h, sizeof(T)));
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    const int c = 4 * (part + 4 * f);
    dst[f] = make_float4(to_f(r[c]), to_f(r[c + 1]), to_f(r[c + 2]),
                         to_f(r[c + 3]));
  }
}

// A tile of `rows` rows starting at t0 into shared memory as f32; rows
// past `limit` are zeros.
template <typename T, int D, int TILE>
__device__ __forceinline__ void load_tile(const Operand& o, int b, int t0,
                                          int limit, int h, float* dst) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    const int t = t0 + j;
    float x = 0.0f;
    if (t < limit) {
      x = to_f(reinterpret_cast<const T*>(row_ptr(o, b, t, h, sizeof(T)))[d]);
    }
    dst[idx] = x;
  }
}

// Dot of this thread's slice with row j of a shared tile, summed over
// the row's four threads (adjacent lanes).
template <int D>
__device__ __forceinline__ float row_dot(const float4* mine,
                                         const float4* tile_row, int part) {
  float acc = 0.0f;
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    const float4 t = tile_row[part + 4 * f];
    acc = fmaf(mine[f].x, t.x, acc);
    acc = fmaf(mine[f].y, t.y, acc);
    acc = fmaf(mine[f].z, t.z, acc);
    acc = fmaf(mine[f].w, t.w, acc);
  }
  acc += __shfl_xor_sync(kFull, acc, 1);
  acc += __shfl_xor_sync(kFull, acc, 2);
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy(float a, const float4* tile_row,
                                     int part, float4* acc) {
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    const float4 t = tile_row[part + 4 * f];
    acc[f].x = fmaf(a, t.x, acc[f].x);
    acc[f].y = fmaf(a, t.y, acc[f].y);
    acc[f].z = fmaf(a, t.z, acc[f].z);
    acc[f].w = fmaf(a, t.w, acc[f].w);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_slice(T* base, int b, int t, int h,
                                            int H, int T_len, int part,
                                            const float4* src, float mul) {
  T* r = base + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    const int c = 4 * (part + 4 * f);
    r[c] = from_f<T>(src[f].x * mul);
    r[c + 1] = from_f<T>(src[f].y * mul);
    r[c + 2] = from_f<T>(src[f].z * mul);
    r[c + 3] = from_f<T>(src[f].w * mul);
  }
}

// ---------------------------------------------------------------- K1
// One block per (q tile of TILE rows, head, batch); 4 threads per row.
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(4 * TILE) flash_fwd_kernel(Args a) {
  __shared__ float4 kS[TILE][D / 4];
  __shared__ float4 vS[TILE][D / 4];
  __shared__ float mS[TILE];
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TILE, row = q0 + r;
  const bool live = row < a.Tq;

  float4 qr[D / 16], acc[D / 16];
  load_slice<T, D>(a.q, b, live ? row : a.Tq - 1, h, part, qr);
#pragma unroll
  for (int f = 0; f < D / 16; ++f) acc[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNeg, l = 0.0f;

  // Causal tile skipping: key tiles starting past this tile's last row
  // are fully masked for every row of the block.
  const int k_end = a.causal ? min(a.Tk, q0 + TILE) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D, TILE>(a.k, b, k0, a.Tk, h, &kS[0][0].x);
    load_tile<T, D, TILE>(a.v, b, k0, a.Tk, h, &vS[0][0].x);
    for (int j = threadIdx.x; j < TILE; j += blockDim.x) {
      const int key = k0 + j;
      mS[j] = (key < a.Tk &&
               (a.mask == nullptr ||
                a.mask[static_cast<long long>(b) * a.Tk + key]))
                  ? 1.0f : 0.0f;
    }
    __syncthreads();

    float s[TILE];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float x = row_dot<D>(qr, kS[j], part) * a.scale;
      if (mS[j] == 0.0f || (a.causal && row < k0 + j)) x = kNeg;
      s[j] = x;
      m_new = fmaxf(m_new, x);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int f = 0; f < D / 16; ++f) {
      acc[f].x *= corr; acc[f].y *= corr; acc[f].z *= corr; acc[f].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      // A row masked in every tile so far has m_new == kNeg and would
      // get exp(0) == 1 on its masked entries: those are zeroed.
      const float p = s[j] == kNeg ? 0.0f : expf(s[j] - m_new);
      l += p;
      axpy<D>(round_as<T>(p), vS[j], part, acc);
    }
    m = m_new;
  }

  if (live) {
    const float denom = l > 0.0f ? l : 1.0f;
#pragma unroll
    for (int f = 0; f < D / 16; ++f) {
      acc[f].x /= denom; acc[f].y /= denom; acc[f].z /= denom;
      acc[f].w /= denom;
    }
    store_slice<T, D>(static_cast<T*>(a.out0), b, row, h, a.H, a.Tq, part,
                      acc, 1.0f);
    if (a.lse_out != nullptr && part == 0) {
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Tq + row] =
          l > 0.0f ? m + logf(denom) : INFINITY;
    }
  }
}

// ---------------------------------------------------------------- K2
// One block per (q tile, head, batch), looping over key tiles.
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(4 * TILE) flash_bwd_dq_kernel(Args a) {
  __shared__ float4 kS[TILE][D / 4];
  __shared__ float4 vS[TILE][D / 4];
  __shared__ float mS[TILE];
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TILE, row = q0 + r;
  const bool live = row < a.Tq;
  const int crow = live ? row : a.Tq - 1;

  float4 qr[D / 16], gr[D / 16], acc[D / 16];
  load_slice<T, D>(a.q, b, crow, h, part, qr);
  load_slice<T, D>(a.g, b, crow, h, part, gr);
#pragma unroll
  for (int f = 0; f < D / 16; ++f) acc[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Tq + crow;
  const float lse = live ? a.lse_in[stat] : INFINITY;
  const float delta = a.delta[stat];

  const int k_end = a.causal ? min(a.Tk, q0 + TILE) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile<T, D, TILE>(a.k, b, k0, a.Tk, h, &kS[0][0].x);
    load_tile<T, D, TILE>(a.v, b, k0, a.Tk, h, &vS[0][0].x);
    for (int j = threadIdx.x; j < TILE; j += blockDim.x) {
      const int key = k0 + j;
      mS[j] = (key < a.Tk &&
               (a.mask == nullptr ||
                a.mask[static_cast<long long>(b) * a.Tk + key]))
                  ? 1.0f : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float x = row_dot<D>(qr, kS[j], part) * a.scale;
      if (mS[j] == 0.0f || (a.causal && row < k0 + j)) x = kNeg;
      const float p = expf(x - lse);  // +inf LSE -> 0
      const float dp = row_dot<D>(gr, vS[j], part);
      const float ds = p * (dp - delta);
      axpy<D>(round_as<T>(ds), kS[j], part, acc);
    }
  }
  if (live) {
    store_slice<T, D>(static_cast<T*>(a.out0), b, row, h, a.H, a.Tq, part,
                      acc, a.scale);
  }
}

// ---------------------------------------------------------------- K3
// One block per (key tile of TILE keys, head, batch), looping over query
// tiles from the first one at or below the causal frontier.
template <typename T, int D, int TILE>
__global__ void __launch_bounds__(4 * TILE) flash_bwd_dkv_kernel(Args a) {
  __shared__ float4 qS[TILE][D / 4];
  __shared__ float4 gS[TILE][D / 4];
  __shared__ float lS[TILE];
  __shared__ float dS[TILE];
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * TILE, key = k0 + r;
  const bool live = key < a.Tk;

  float4 kr[D / 16], vr[D / 16], dk[D / 16], dv[D / 16];
  load_slice<T, D>(a.k, b, live ? key : a.Tk - 1, h, part, kr);
  load_slice<T, D>(a.v, b, live ? key : a.Tk - 1, h, part, vr);
#pragma unroll
  for (int f = 0; f < D / 16; ++f) {
    dk[f] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool valid =
      live && (a.mask == nullptr ||
               a.mask[static_cast<long long>(b) * a.Tk + key]);
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.Tq;

  // Query tiles whose last row is before k0 see only masked pairs.
  for (int q0 = a.causal ? k0 : 0; q0 < a.Tq; q0 += TILE) {
    __syncthreads();
    load_tile<T, D, TILE>(a.q, b, q0, a.Tq, h, &qS[0][0].x);
    load_tile<T, D, TILE>(a.g, b, q0, a.Tq, h, &gS[0][0].x);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const int row = q0 + i;
      lS[i] = row < a.Tq ? a.lse_in[stat0 + row] : INFINITY;
      dS[i] = row < a.Tq ? a.delta[stat0 + row] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      float x = row_dot<D>(kr, qS[i], part) * a.scale;
      if (!valid || (a.causal && q0 + i < key)) x = kNeg;
      const float p = expf(x - lS[i]);
      axpy<D>(round_as<T>(p), gS[i], part, dv);
      const float dp = row_dot<D>(vr, gS[i], part);
      const float ds = p * (dp - dS[i]);
      axpy<D>(round_as<T>(ds), qS[i], part, dk);
    }
  }
  if (live) {
    store_slice<T, D>(static_cast<T*>(a.out0), b, key, h, a.H, a.Tk, part,
                      dk, a.scale);
    store_slice<T, D>(static_cast<T*>(a.out1), b, key, h, a.H, a.Tk, part,
                      dv, 1.0f);
  }
}

template <typename T, int D, int TILE>
int launch(int which, const Args& a, int B, cudaStream_t stream) {
  const int rows = which == 2 ? a.Tk : a.Tq;
  const dim3 grid((rows + TILE - 1) / TILE, a.H, B);
  const dim3 block(4 * TILE);
  if (which == 0) {
    flash_fwd_kernel<T, D, TILE><<<grid, block, 0, stream>>>(a);
  } else if (which == 1) {
    flash_bwd_dq_kernel<T, D, TILE><<<grid, block, 0, stream>>>(a);
  } else {
    flash_bwd_dkv_kernel<T, D, TILE><<<grid, block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The (Dh, TILE) pairs built: shared memory is 2 * TILE * Dh * 4 bytes
// of f32 tiles, inside the 48 KB static limit. Dh 64 (GPT-2 small) has
// two tiles, for the tile sweep; ops/flash_attention.py's TILES lists
// the same pairs.
template <typename T>
int dispatch(int which, const Args& a, int B, int D, int tile,
             cudaStream_t stream) {
#define DMP_CASE(DD, TT)                                  \
  if (D == DD && tile == TT) return launch<T, DD, TT>(which, a, B, stream);
  DMP_CASE(16, 64) DMP_CASE(32, 64) DMP_CASE(64, 32) DMP_CASE(64, 64)
  DMP_CASE(128, 32)
#undef DMP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

Operand operand(const void* p, const long long* s) {
  return Operand{p, s[0], s[1], s[2]};
}

int run(int which, const Args& a, int B, int D, int tile, int bf16,
        cudaStream_t stream) {
  if (B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? dispatch<__nv_bfloat16>(which, a, B, D, tile, stream)
              : dispatch<float>(which, a, B, D, tile, stream);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 =
// launched). `strides` holds (batch, seq, head) element strides per
// (B, T, H, Dh) operand, in the order the operands are listed. Outputs
// are contiguous (B, T, H, Dh); lse/delta are contiguous (B, H, Tq) f32.

int dmp_flash_fwd(const void* q, const void* k, const void* v,
                  const long long* strides, const uint8_t* mask, void* out,
                  float* lse, int B, int Tq, int Tk, int H, int D, int tile,
                  int bf16, float scale, int causal, cudaStream_t stream) {
  Args a{};
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.mask = mask;
  a.out0 = out;
  a.lse_out = lse;
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.scale = scale; a.causal = causal;
  return run(0, a, B, D, tile, bf16, stream);
}

int dmp_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* g, const long long* strides,
                     const uint8_t* mask, const float* lse,
                     const float* delta, void* dq, int B, int Tq, int Tk,
                     int H, int D, int tile, int bf16, float scale,
                     int causal, cudaStream_t stream) {
  Args a{};
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.g = operand(g, strides + 9);
  a.mask = mask;
  a.lse_in = lse;
  a.delta = delta;
  a.out0 = dq;
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.scale = scale; a.causal = causal;
  return run(1, a, B, D, tile, bf16, stream);
}

int dmp_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* g, const long long* strides,
                      const uint8_t* mask, const float* lse,
                      const float* delta, void* dk, void* dv, int B, int Tq,
                      int Tk, int H, int D, int tile, int bf16, float scale,
                      int causal, cudaStream_t stream) {
  Args a{};
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.g = operand(g, strides + 9);
  a.mask = mask;
  a.lse_in = lse;
  a.delta = delta;
  a.out0 = dk;
  a.out1 = dv;
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.scale = scale; a.causal = causal;
  return run(2, a, B, D, tile, bf16, stream);
}

}  // extern "C"
