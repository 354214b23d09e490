// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// `ops/pallas_attention.py`:
//   K1 flash_fwd_kernel      <- _fwd_kernel / _flash_step   (pallas_call :260)
//   K2 flash_bwd_dq_kernel   <- _bwd_dq_step               (pallas_call :420)
//   K3 flash_bwd_dkv_kernel  <- _bwd_dkv_step              (pallas_call :459)
// with the same function, written anew for the card (nothing is carried
// over block by block):
//   s   = scale * q @ k^T  (f32 sums of exact products: bf16 x bf16 -> f32
//         as the MXU's, f32 x f32 in full f32)
//   masked logits (key mask, causal row < col) = FLT_MIN_NEG (finfo.min,
//   never -inf); p = 0 where s == FLT_MIN_NEG; online softmax in f32;
//   p is rounded to v's dtype before P @ V; out = acc / (l > 0 ? l : 1)
//   in q's dtype; LSE = m + log(l), or +inf for a row with no valid key
//   (its out is 0, and the backward's exp(s - LSE) gives it zero grads).
//   K2: p = exp(s - LSE), dS = p * (dO @ V^T - delta), dq = scale*dS@K
//       (dS rounded to k's dtype before the product)
//   K3: dv = p^T @ dO, dk = scale * dS^T @ Q
// delta = rowsum(dO * O) is computed outside (plain torch), as the
// reference computes it outside Pallas. LSE is stored (B, H, Tq) f32,
// not the reference's 128-lane broadcast (a TPU layout artifact).
//
// What bounds them on an H100: in causal training at GPT-2-small width
// (B 8, T 1024, H 12, Dh 64) each kernel touches a few MB (q, k, v, dO
// and the outputs, read once) but does 4*Dh (K1), 6*Dh (K2) or 8*Dh (K3)
// flops per visible (q, k) pair, ~13-26 GFLOP per call: operations bound,
// 0.19 / 0.29 / 0.385 ms at the 67 TFLOP/s f32 rate outside the tensor
// cores (f32 inputs) and 0.015 / 0.020 / 0.026 ms at the 989 TFLOP/s
// bf16 tensor-core rate (K1's bf16 bound is its bytes).
//
// K1 and K2 (flash_fwd_kernel<T, D, ROWS, KEYS>, flash_bwd_dq_kernel<...>).
// A block of ROWS/16 warps owns ROWS query rows, 16 a warp, and loops
// over key tiles of KEYS keys up to the causal frontier. The q tile (and
// dO for K2) is copied into shared memory once; K and V tiles arrive by
// 16-byte cp.async copies into a 2-stage ring, the next tile's copy
// issued before the current tile's math. Shared rows are padded by 16
// bytes, so the 8 rows an ldmatrix (or a float4 load) reads fall in 8
// different bank groups. Per-element masking runs only on tiles that
// cross the diagonal or hold an invalid key (a block-wide vote as the
// tile arrives); a warp whose rows all lie before a tile skips it (its
// p would be 0 everywhere, so skipping changes no bit).
//   bf16: mma.sync.m16n8k16 (bf16 x bf16 -> f32), the MXU's contract
//   exactly. q (and dO) stay in registers as A fragments (ldmatrix); S
//   and dP accumulate in registers; scale, masks and the online softmax
//   run in f32 on the accumulator fragments (4 lanes share a row); p or
//   dS is rounded to bf16 in registers and fed back as the A operand of
//   P @ V or dS @ K, whose B operand is read with ldmatrix.trans. As p
//   and dS are rounded to bf16 (2^-8) right away, they are taken from
//   the hardware exp2 (__expf, relative error ~2^-21); the rescale
//   factor exp(m - m_new), which l (and so the LSE) accumulates, keeps
//   the accurate expf.
//   f32: no TF32 (the reference's logits are full f32). Each thread owns
//   a 4-row x KEYS/8-key micro-tile of S (and dP) built by FFMA from the
//   f32 shared tiles: one float4 of q and KEYS/8 float4s of k feed
//   2*KEYS FMAs. p (dS) passes through a per-warp shared tile for the
//   second product, micro-tiled 4 rows x Dh/8 columns the same way.
// mma.sync with cp.async was chosen over wgmma with TMA: it needs no
// warp specialisation or mbarrier protocol, and its fragments map onto
// the per-row softmax directly. On one H100 at the training shape above
// bf16 K1 / K2 take 0.137 / 0.147 ms a launch (bounds 0.015 / 0.020)
// and f32 0.580 / 0.735 ms (bounds 0.19 / 0.29; PERF.md). What remains
// between them and their bounds: each warp reads
// all of a K/V tile through ldmatrix for its 16 rows (32 rows a warp
// would halve that), the softmax's instruction count (the f32 kernels
// keep the accurate expf), wgmma and TMA, and a persistent grid.
//
// K3 (flash_bwd_dkv_kernel<T, D, KEYS, ROWS>), the same building blocks
// with the roles of rows and keys swapped. A block of KEYS/16 warps owns
// KEYS keys, 16 a warp, of one (batch, head); its K and V rows are
// copied once, and q and dO tiles of ROWS rows stream through a 2-stage
// cp.async ring from the q tile that holds the block's first key (when
// causal) to Tq, with each tile's LSE and delta (+inf and 0 past Tq)
// loaded into registers before the previous tile's math and stored into
// shared memory beside it. Per-element masking runs only on tiles that
// cross the diagonal or hold an invalid key (a warp vote on its keys;
// rows past Tq need none, their p is exp(-inf) = 0); a warp whose keys
// all lie after a tile's last row skips it. Key tiles run on blockIdx.z,
// the slowest grid axis, so under causal masking the heaviest tiles
// (the first keys, seen by every later q tile) start first.
//   bf16: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on mma.sync (the q / dO tile as the
//   B operand, by ldmatrix), scale and masks on the accumulators, Pᵀ =
//   exp(Sᵀ − LSE[col]) (__expf: p is rounded to bf16 at once), dSᵀ = Pᵀ ∘
//   (dPᵀ − delta[col]); then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ / dSᵀ
//   rounded to bf16 in registers as the A operand and dO / Q read by
//   ldmatrix.trans. K and V stay resident as A fragments up to Dh 64
//   (32 registers at Dh 64); at Dh 128 they are re-read from shared
//   memory per tile, as resident they would not fit beside the 128
//   registers of the dK / dV accumulators.
//   f32: each thread owns 4 keys x ROWS/8 q columns of Sᵀ and dPᵀ (FFMA
//   micro-tiles from the shared K / V rows and q / dO tiles, accurate
//   expf), and 4 keys x Dh/8 columns of dK and dV, fed through the
//   warp's rows of two shared p / dS tiles.
//   dk is multiplied by `scale` once, at the end, as the port's plain
//   version does (the reference scales each tile's product; both are
//   inside FLASH_TOL). Key rows past Tk are zero-filled and never stored.
// On one H100 80GB HBM3 (700 W) at the training shape K3 takes 0.161
// ms a launch in bf16 (64 keys x 64 rows; bound 0.026) and 0.814 ms in
// f32 (128 x 64; bound 0.385), from 1.630 / 1.589 in PR 2's scalar
// design (PERF.md). What
// remains: as for K1 / K2, and in f32 the default tile's 209 KB of
// shared memory leave one block of 8 warps an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf/logf stay accurate
//        where they are written so).
// ABI: plain C, bound with ctypes by ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
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

__device__ __forceinline__ const char* row_ptr(const Operand& o, int b,
                                               int t, int h, int esize) {
  return static_cast<const char*>(o.p) +
         (static_cast<long long>(b) * o.sb + static_cast<long long>(t) * o.st +
          static_cast<long long>(h) * o.sh) * esize;
}

__device__ __forceinline__ bool key_valid(const Args& a, int b, int key) {
  return key < a.Tk &&
         (a.mask == nullptr ||
          a.mask[static_cast<long long>(b) * a.Tk + key] != 0);
}

// ------------------------------------------------- K1/K2 building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared row stride, in elements: Dh plus 16 bytes.
template <typename T, int D> __host__ __device__ constexpr int row_ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Rows t0 .. t0+ROWS-1 of one (b, h) slice of an operand into shared
// memory; rows at or past `limit` are zeros. 16-byte chunks, adjacent
// threads on adjacent chunks of a row.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void copy_tile(const Operand& o, int b, int t0,
                                          int limit, int h, T* dst) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int LD = row_ld<T, D>();
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool valid = t0 + r < limit;
    const char* src = row_ptr(o, b, valid ? t0 + r : 0, h, sizeof(T)) + 16 * c;
    cp_async16(dst + r * LD + c * kPer, src, valid);
  }
}

// Shared memory of K1 (kGrad false) and K2: the resident rows (q, and
// dO), a 2-stage ring of K tiles, one of V tiles, and for f32 the
// per-warp p / dS tile.
template <typename T, int D, int ROWS, int KEYS, bool kGrad>
__host__ __device__ constexpr int smem_bytes() {
  return ((kGrad ? 2 : 1) * ROWS + 4 * KEYS) * row_ld<T, D>() *
             static_cast<int>(sizeof(T)) +
         (std::is_same<T, float>::value ? ROWS * (KEYS + 4) * 4 : 0);
}

// Key tiles a block of query rows [q0, q0 + ROWS) visits: tiles starting
// past its last row are fully masked for every row when causal.
template <int ROWS, int KEYS>
__device__ __forceinline__ int key_tiles(const Args& a, int q0) {
  const int k_end = a.causal ? min(a.Tk, q0 + ROWS) : a.Tk;
  return (k_end + KEYS - 1) / KEYS;
}

// Copies the resident rows and key tile 0 (one cp.async group); returns
// this thread's validity of key threadIdx.x of tile 0.
template <typename T, int D, int ROWS, int KEYS, bool kGrad>
__device__ __forceinline__ bool stream_begin(const Args& a, int b, int h,
                                             int q0, T* sRows, T* sK,
                                             T* sV) {
  copy_tile<T, D, ROWS>(a.q, b, q0, a.Tq, h, sRows);
  if (kGrad) {
    copy_tile<T, D, ROWS>(a.g, b, q0, a.Tq, h, sRows + ROWS * row_ld<T, D>());
  }
  copy_tile<T, D, KEYS>(a.k, b, 0, a.Tk, h, sK);
  copy_tile<T, D, KEYS>(a.v, b, 0, a.Tk, h, sV);
  cp_async_commit();
  return threadIdx.x >= KEYS || key_valid(a, b, threadIdx.x);
}

// Start of key tile `it`: issues the next tile's copy into the other
// stage, publishes this tile's key validity in sMask, waits for this
// tile's copy and returns whether every key of the tile is valid (a
// block-wide vote, which is also the barrier after the copy).
template <typename T, int D, int KEYS>
__device__ __forceinline__ bool tile_start(const Args& a, int b, int h,
                                           int it, int tiles, T* sK, T* sV,
                                           unsigned char* sMask,
                                           bool& next_ok) {
  constexpr int LD = row_ld<T, D>();
  const int k0 = it * KEYS;
  const bool more = it + 1 < tiles;
  if (more) {
    const int nxt = (it + 1) & 1;
    copy_tile<T, D, KEYS>(a.k, b, k0 + KEYS, a.Tk, h, sK + nxt * KEYS * LD);
    copy_tile<T, D, KEYS>(a.v, b, k0 + KEYS, a.Tk, h, sV + nxt * KEYS * LD);
    cp_async_commit();
  }
  const bool ok = next_ok;
  if (threadIdx.x < KEYS) {
    sMask[threadIdx.x] = ok;
    if (more) next_ok = key_valid(a, b, k0 + KEYS + threadIdx.x);
  }
  if (more) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  return __syncthreads_and(ok) != 0;
}

// ------------------------------------------------------ bf16: mma.sync

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of this warp's 16 rows of a resident shared tile.
template <int D>
__device__ __forceinline__ void load_rows_frags(uint32_t (&f)[D / 16][4],
                                                const bf16* s, int lane) {
  constexpr int LD = row_ld<bf16, D>();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(f[kk], s + (lane & 15) * LD + 16 * kk + 8 * (lane >> 4));
  }
}

// acc (16 rows x KEYS keys) = A (16 x Dh, fragments) @ tile^T, the tile
// KEYS x Dh in shared memory (keys as B columns).
template <int D, int KEYS>
__device__ __forceinline__ void mma_abt(float (&acc)[KEYS / 8][4],
                                        const uint32_t (&af)[D / 16][4],
                                        const bf16* tile, int lane) {
  constexpr int LD = row_ld<bf16, D>();
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < KEYS / 16; ++np) {
      uint32_t f[4];
      ldsm_x4(f, tile + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD +
                     16 * kk + 8 * ((lane >> 3) & 1));
      mma(acc[2 * np], af[kk], f[0], f[1]);
      mma(acc[2 * np + 1], af[kk], f[2], f[3]);
    }
  }
}

// acc (16 rows x Dh) += P (16 x KEYS, f32 accumulator fragments rounded
// to bf16) @ tile, the tile KEYS x Dh in shared memory.
template <int D, int KEYS>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&p)[KEYS / 8][4],
                                       const bf16* tile, int lane) {
  constexpr int LD = row_ld<bf16, D>();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldsm_x4_t(f, tile + (16 * kk + (lane & 15)) * LD + 16 * dp +
                       8 * (lane >> 4));
      mma(acc[2 * dp], pa, f[0], f[1]);
      mma(acc[2 * dp + 1], pa, f[2], f[3]);
    }
  }
}

// Scale the accumulator logits; on an edge tile set masked ones (invalid
// key, or causal row < key) to kNeg. Element e of n-tile j sits at row
// row0 + 8 * (e >> 1), tile key 8 * j + 2 * t4 + (e & 1).
template <int KEYS>
__device__ __forceinline__ void logits_mma(float (&s)[KEYS / 8][4],
                                           const Args& a, bool edge,
                                           const unsigned char* sMask,
                                           int k0, int row0, int t4) {
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * a.scale;
      if (edge) {
        const int kl = 8 * j + 2 * t4 + (e & 1);
        if (!sMask[kl] || (a.causal && row0 + 8 * (e >> 1) < k0 + kl)) {
          x = kNeg;
        }
      }
      s[j][e] = x;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int D, int ROWS, int KEYS>
__device__ __forceinline__ void fwd_mma(const Args& a, char* smem) {
  constexpr int LD = row_ld<bf16, D>();
  __shared__ unsigned char sMask[KEYS];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + ROWS * LD;
  bf16* sV = sK + 2 * KEYS * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int w0 = q0 + 16 * warp;  // this warp's first row
  const int tiles = key_tiles<ROWS, KEYS>(a, q0);
  bool next_ok =
      stream_begin<bf16, D, ROWS, KEYS, false>(a, b, h, q0, sQ, sK, sV);

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < tiles; ++it) {
    const bool full =
        tile_start<bf16, D, KEYS>(a, b, h, it, tiles, sK, sV, sMask, next_ok);
    const int k0 = it * KEYS;
    if (it == 0) load_rows_frags<D>(qf, sQ + 16 * warp * LD, lane);
    if (!(a.causal && k0 > w0 + 15)) {
      const bf16* kT = sK + (it & 1) * KEYS * LD;
      const bf16* vT = sV + (it & 1) * KEYS * LD;
      float s[KEYS / 8][4];
      mma_abt<D, KEYS>(s, qf, kT, lane);
      const bool edge = !full || (a.causal && k0 + KEYS - 1 > w0);
      logits_mma<KEYS>(s, a, edge, sMask, k0, w0 + g, t4);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      const float c0 = expf(m[0] - mx[0]), c1 = expf(m[1] - mx[1]);
      l[0] *= c0;
      l[1] *= c1;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][0] *= c0; o[dt][1] *= c0; o[dt][2] *= c1; o[dt][3] *= c1;
      }
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // A row masked in every tile so far has mx == kNeg and would
          // get exp(0) == 1 on its masked entries: those are zeroed.
          const float p =
              s[j][e] == kNeg ? 0.0f : __expf(s[j][e] - mx[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }
      }
      m[0] = mx[0];
      m[1] = mx[1];
      mma_pb<D, KEYS>(o, s, vT, lane);
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = w0 + g + 8 * r;
    if (row >= a.Tq) continue;
    const float denom = lr > 0.0f ? lr : 1.0f;
    bf16* out = static_cast<bf16*>(a.out0) +
                ((static_cast<long long>(b) * a.Tq + row) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + 8 * dt + 2 * t4) =
          pack_bf16(o[dt][2 * r] / denom, o[dt][2 * r + 1] / denom);
    }
    if (a.lse_out != nullptr && t4 == 0) {
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Tq + row] =
          lr > 0.0f ? m[r] + logf(denom) : INFINITY;
    }
  }
}

template <int D, int ROWS, int KEYS>
__device__ __forceinline__ void dq_mma(const Args& a, char* smem) {
  constexpr int LD = row_ld<bf16, D>();
  __shared__ unsigned char sMask[KEYS];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + ROWS * LD;
  bf16* sK = sG + ROWS * LD;
  bf16* sV = sK + 2 * KEYS * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int w0 = q0 + 16 * warp;
  const int tiles = key_tiles<ROWS, KEYS>(a, q0);
  bool next_ok =
      stream_begin<bf16, D, ROWS, KEYS, true>(a, b, h, q0, sQ, sK, sV);

  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.Tq + row;
    lse[r] = row < a.Tq ? a.lse_in[stat] : INFINITY;  // +inf -> p = 0
    dl[r] = row < a.Tq ? a.delta[stat] : 0.0f;
  }
  uint32_t qf[D / 16][4], gf[D / 16][4];
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.0f;

  for (int it = 0; it < tiles; ++it) {
    const bool full =
        tile_start<bf16, D, KEYS>(a, b, h, it, tiles, sK, sV, sMask, next_ok);
    const int k0 = it * KEYS;
    if (it == 0) {
      load_rows_frags<D>(qf, sQ + 16 * warp * LD, lane);
      load_rows_frags<D>(gf, sG + 16 * warp * LD, lane);
    }
    if (!(a.causal && k0 > w0 + 15)) {
      const bf16* kT = sK + (it & 1) * KEYS * LD;
      const bf16* vT = sV + (it & 1) * KEYS * LD;
      float s[KEYS / 8][4], dp[KEYS / 8][4];
      mma_abt<D, KEYS>(s, qf, kT, lane);
      mma_abt<D, KEYS>(dp, gf, vT, lane);
      const bool edge = !full || (a.causal && k0 + KEYS - 1 > w0);
      logits_mma<KEYS>(s, a, edge, sMask, k0, w0 + g, t4);
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[j][e] - lse[e >> 1]);
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS, f32
        }
      }
      mma_pb<D, KEYS>(dq, s, kT, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= a.Tq) continue;
    bf16* out = static_cast<bf16*>(a.out0) +
                ((static_cast<long long>(b) * a.Tq + row) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + 8 * dt + 2 * t4) = pack_bf16(
          dq[dt][2 * r] * a.scale, dq[dt][2 * r + 1] * a.scale);
    }
  }
}

// ------------------------------------------- f32: register-tiled FFMA
// Thread (ty, tx) = (threadIdx.x >> 3, threadIdx.x & 7) owns rows
// 4ty .. 4ty+3 of the block (so warp w owns rows 16w .. 16w+15, as in
// bf16), keys tx + 8j of each tile and, of Dh, the columns
// 8*VW*c + VW*tx + e (VW-wide vectors, c < Dh/8/VW).

template <int VW> __device__ __forceinline__ void load_vec(const float* p,
                                                           float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int VW> __device__ __forceinline__ void store_vec(float* p,
                                                            const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] = sum_d rows[i][d] * keys[8j][d]: `rows` at this thread's
// first row, `keys` at its first key (tx), both of stride row_ld.
template <int D, int J>
__device__ __forceinline__ void micro_abt(float (&acc)[4][J],
                                          const float* rows,
                                          const float* keys) {
  constexpr int LD = row_ld<float, D>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(rows + i * LD + d);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(keys + 8 * j * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(x[i].x, y.x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y.y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y.z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y.w, acc[i][j]);
      }
    }
  }
}

// acc (4 rows x this thread's Dh/8 columns) += P (4 rows x KEYS, from
// the warp's shared p tile) @ tile (KEYS x Dh, shared).
template <int D, int KEYS>
__device__ __forceinline__ void micro_pb(float (&acc)[4][D / 8],
                                         const float* p, const float* tile,
                                         int tx) {
  constexpr int LD = row_ld<float, D>(), LP = KEYS + 4;
  constexpr int VW = D >= 32 ? 4 : 2, NV = D / 8 / VW;
#pragma unroll 2
  for (int j = 0; j < KEYS; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(p + i * LP + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* row = tile + (j + jj) * LD + VW * tx;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float v[VW];
        load_vec<VW>(row + 8 * VW * c, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = lane_of(pv[i], jj);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            acc[i][VW * c + e] = fmaf(pi, v[e], acc[i][VW * c + e]);
          }
        }
      }
    }
  }
}

template <int J>
__device__ __forceinline__ void logits_ffma(float (&s)[4][J], const Args& a,
                                            bool edge,
                                            const unsigned char* sMask,
                                            int k0, int row0, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float x = s[i][j] * a.scale;
      if (edge) {
        const int kl = tx + 8 * j;
        if (!sMask[kl] || (a.causal && row0 + i < k0 + kl)) x = kNeg;
      }
      s[i][j] = x;
    }
  }
}

__device__ __forceinline__ float oct_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 2));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 4));
}

__device__ __forceinline__ float oct_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 4);
}

// Stores this thread's 4 rows x Dh/8 columns of acc * mul (or / div).
template <int D>
__device__ __forceinline__ void store_rows_f32(const Args& a, int b, int h,
                                               int row0, int tx,
                                               const float (&acc)[4][D / 8],
                                               const float (&div)[4],
                                               float mul) {
  constexpr int VW = D >= 32 ? 4 : 2, NV = D / 8 / VW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= a.Tq) continue;
    float* out = static_cast<float*>(a.out0) +
                 ((static_cast<long long>(b) * a.Tq + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float v[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) v[e] = acc[i][VW * c + e] * mul / div[i];
      store_vec<VW>(out + 8 * VW * c + VW * tx, v);
    }
  }
}

template <int D, int ROWS, int KEYS>
__device__ __forceinline__ void fwd_ffma(const Args& a, char* smem) {
  constexpr int LD = row_ld<float, D>(), LP = KEYS + 4, J = KEYS / 8;
  __shared__ unsigned char sMask[KEYS];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + ROWS * LD;
  float* sV = sK + 2 * KEYS * LD;
  float* sP = sV + 2 * KEYS * LD;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int row0 = q0 + 4 * ty, w0 = q0 + 16 * (threadIdx.x >> 5);
  const int tiles = key_tiles<ROWS, KEYS>(a, q0);
  bool next_ok =
      stream_begin<float, D, ROWS, KEYS, false>(a, b, h, q0, sQ, sK, sV);

  float o[4][D / 8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] = 0.0f;
  }

  for (int it = 0; it < tiles; ++it) {
    const bool full =
        tile_start<float, D, KEYS>(a, b, h, it, tiles, sK, sV, sMask, next_ok);
    const int k0 = it * KEYS;
    if (!(a.causal && k0 > w0 + 15)) {
      const float* kT = sK + (it & 1) * KEYS * LD;
      const float* vT = sV + (it & 1) * KEYS * LD;
      float s[4][J];
      micro_abt<D, J>(s, sQ + 4 * ty * LD, kT + tx * LD);
      const bool edge = !full || (a.causal && k0 + KEYS - 1 > w0);
      logits_ffma<J>(s, a, edge, sMask, k0, row0, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < J; ++j) mx = fmaxf(mx, s[i][j]);
        mx = oct_max(mx);
        const float corr = expf(m[i] - mx);
        l[i] *= corr;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) o[i][c] *= corr;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float p = s[i][j] == kNeg ? 0.0f : expf(s[i][j] - mx);
          l[i] += p;
          sP[(4 * ty + i) * LP + tx + 8 * j] = p;  // f32: no rounding
        }
        m[i] = mx;
      }
      __syncwarp();  // the warp's p rows are written
      micro_pb<D, KEYS>(o, sP + 4 * ty * LP, vT, tx);
    }
    __syncthreads();
  }

  float denom[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = oct_sum(l[i]);
    denom[i] = l[i] > 0.0f ? l[i] : 1.0f;
  }
  store_rows_f32<D>(a, b, h, row0, tx, o, denom, 1.0f);
  if (a.lse_out != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row0 + i < a.Tq) {
        a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Tq + row0 + i] =
            l[i] > 0.0f ? m[i] + logf(denom[i]) : INFINITY;
      }
    }
  }
}

template <int D, int ROWS, int KEYS>
__device__ __forceinline__ void dq_ffma(const Args& a, char* smem) {
  constexpr int LD = row_ld<float, D>(), LP = KEYS + 4, J = KEYS / 8;
  __shared__ unsigned char sMask[KEYS];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + ROWS * LD;
  float* sK = sG + ROWS * LD;
  float* sV = sK + 2 * KEYS * LD;
  float* sP = sV + 2 * KEYS * LD;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int row0 = q0 + 4 * ty, w0 = q0 + 16 * (threadIdx.x >> 5);
  const int tiles = key_tiles<ROWS, KEYS>(a, q0);
  bool next_ok =
      stream_begin<float, D, ROWS, KEYS, true>(a, b, h, q0, sQ, sK, sV);

  float dq[4][D / 8], lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.Tq + row;
    lse[i] = row < a.Tq ? a.lse_in[stat] : INFINITY;  // +inf -> p = 0
    dl[i] = row < a.Tq ? a.delta[stat] : 0.0f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq[i][c] = 0.0f;
  }

  for (int it = 0; it < tiles; ++it) {
    const bool full =
        tile_start<float, D, KEYS>(a, b, h, it, tiles, sK, sV, sMask, next_ok);
    const int k0 = it * KEYS;
    if (!(a.causal && k0 > w0 + 15)) {
      const float* kT = sK + (it & 1) * KEYS * LD;
      const float* vT = sV + (it & 1) * KEYS * LD;
      float s[4][J], dp[4][J];
      micro_abt<D, J>(s, sQ + 4 * ty * LD, kT + tx * LD);
      micro_abt<D, J>(dp, sG + 4 * ty * LD, vT + tx * LD);
      const bool edge = !full || (a.causal && k0 + KEYS - 1 > w0);
      logits_ffma<J>(s, a, edge, sMask, k0, row0, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float p = expf(s[i][j] - lse[i]);
          sP[(4 * ty + i) * LP + tx + 8 * j] = p * (dp[i][j] - dl[i]);
        }
      }
      __syncwarp();
      micro_pb<D, KEYS>(dq, sP + 4 * ty * LP, kT, tx);
    }
    __syncthreads();
  }
  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows_f32<D>(a, b, h, row0, tx, dq, one, a.scale);
}

// ---------------------------------------------------------------- K1, K2
// One block of 2 * ROWS threads per (q tile of ROWS rows, head, batch).
template <typename T, int D, int ROWS, int KEYS>
__global__ void __launch_bounds__(2 * ROWS) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (std::is_same<T, bf16>::value) {
    fwd_mma<D, ROWS, KEYS>(a, smem);
  } else {
    fwd_ffma<D, ROWS, KEYS>(a, smem);
  }
}

template <typename T, int D, int ROWS, int KEYS>
__global__ void __launch_bounds__(2 * ROWS) flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (std::is_same<T, bf16>::value) {
    dq_mma<D, ROWS, KEYS>(a, smem);
  } else {
    dq_ffma<D, ROWS, KEYS>(a, smem);
  }
}

// ------------------------------------------------------------------- K3
// A block of KEYS/16 warps owns KEYS keys (16 a warp) of one (batch,
// head); q and dO tiles of ROWS rows stream past it.

// Shared memory of K3: the block's K and V rows, a 2-stage ring of q and
// dO tiles and, for f32, the p and dS tiles (KEYS x (ROWS + 4) each).
template <typename T, int D, int KEYS, int ROWS>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 * KEYS + 4 * ROWS) * row_ld<T, D>() * static_cast<int>(sizeof(T)) +
         (std::is_same<T, float>::value ? 2 * KEYS * (ROWS + 4) * 4 : 0);
}

// (LSE, delta) of q row `row`; (+inf, 0) past Tq, so p = 0 there.
__device__ __forceinline__ float2 row_stats(const Args& a, long long stat0,
                                            int row) {
  return row < a.Tq ? make_float2(a.lse_in[stat0 + row], a.delta[stat0 + row])
                    : make_float2(INFINITY, 0.0f);
}

// K3's stream, K/V-side twin of stream_begin / tile_start. Copies the
// block's K and V rows and the first q tile (that holding key k0 when
// causal: earlier tiles see only masked pairs), then for each q tile up
// to Tq: issues the next tile's q / dO copy into the other stage and
// loads its LSE / delta into registers, waits for this tile, runs
// `math(it, q0, q tile, dO tile, LSE, delta)` between two block
// barriers, and stores the next tile's LSE / delta beside its copy.
template <typename T, int D, int KEYS, int ROWS, typename F>
__device__ __forceinline__ void dkv_stream(const Args& a, int b, int h,
                                           int k0, T* sK, T* sV, T* sQ,
                                           T* sG, float (&sL)[2][ROWS],
                                           float (&sD)[2][ROWS], F&& math) {
  constexpr int LD = row_ld<T, D>();
  const int first = a.causal ? k0 / ROWS : 0;
  const int nq = (a.Tq + ROWS - 1) / ROWS;
  if (first >= nq) return;  // no q row sees these keys: dk = dv = 0
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.Tq;
  copy_tile<T, D, KEYS>(a.k, b, k0, a.Tk, h, sK);
  copy_tile<T, D, KEYS>(a.v, b, k0, a.Tk, h, sV);
  copy_tile<T, D, ROWS>(a.q, b, first * ROWS, a.Tq, h, sQ);
  copy_tile<T, D, ROWS>(a.g, b, first * ROWS, a.Tq, h, sG);
  cp_async_commit();
  if (threadIdx.x < ROWS) {
    const float2 st = row_stats(a, stat0, first * ROWS + threadIdx.x);
    sL[0][threadIdx.x] = st.x;
    sD[0][threadIdx.x] = st.y;
  }
  for (int qt = first; qt < nq; ++qt) {
    const int it = qt - first, cur = it & 1, nxt = cur ^ 1;
    const bool more = qt + 1 < nq;
    float2 st = make_float2(0.0f, 0.0f);
    if (more) {
      const int n0 = (qt + 1) * ROWS;
      copy_tile<T, D, ROWS>(a.q, b, n0, a.Tq, h, sQ + nxt * ROWS * LD);
      copy_tile<T, D, ROWS>(a.g, b, n0, a.Tq, h, sG + nxt * ROWS * LD);
      cp_async_commit();
      if (threadIdx.x < ROWS) st = row_stats(a, stat0, n0 + threadIdx.x);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    math(it, qt * ROWS, sQ + cur * ROWS * LD, sG + cur * ROWS * LD,
         sL[cur], sD[cur]);
    if (more && threadIdx.x < ROWS) {
      sL[nxt][threadIdx.x] = st.x;
      sD[nxt][threadIdx.x] = st.y;
    }
    __syncthreads();  // this stage is free for the copy issued next
  }
}

// bf16: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on mma.sync (16 keys x ROWS q columns
// a warp), Pᵀ = exp(Sᵀ − LSE[col]), dSᵀ = Pᵀ ∘ (dPᵀ − delta[col]); then
// dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ / dSᵀ rounded to bf16 in
// registers as the A operand and dO / Q read by ldmatrix.trans. Element
// e of n-tile j sits at key w0 + g + 8 * (e >> 1), q column q0 + 8 * j +
// 2 * t4 + (e & 1). K and V stay resident as A fragments up to Dh 64;
// at Dh 128 they are re-read from shared memory per q tile (resident,
// they would take 64 of the 255 registers the dk / dv accumulators'
// 128 leave).
template <int D, int KEYS, int ROWS>
__device__ __forceinline__ void dkv_mma(const Args& a, char* smem) {
  constexpr int LD = row_ld<bf16, D>();
  constexpr bool kResident = D <= 64;
  __shared__ float sL[2][ROWS], sD[2][ROWS];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KEYS * LD;
  bf16* sQ = sV + KEYS * LD;
  bf16* sG = sQ + 2 * ROWS * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * KEYS;
  const int w0 = k0 + 16 * warp;  // this warp's first key
  const bool kv[2] = {key_valid(a, b, w0 + g), key_valid(a, b, w0 + g + 8)};
  const bool all_valid = __all_sync(kFull, kv[0] && kv[1]);
  const bf16* wK = sK + 16 * warp * LD;
  const bf16* wV = sV + 16 * warp * LD;

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;
  }

  dkv_stream<bf16, D, KEYS, ROWS>(
      a, b, h, k0, sK, sV, sQ, sG, sL, sD,
      [&](int it, int q0, const bf16* tQ, const bf16* tG, const float* lse,
          const float* dl) {
        if constexpr (kResident) {
          if (it == 0) {
            load_rows_frags<D>(kf, wK, lane);
            load_rows_frags<D>(vf, wV, lane);
          }
        }
        if (a.causal && q0 + ROWS - 1 < w0) return;  // p = 0 throughout
        float s[ROWS / 8][4], dp[ROWS / 8][4];
        if constexpr (kResident) {
          mma_abt<D, ROWS>(s, kf, tQ, lane);
          mma_abt<D, ROWS>(dp, vf, tG, lane);
        } else {
          load_rows_frags<D>(kf, wK, lane);
          mma_abt<D, ROWS>(s, kf, tQ, lane);
          load_rows_frags<D>(kf, wV, lane);
          mma_abt<D, ROWS>(dp, kf, tG, lane);
        }
        const bool edge = !all_valid || (a.causal && q0 < w0 + 15);
#pragma unroll
        for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t4 + (e & 1);
            float x = s[j][e] * a.scale;
            if (edge && (!kv[e >> 1] ||
                         (a.causal && q0 + c < w0 + g + 8 * (e >> 1)))) {
              x = kNeg;
            }
            const float p = __expf(x - lse[c]);
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dl[c]);  // dS, f32
          }
        }
        mma_pb<D, ROWS>(dv, s, tG, lane);
        mma_pb<D, ROWS>(dk, dp, tQ, lane);
      });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = w0 + g + 8 * r;
    if (key >= a.Tk) continue;
    const long long off = ((static_cast<long long>(b) * a.Tk + key) * a.H + h) * D;
    bf16* ok = static_cast<bf16*>(a.out0) + off;
    bf16* ov = static_cast<bf16*>(a.out1) + off;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(ok + 8 * dt + 2 * t4) = pack_bf16(
          dk[dt][2 * r] * a.scale, dk[dt][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(ov + 8 * dt + 2 * t4) =
          pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// f32: thread (ty, tx) owns keys 4ty .. 4ty+3 of the block (warp w keys
// 16w .. 16w+15), q columns tx + 8j of each tile and, of Dh, the columns
// 8*VW*c + VW*tx + e. Sᵀ and dPᵀ are 4 x ROWS/8 FFMA micro-tiles from the
// shared K / V rows and q / dO tiles; p and dS pass through the warp's
// rows of two shared tiles into the 4 x Dh/8 micro-tiles of dV and dK.
template <int D, int KEYS, int ROWS>
__device__ __forceinline__ void dkv_ffma(const Args& a, char* smem) {
  constexpr int LD = row_ld<float, D>(), LP = ROWS + 4, J = ROWS / 8;
  constexpr int VW = D >= 32 ? 4 : 2, NV = D / 8 / VW;
  __shared__ float sL[2][ROWS], sD[2][ROWS];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + KEYS * LD;
  float* sQ = sV + KEYS * LD;
  float* sG = sQ + 2 * ROWS * LD;
  float* sP = sG + 2 * ROWS * LD;
  float* sS = sP + KEYS * LP;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * KEYS;
  const int key0 = k0 + 4 * ty, w0 = k0 + 16 * (threadIdx.x >> 5);
  bool kv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kv[i] = key_valid(a, b, key0 + i);
  const bool all_valid = __all_sync(kFull, kv[0] && kv[1] && kv[2] && kv[3]);

  float dk[4][D / 8], dv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }

  dkv_stream<float, D, KEYS, ROWS>(
      a, b, h, k0, sK, sV, sQ, sG, sL, sD,
      [&](int, int q0, const float* tQ, const float* tG, const float* lse,
          const float* dl) {
        if (a.causal && q0 + ROWS - 1 < w0) return;  // p = 0 throughout
        float s[4][J], dp[4][J];
        micro_abt<D, J>(s, sK + 4 * ty * LD, tQ + tx * LD);
        micro_abt<D, J>(dp, sV + 4 * ty * LD, tG + tx * LD);
        const bool edge = !all_valid || (a.causal && q0 < w0 + 15);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int c = tx + 8 * j;
            float x = s[i][j] * a.scale;
            if (edge && (!kv[i] || (a.causal && q0 + c < key0 + i))) x = kNeg;
            const float p = expf(x - lse[c]);
            sP[(4 * ty + i) * LP + c] = p;  // f32: no rounding
            sS[(4 * ty + i) * LP + c] = p * (dp[i][j] - dl[c]);
          }
        }
        __syncwarp();  // the warp's p and dS rows are written
        micro_pb<D, ROWS>(dv, sP + 4 * ty * LP, tG, tx);
        micro_pb<D, ROWS>(dk, sS + 4 * ty * LP, tQ, tx);
      });

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + i;
    if (key >= a.Tk) continue;
    const long long off = ((static_cast<long long>(b) * a.Tk + key) * a.H + h) * D;
    float* ok = static_cast<float*>(a.out0) + off;
    float* ov = static_cast<float*>(a.out1) + off;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float vk[VW], vv[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        vk[e] = dk[i][VW * c + e] * a.scale;
        vv[e] = dv[i][VW * c + e];
      }
      store_vec<VW>(ok + 8 * VW * c + VW * tx, vk);
      store_vec<VW>(ov + 8 * VW * c + VW * tx, vv);
    }
  }
}

// One block of 2 * KEYS threads per (head, batch, key tile); the key
// tile is blockIdx.z, the slowest axis, so under causal masking the
// heaviest tiles (the first keys, which every later q tile sees) start
// first.
template <typename T, int D, int KEYS, int ROWS>
__global__ void __launch_bounds__(2 * KEYS) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (std::is_same<T, bf16>::value) {
    dkv_mma<D, KEYS, ROWS>(a, smem);
  } else {
    dkv_ffma<D, KEYS, ROWS>(a, smem);
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int D, int ROWS, int KEYS, bool kGrad, typename K>
int launch_rows(K kernel, const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D, ROWS, KEYS, kGrad>();
  // Above 48 KB a block's dynamic shared memory must be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + ROWS - 1) / ROWS, a.H, B);
  kernel<<<grid, dim3(2 * ROWS), bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K1 (which 0) and K2 (which 1): the (Dh, ROWS, KEYS) tiles built, each
// for both kernels and both dtypes; ops/flash_attention.py's TILES lists
// the same. Dh 64 (GPT-2 small) has the sweep's tiles; (128 rows, 128
// keys) is left out because the f32 K1 needs 242 KB of shared memory
// there, over the 227 KB a block may have.
template <typename T, int kWhich>
int dispatch_rows(const Args& a, int B, int D, int rows, int keys,
                  cudaStream_t stream) {
#define DMP_QCASE(DD, RR, KK)                                              \
  if (D == DD && rows == RR && keys == KK) {                               \
    if constexpr (kWhich == 0) {                                           \
      return launch_rows<T, DD, RR, KK, false>(                            \
          flash_fwd_kernel<T, DD, RR, KK>, a, B, stream);                  \
    } else {                                                               \
      return launch_rows<T, DD, RR, KK, true>(                             \
          flash_bwd_dq_kernel<T, DD, RR, KK>, a, B, stream);               \
    }                                                                      \
  }
  DMP_QCASE(16, 64, 64) DMP_QCASE(32, 64, 64)
  DMP_QCASE(64, 64, 32) DMP_QCASE(64, 64, 64) DMP_QCASE(64, 64, 128)
  DMP_QCASE(64, 128, 32) DMP_QCASE(64, 128, 64)
  DMP_QCASE(128, 64, 32) DMP_QCASE(128, 64, 64)
#undef DMP_QCASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D, int KEYS, int ROWS>
int launch_dkv(const Args& a, int B, cudaStream_t stream) {
  static_assert(KEYS % 16 == 0 && ROWS % 16 == 0 && ROWS <= 2 * KEYS,
                "K3 tile: 16-row mma steps; a thread per q row's stats");
  constexpr int bytes = dkv_smem_bytes<T, D, KEYS, ROWS>();
  const int key_tiles = (a.Tk + KEYS - 1) / KEYS;
  if (B > 65535 || key_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dkv_kernel<T, D, KEYS, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.H, B, key_tiles), dim3(2 * KEYS), bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3: the (Dh, KEYS, ROWS) tiles built, each for both dtypes;
// ops/flash_attention.py's TILES lists the same. Dh 64 has the sweep's
// keys {64, 128} x rows {32, 64}; Dh 128 only (64, 32): at (64, 64) the
// f32 kernel needs 237 KB of shared memory.
template <typename T>
int dispatch_dkv(const Args& a, int B, int D, int keys, int rows,
                 cudaStream_t stream) {
#define DMP_KCASE(DD, KK, RR)                                              \
  if (D == DD && keys == KK && rows == RR) {                               \
    return launch_dkv<T, DD, KK, RR>(a, B, stream);                        \
  }
  DMP_KCASE(16, 64, 64) DMP_KCASE(32, 64, 64)
  DMP_KCASE(64, 64, 32) DMP_KCASE(64, 64, 64)
  DMP_KCASE(64, 128, 32) DMP_KCASE(64, 128, 64)
  DMP_KCASE(128, 64, 32)
#undef DMP_KCASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ------------------------------------------------------------- parts
// The six (kernel, dtype) dispatches, each behind a C symbol: t0, t1 are
// the kernel's tile (rows, keys for K1 / K2; keys, rows for K3). Built
// whole, this file defines them all. ops/_cuda.py builds it in parts
// instead, one nvcc each, all at once: with DMP_FLASH_PART = p (0-5)
// only the p-th dispatch and its kernels are compiled, part 0 also
// holds the entry points, and the objects link into one library. The
// kernels are the same; the build takes the time of its largest part.
#ifdef DMP_FLASH_PART
#define DMP_IN_PART(P) (DMP_FLASH_PART == (P))
#else
#define DMP_IN_PART(P) 1
#endif

extern "C" {
int dmp_flash_part_fwd_f32(const void*, int, int, int, int, cudaStream_t);
int dmp_flash_part_fwd_bf16(const void*, int, int, int, int, cudaStream_t);
int dmp_flash_part_dq_f32(const void*, int, int, int, int, cudaStream_t);
int dmp_flash_part_dq_bf16(const void*, int, int, int, int, cudaStream_t);
int dmp_flash_part_dkv_f32(const void*, int, int, int, int, cudaStream_t);
int dmp_flash_part_dkv_bf16(const void*, int, int, int, int, cudaStream_t);

#define DMP_PART_FN(NAME, CALL)                                            \
  int NAME(const void* a, int B, int D, int t0, int t1,                    \
           cudaStream_t stream) {                                          \
    return CALL(*static_cast<const Args*>(a), B, D, t0, t1, stream);       \
  }
#if DMP_IN_PART(0)
DMP_PART_FN(dmp_flash_part_fwd_f32, (dispatch_rows<float, 0>))
#endif
#if DMP_IN_PART(1)
DMP_PART_FN(dmp_flash_part_fwd_bf16, (dispatch_rows<bf16, 0>))
#endif
#if DMP_IN_PART(2)
DMP_PART_FN(dmp_flash_part_dq_f32, (dispatch_rows<float, 1>))
#endif
#if DMP_IN_PART(3)
DMP_PART_FN(dmp_flash_part_dq_bf16, (dispatch_rows<bf16, 1>))
#endif
#if DMP_IN_PART(4)
DMP_PART_FN(dmp_flash_part_dkv_f32, dispatch_dkv<float>)
#endif
#if DMP_IN_PART(5)
DMP_PART_FN(dmp_flash_part_dkv_bf16, dispatch_dkv<bf16>)
#endif
#undef DMP_PART_FN
}  // extern "C"

#if DMP_IN_PART(0)
namespace {

Operand operand(const void* p, const long long* s) {
  return Operand{p, s[0], s[1], s[2]};
}

bool bad_shape(const Args& a, int B) {
  return B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.H <= 0;
}

int run_rows(int which, const Args& a, int B, int D, int rows, int keys,
             int bf16_in, cudaStream_t stream) {
  if (bad_shape(a, B)) return static_cast<int>(cudaErrorInvalidValue);
  if (which == 0) {
    return (bf16_in ? dmp_flash_part_fwd_bf16 : dmp_flash_part_fwd_f32)(
        &a, B, D, rows, keys, stream);
  }
  return (bf16_in ? dmp_flash_part_dq_bf16 : dmp_flash_part_dq_f32)(
      &a, B, D, rows, keys, stream);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns a cudaError_t code (0 =
// launched). `strides` holds (batch, seq, head) element strides per
// (B, T, H, Dh) operand, in the order the operands are listed. K1-K3
// copy 16-byte chunks: every operand's base address and strides must be
// multiples of 16 bytes (the wrapper checks). Outputs are contiguous
// (B, T, H, Dh); lse/delta are contiguous (B, H, Tq) f32.

int dmp_flash_fwd(const void* q, const void* k, const void* v,
                  const long long* strides, const uint8_t* mask, void* out,
                  float* lse, int B, int Tq, int Tk, int H, int D, int rows,
                  int keys, int bf16_in, float scale, int causal,
                  cudaStream_t stream) {
  Args a{};
  a.q = operand(q, strides);
  a.k = operand(k, strides + 3);
  a.v = operand(v, strides + 6);
  a.mask = mask;
  a.out0 = out;
  a.lse_out = lse;
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.scale = scale; a.causal = causal;
  return run_rows(0, a, B, D, rows, keys, bf16_in, stream);
}

int dmp_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* g, const long long* strides,
                     const uint8_t* mask, const float* lse,
                     const float* delta, void* dq, int B, int Tq, int Tk,
                     int H, int D, int rows, int keys, int bf16_in,
                     float scale, int causal, cudaStream_t stream) {
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
  return run_rows(1, a, B, D, rows, keys, bf16_in, stream);
}

int dmp_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* g, const long long* strides,
                      const uint8_t* mask, const float* lse,
                      const float* delta, void* dk, void* dv, int B, int Tq,
                      int Tk, int H, int D, int keys, int rows, int bf16_in,
                      float scale, int causal, cudaStream_t stream) {
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
  if (bad_shape(a, B)) return static_cast<int>(cudaErrorInvalidValue);
  return (bf16_in ? dmp_flash_part_dkv_bf16 : dmp_flash_part_dkv_f32)(
      &a, B, D, keys, rows, stream);
}

}  // extern "C"
#endif  // DMP_IN_PART(0)
