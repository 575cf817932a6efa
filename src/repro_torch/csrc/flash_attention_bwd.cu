// The backward of blocked attention: dQ, dK and dV from Q, K, V, O, dO and
// the forward's per-row log-sum-exp, on the CUDA cores.
//
// Replaces no TPU kernel: the reference trains through `jax.grad` of its
// plain blocked attention (src/repro/models/attention.py, `use_flash`
// False), and its Pallas kernel `_attn_kernel` has no VJP.  The port's
// training forward runs the flash kernel (flash_attention.cu) on every
// CUDA tensor, so its gradient is a kernel too.  It computes the gradient
// of the same function: q (BH, S, hd), k/v (BKV, S, hd), query row i reads
// KV row i / G (G = BH / BKV); x = (q·k)·scale, optionally softcapped to
// c·tanh(x / c); causal and sliding-window masks; P = exp(x − lse) with lse
// the forward's log-sum-exp of each row; then, with D = rowsum(dO ∘ O),
//   dV = Pᵀ·dO,   dP = dO·Vᵀ,   dX = P ∘ (dP − D),
//   dS = dX · (1 − tanh²) · scale  (without softcap: dX · scale),
//   dQ = dS·K,    dK = dSᵀ·Q,
// summed over the G query heads of a KV head for dK and dV.  Inputs are
// bf16 or f32, every sum is f32, outputs take q's dtype.  Any S is taken:
// rows past S are loaded as zeros and masked.
//
// Deterministic, with no atomics: three kernels, each output element
// written by one thread after a fixed-order loop.
//   1. flash_bwd_dot: D[r] = Σ_d dO[r, d]·O[r, d], one warp a row.
//   2. flash_bwd_dkdv: one CTA per (KV row, 64-key tile).  K and V stay in
//      shared memory; the CTA walks the G query heads, and for each the
//      live 64-row query tiles in order: it rebuilds Sᵀ and dPᵀ for the
//      tile (keys × queries), P and dS into shared memory, and adds Pᵀ·dO
//      and dSᵀ·Q into f32 accumulators held in registers.
//   3. flash_bwd_dq: one CTA per (query row, 64-query tile): rebuilds S and
//      dP for each live key tile and adds dS·K into registers.
// bf16 (the training path) runs the products on the tensor cores with
// `mma.sync` (see the bf16 section below); f32 runs them on the CUDA
// cores: 256 threads as a 16 × 16 grid own a 64 × 64 tile (4 × 4 elements
// each) for the score products and 64 × hd (4 × hd/16) for the
// accumulators, as in the forward's f32 kernel, operand rows padded by 4
// floats against bank conflicts.  The liveness test of a (query tile,
// key tile) pair is the forward's.
//
// What bounds it on an H100: at the training shape (B 4, S 1 024, H 16,
// KV 8, hd 128, causal) it does five products of 2·hd FLOPs per live
// (query, key) pair (S, dP and dV in the first kernel, S, dP and dQ in the
// second, dK in the first: seven with the recomputations), 2.5× the
// forward's two, against ~10·S·hd bytes a head: far above the ridge, so
// the bound is the tensor cores' 989 TFLOP/s.  `mma.sync` reaches a part
// of that rate; the CTAs recompute S and dP in both kernels and load
// their tiles synchronously.  `wgmma` from TMA-fed shared memory, and one
// kernel that adds dQ across key tiles in a fixed order, are the next
// steps (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kT = 64;              // query and key rows a tile
constexpr int kThreads = 256;
constexpr int kPS = kT + 16;        // a warp's two P rows sit 16 banks apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of a row-major (S, HD) matrix of T → f32 shared
// memory with row stride ld; rows past S become zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int S, float* dst, int ld) {
  for (int c = threadIdx.x; c < kT * HD; c += kThreads) {
    const int r = c / HD, col = c % HD;
    dst[r * ld + col] =
        row0 + r < S ? to_f32(src[(size_t)(row0 + r) * HD + col]) : 0.f;
  }
}

__device__ __forceinline__ bool tile_live(int q0, int k0, int causal,
                                          int window) {
  bool live = true;
  if (causal) live = k0 <= q0 + kT - 1;
  if (window > 0) live = live && (q0 - (k0 + kT - 1) < window);
  return live;
}

__device__ __forceinline__ bool pair_ok(int qpos, int kpos, int S, int causal,
                                        int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  return ok;
}

// acc[i][j] = Σ_d A[ty + 16i][d] · B[tx + 16j][d] over HD (rows of A and B
// in shared memory with stride ld)
template <int HD>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int ld, int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// the score x of a raw product s, and d(x)/d(s) / scale (1 − tanh² with a
// softcap, else 1)
__device__ __forceinline__ float score(float s, float scale, int has_softcap,
                                       float softcap, float* dcap) {
  float x = s * scale;
  *dcap = 1.f;
  if (has_softcap) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    *dcap = 1.f - t * t;
  }
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ dvec, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc += to_f32(o[row * HD + d]) * to_f32(dout[row * HD + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return (size_t)(4 * kT * (HD + 4) + 2 * kT * kPS + 2 * kT) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec, T* __restrict__ dk,
                          T* __restrict__ dv, int BKV, int S, int G,
                          int causal, int window, int has_softcap,
                          float softcap, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 16;
  float* Ks = reinterpret_cast<float*>(smem4);   // kT × LD
  float* Vs = Ks + kT * LD;
  float* Qs = Vs + kT * LD;
  float* dOs = Qs + kT * LD;
  float* Ps = dOs + kT * LD;                     // kT × kPS, [key][query]
  float* dSs = Ps + kT * kPS;
  float* lse_s = dSs + kT * kPS;                  // kT
  float* D_s = lse_s + kT;

  const int kvrow = blockIdx.x % BKV;
  const int k0 = (blockIdx.x / BKV) * kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, HD>(k + (size_t)kvrow * S * HD, k0, S, Ks, LD);
  load_tile<T, HD>(v + (size_t)kvrow * S * HD, k0, S, Vs, LD);

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nq = (S + kT - 1) / kT;
  for (int g = 0; g < G; ++g) {
    const int bh = kvrow * G + g;
    const T* qp = q + (size_t)bh * S * HD;
    const T* dop = dout + (size_t)bh * S * HD;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kT;
      if (!tile_live(q0, k0, causal, window)) continue;
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, HD>(qp, q0, S, Qs, LD);
      load_tile<T, HD>(dop, q0, S, dOs, LD);
      if (threadIdx.x < kT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? lse[(size_t)bh * S + r] : 0.f;
        D_s[threadIdx.x] = r < S ? dvec[(size_t)bh * S + r] : 0.f;
      }
      __syncthreads();

      // Sᵀ (keys × queries) and dPᵀ = V·dOᵀ
      float s[4][4], dp[4][4];
      dot_tile<HD>(Ks, Qs, LD, ty, tx, s);
      dot_tile<HD>(Vs, dOs, LD, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          float dcap;
          const float x = score(s[i][j], scale, has_softcap, softcap, &dcap);
          const bool ok = pair_ok(q0 + qc, kpos, S, causal, window);
          const float p = ok ? expf(x - lse_s[qc]) : 0.f;
          Ps[(ty + 16 * i) * kPS + qc] = p;
          dSs[(ty + 16 * i) * kPS + qc] = p * (dp[i][j] - D_s[qc]) * dcap * scale;
        }
      }
      __syncthreads();

      // dV += Pᵀ·dO, dK += dSᵀ·Q over the tile's queries, in order
#pragma unroll 4
      for (int c = 0; c < kT; ++c) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[(ty + 16 * i) * kPS + c];
          ds[i] = dSs[(ty + 16 * i) * kPS + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dov = dOs[c * LD + tx + 16 * j];
          const float qv = Qs[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(p[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
    T* dkp = dk + ((size_t)kvrow * S + row) * HD;
    T* dvp = dv + ((size_t)kvrow * S + row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      from_f32(dkp + tx + 16 * j, acc_k[i][j]);
      from_f32(dvp + tx + 16 * j, acc_v[i][j]);
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (size_t)(4 * kT * (HD + 4) + kT * kPS) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, T* __restrict__ dq,
                        int BH, int S, int G, int causal, int window,
                        int has_softcap, float softcap, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 16;
  float* Qs = reinterpret_cast<float*>(smem4);   // kT × LD
  float* dOs = Qs + kT * LD;
  float* Ks = dOs + kT * LD;
  float* Vs = Ks + kT * LD;
  float* dSs = Vs + kT * LD;                     // kT × kPS, [query][key]

  const int bh = blockIdx.x % BH;
  const int q0 = (blockIdx.x / BH) * kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kp = k + (size_t)(bh / G) * S * HD;
  const T* vp = v + (size_t)(bh / G) * S * HD;
  load_tile<T, HD>(q + (size_t)bh * S * HD, q0, S, Qs, LD);
  load_tile<T, HD>(dout + (size_t)bh * S * HD, q0, S, dOs, LD);
  float lse_r[4], D_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < S ? lse[(size_t)bh * S + r] : 0.f;
    D_r[i] = r < S ? dvec[(size_t)bh * S + r] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (S + kT - 1) / kT;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    if (!tile_live(q0, k0, causal, window)) continue;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(kp, k0, S, Ks, LD);
    load_tile<T, HD>(vp, k0, S, Vs, LD);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<HD>(Qs, Ks, LD, ty, tx, s);
    dot_tile<HD>(dOs, Vs, LD, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        float dcap;
        const float x = score(s[i][j], scale, has_softcap, softcap, &dcap);
        const bool ok = pair_ok(qpos, k0 + kc, S, causal, window);
        const float p = ok ? expf(x - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * kPS + kc] = p * (dp[i][j] - D_r[i]) * dcap * scale;
      }
    }
    __syncthreads();

    // dQ += dS·K over the tile's keys, in order
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* dqp = dq + ((size_t)bh * S + row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) from_f32(dqp + tx + 16 * j, acc[i][j]);
  }
}

// ------------------------------------------------------ bf16: mma.sync ----
//
// The bf16 path runs the five products on the tensor cores with
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate): 4 warps a CTA, each warp
// owning 16 rows of the CTA's 64 (keys in dkdv, queries in dq).  Operand
// tiles sit in shared memory as bf16 rows padded by 8 elements (272-byte
// rows at hd 128: the 8 rows an `ldmatrix` reads fall on distinct banks);
// A and B fragments come from `ldmatrix` (`.trans` where B is stored k-major,
// as dO, Q and K are for dV, dK and dQ).  The score and dP accumulators
// become P and dS in registers, and the accumulator layout of two n8 tiles
// is the A fragment of one k16 slice, so P and dS (rounded to bf16, as the
// forward rounds P) feed the next products without shared memory.

constexpr int kMW = 4;                       // warps a CTA
constexpr int kMThreads = 32 * kMW;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a row-major (S, HD) bf16 matrix → shared memory
// with row stride ld elements, 16 bytes a thread at a time; rows past S are
// zeros
template <int HD>
__device__ __forceinline__ void load_tile_bf16(
    const __nv_bfloat16* __restrict__ src, int row0, int S,
    __nv_bfloat16* dst, int ld) {
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < kT * CPR; c += kMThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + col) =
        row0 + r < S ? *reinterpret_cast<const uint4*>(
                           src + (size_t)(row0 + r) * HD + col)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc (this warp's 16 rows of A × the tile's 64 rows of B, as 8 n8 tiles)
// = A · Bᵀ over HD: A and B row-major (rows × HD) in shared memory
template <int HD>
__device__ __forceinline__ void mma_abt(const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int ld,
                                        int warp, int lane,
                                        float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(A + (16 * warp + (lane & 15)) * ld + 16 * kk +
                        (lane >> 4) * 8));
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(B + (16 * j2 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                          16 * kk + ((lane >> 3) & 1) * 8));
      mma16816(acc[2 * j2], a, b[0], b[1]);
      mma16816(acc[2 * j2 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x HD, as HD/8 n8 tiles) += P (this warp's 16 rows × the tile's 64
// columns, as bf16 A fragments pa[k16 slice]) · B, B row-major (64 × HD) in
// shared memory (k-major: read with ldmatrix.trans)
template <int HD>
__device__ __forceinline__ void mma_pb(const uint32_t (&pa)[4][4],
                                       const __nv_bfloat16* B, int ld,
                                       int lane, float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(B + (16 * kk + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * ld +
                            16 * np + (lane >> 4) * 8));
      mma16816(acc[2 * np], pa[kk], b[0], b[1]);
      mma16816(acc[2 * np + 1], pa[kk], b[2], b[3]);
    }
}

// the accumulator layout of n8 tiles (2kk, 2kk + 1) as the bf16 A fragment
// of k16 slice kk
__device__ __forceinline__ void to_a_frags(const float (&x)[8][4],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return (size_t)4 * kT * (HD + 8) * 2 + 2 * kT * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kMThreads, 1)
    flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dvec,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int BKV, int S,
                              int G, int causal, int window, int has_softcap,
                              float softcap, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = HD + 8;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + kT * LD;
  __nv_bfloat16* Qs = Vs + kT * LD;
  __nv_bfloat16* dOs = Qs + kT * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kT * LD);
  float* D_s = lse_s + kT;

  const int kvrow = blockIdx.x % BKV;
  const int k0 = (blockIdx.x / BKV) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  load_tile_bf16<HD>(k + (size_t)kvrow * S * HD, k0, S, Ks, LD);
  load_tile_bf16<HD>(v + (size_t)kvrow * S * HD, k0, S, Vs, LD);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int nq = (S + kT - 1) / kT;
  for (int gi = 0; gi < G; ++gi) {
    const int bh = kvrow * G + gi;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kT;
      if (!tile_live(q0, k0, causal, window)) continue;
      __syncthreads();   // the previous tile's readers are done
      load_tile_bf16<HD>(q + (size_t)bh * S * HD, q0, S, Qs, LD);
      load_tile_bf16<HD>(dout + (size_t)bh * S * HD, q0, S, dOs, LD);
      if (threadIdx.x < kT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? lse[(size_t)bh * S + r] : 0.f;
        D_s[threadIdx.x] = r < S ? dvec[(size_t)bh * S + r] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 keys × 64 queries
      float s[8][4], dp[8][4];
      mma_abt<HD>(Ks, Qs, LD, warp, lane, s);
      mma_abt<HD>(Vs, dOs, LD, warp, lane, dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 16 * warp + g + (e >> 1) * 8;
          const int qc = 8 * j + 2 * tig + (e & 1);
          float dcap;
          const float x = score(s[j][e], scale, has_softcap, softcap, &dcap);
          const bool ok = pair_ok(q0 + qc, kpos, S, causal, window);
          const float p = ok ? expf(x - lse_s[qc]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - D_s[qc]) * dcap * scale;
        }
      uint32_t frag[4][4];
      to_a_frags(s, frag);
      mma_pb<HD>(frag, dOs, LD, lane, acc_v);   // dV += Pᵀ·dO
      to_a_frags(dp, frag);
      mma_pb<HD>(frag, Qs, LD, lane, acc_k);    // dK += dSᵀ·Q
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * warp + g + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* dkp = dk + ((size_t)kvrow * S + row) * HD + 2 * tig;
    __nv_bfloat16* dvp = dv + ((size_t)kvrow * S + row) * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * j) =
          __floats2bfloat162_rn(acc_k[j][2 * h], acc_k[j][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * j) =
          __floats2bfloat162_rn(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMThreads, 1)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            __nv_bfloat16* __restrict__ dq, int BH, int S,
                            int G, int causal, int window, int has_softcap,
                            float softcap, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = HD + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dOs = Qs + kT * LD;
  __nv_bfloat16* Ks = dOs + kT * LD;
  __nv_bfloat16* Vs = Ks + kT * LD;

  const int bh = blockIdx.x % BH;
  const int q0 = (blockIdx.x / BH) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* kp = k + (size_t)(bh / G) * S * HD;
  const __nv_bfloat16* vp = v + (size_t)(bh / G) * S * HD;
  load_tile_bf16<HD>(q + (size_t)bh * S * HD, q0, S, Qs, LD);
  load_tile_bf16<HD>(dout + (size_t)bh * S * HD, q0, S, dOs, LD);
  float lse_r[2], D_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    lse_r[h] = r < S ? lse[(size_t)bh * S + r] : 0.f;
    D_r[h] = r < S ? dvec[(size_t)bh * S + r] : 0.f;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = (S + kT - 1) / kT;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    if (!tile_live(q0, k0, causal, window)) continue;
    __syncthreads();   // the previous tile's readers are done
    load_tile_bf16<HD>(kp, k0, S, Ks, LD);
    load_tile_bf16<HD>(vp, k0, S, Vs, LD);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 queries × 64 keys
    float s[8][4], dp[8][4];
    mma_abt<HD>(Qs, Ks, LD, warp, lane, s);
    mma_abt<HD>(dOs, Vs, LD, warp, lane, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qpos = q0 + 16 * warp + g + 8 * h;
        const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
        float dcap;
        const float x = score(s[j][e], scale, has_softcap, softcap, &dcap);
        const bool ok = pair_ok(qpos, kpos, S, causal, window);
        const float p = ok ? expf(x - lse_r[h]) : 0.f;
        dp[j][e] = p * (dp[j][e] - D_r[h]) * dcap * scale;
      }
    uint32_t frag[4][4];
    to_a_frags(dp, frag);
    mma_pb<HD>(frag, Ks, LD, lane, acc);        // dQ += dS·K
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* dqp = dq + ((size_t)bh * S + row) * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqp + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dvec, void* dq, void* dk,
           void* dv, int BH, int BKV, int S, int causal, int window,
           int has_softcap, float softcap, float scale, cudaStream_t st) {
  const int G = BH / BKV;
  const long long nt = (S + kT - 1) / kT;
  const long long rows = (long long)BH * S;
  if ((rows + 7) / 8 > 0x7fffffffLL || (long long)BH * nt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(dvec);

  flash_bwd_dot_kernel<T, HD><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(o), tdo, fd, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = mma_smem_bytes<HD>();
    err = allow_smem(flash_bwd_dkdv_mma_kernel<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_kernel<HD><<<(unsigned)(BKV * nt), kMThreads, smem,
                                    st>>>(
        tq, tk, tv, tdo, flse, fd, static_cast<T*>(dk), static_cast<T*>(dv),
        BKV, S, G, causal, window, has_softcap, softcap, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(flash_bwd_dq_mma_kernel<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_mma_kernel<HD><<<(unsigned)(BH * nt), kMThreads, smem, st>>>(
        tq, tk, tv, tdo, flse, fd, static_cast<T*>(dq), BH, S, G, causal,
        window, has_softcap, softcap, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem_kv = dkdv_smem_bytes<HD>();
  err = allow_smem(flash_bwd_dkdv_kernel<T, HD>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, HD><<<(unsigned)(BKV * nt), kThreads, smem_kv, st>>>(
      tq, tk, tv, tdo, flse, fd, static_cast<T*>(dk), static_cast<T*>(dv),
      BKV, S, G, causal, window, has_softcap, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = dq_smem_bytes<HD>();
  err = allow_smem(flash_bwd_dq_kernel<T, HD>, smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD><<<(unsigned)(BH * nt), kThreads, smem_q, st>>>(
      tq, tk, tv, tdo, flse, fd, static_cast<T*>(dq), BH, S, G, causal,
      window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const void* lse, void* dvec,
              void* dq, void* dk, void* dv, int BH, int BKV, int S,
              int causal, int window, int has_softcap, float softcap,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                                  BKV, S, causal, window, has_softcap,
                                  softcap, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                                  BKV, S, causal, window, has_softcap,
                                  softcap, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                                  BKV, S, causal, window, has_softcap,
                                  softcap, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, dvec, dq, dk, dv,
                                    BH, BKV, S, causal, window, has_softcap,
                                    softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the first failing launch's cudaError_t (0 = success).  q, o, dout,
// dq (BH, S, hd); k, v, dk, dv (BKV, S, hd); lse and dvec (BH, S) f32, dvec
// scratch; all contiguous and of one dtype (0 = float32, 1 = bfloat16)
// but the f32 ones; hd in {16, 32, 64, 128}; window <= 0 means no window;
// softcap is read only when has_softcap is set.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int BH, int BKV, int S, int hd, int dtype, int causal,
    int window, int has_softcap, float softcap, float scale, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                            BKV, S, causal, window, has_softcap, softcap,
                            scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, dvec, dq, dk,
                                    dv, BH, BKV, S, causal, window,
                                    has_softcap, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
