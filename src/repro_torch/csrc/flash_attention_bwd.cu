// The backward of blocked attention: dQ, dK and dV from Q, K, V, O, dO and
// the forward's per-row log-sum-exp.
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
// bf16 or f32, every sum is f32, P and dS enter their products rounded to
// the inputs' dtype, outputs take q's dtype.  Any S is taken: rows past S
// are loaded as zeros and masked.  Deterministic: the same inputs give the
// same bytes (no float atomics; every sum has a fixed order).
//
// What bounds it on an H100: at the training shape (B 4, S 1 024, H 16,
// KV 8, hd 128, causal) five products of 2·hd FLOPs per live (query, key)
// pair, 2.5× the forward's two, against ~10·S·hd bytes a head: far above
// the ~295 FLOP/byte ridge, so the bound is the tensor cores' 989 TFLOP/s.
// `launch` dispatches on (dtype, hd), explicitly, never after a failure:
//
// * bf16 at hd 64 and 128 (the training path): `flash_bwd_prep` computes
//   D and lse·log2(e) into padded (BH, S_pad) rows and zeroes the dQ
//   counters; then `flash_bwd_wgmma`, one CTA per work item (KV row,
//   128-key tile), runs all five products on `wgmma`, S and dP once per
//   live tile pair.  Two warpgroups, each owning 64 of the item's keys (at
//   most 255 registers a thread, no spill).  K and V are loaded once, then
//   the G query heads' live 64-row query tiles (Q, dO, their lse and D) by
//   TMA through a two-stage ring, each stage completing on an mbarrier and
//   refilled two steps ahead once all eight warps have arrived on its
//   "read" barrier; one thread issues the copies.  (A producer warpgroup
//   with `setmaxnreg` was tried: ptxas held the 384-thread kernel to the
//   launch bound's 168 registers and the accumulators spilled.)  Per query
//   tile a warpgroup computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS m64n64k16, K
//   and Q K-major in the 128-byte swizzle the TMA writes), turns them in
//   registers into Pᵀ and dSᵀ (the accumulator layout of a k16 slice is
//   the A fragment's), adds dV += Pᵀ·dO and dK += dSᵀ·Q (RS, dO and Q read
//   MN-major through the transpose bit), and writes dSᵀ once to shared
//   memory (bf16, double-buffered); after a barrier of both warpgroups,
//   warpgroup w computes dQ_partial = dS·K for hd columns [64w, 64w + 64)
//   over the item's 128 keys (SS, both operands MN-major; at hd 64
//   warpgroup 0 alone).  A tile every pair of which is masked runs the
//   products all the same (on P = 0), so that every `wgmma` is issued on a
//   path the compiler sees as uniform.  dQ is summed across key tiles in a
//   fixed order with no second pass: query tile i's column half joins an
//   f32 workspace once a counter of (head, tile i, half) equals the item's
//   rank among tile i's live key tiles, in ascending key order.  The half
//   (64 × 64 f32) goes through shared memory in a swizzled dense layout
//   that the workspace shares (`half_pos`: conflict-free writes, one
//   16 KB bulk copy), which thread 0 of the warpgroup stores (the first
//   key tile) or adds (f32, one add an element: later ones); the copy is
//   waited for, fenced and the counter released at gpu scope one step
//   later, so no thread waits for its own copy.  The last key tile reads
//   the workspace, adds its partial in registers and rounds the half into
//   dq.  Items take tickets from an atomic counter in (key tile, KV row)
//   order, so every item an item waits for holds an earlier ticket and is
//   running or done (no deadlock: a pending release waits on nothing), and
//   under a causal mask the longest items start first.  An item walks its
//   query tiles from the last down, heads innermost, so the items that
//   feed one query tile reach it at the same step and wait little.
//   `schedule.py` beside the binding mirrors the ranges, ranks and order,
//   and the CPU tests hold them to a brute-force enumeration.  Every wait
//   on an mbarrier or a counter traps after ~2 s (a launch error, not a
//   hung card).
// * bf16 at hd 16 and 32: `mma.sync.m16n8k16` (see that section): dK/dV
//   in one CTA a 64-key tile, dQ in a second kernel that rebuilds S and dP.
// * f32: the CUDA cores, the same two kernels in scalar FMAs (1e-4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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

// ------------------------------------------- bf16, hd 16 / 32: mma.sync ----
//
// bf16 at hd 16 and 32 runs the products on the tensor cores with
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate), in the two kernels of the
// f32 path (dQ rebuilds S and dP): 4 warps a CTA, each warp
// owning 16 rows of the CTA's 64 (keys in dkdv, queries in dq).  Operand
// tiles sit in shared memory as bf16 rows padded by 8 elements (the 8 rows
// an `ldmatrix` reads fall on distinct banks);
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


// ------------------------------------------- bf16, hd 64 / 128: wgmma ----

constexpr int kWTQ = 64;           // query rows a streamed tile
constexpr int kWTK = 128;          // key rows a work item: two warpgroups of 64
constexpr int kWStages = 2;        // Q / dO tiles in flight
constexpr int kWThreads = 256;     // two warpgroups of 64 keys each
constexpr uint32_t kDSBytes = kWTK * kWTQ * 2;   // one dSᵀ buffer (bf16)
constexpr uint32_t kMetaBytes = kWTQ * 4;        // a tile's lse or D (f32)

// a dQ partial's column half: 64 rows of 64 f32, dense; the 16-byte chunk
// c of row r sits at chunk c ^ (r & 7) of the row (writes from the
// accumulator layout hit every bank once), in shared memory and in the
// workspace alike, so that one bulk copy moves it
constexpr int kHalf = kWTQ * 64;
__device__ __forceinline__ int half_pos(int r, int c) {
  return r * 64 + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// byte offsets in the CTA's shared memory (from a 1 KB aligned base)
template <int HD>
struct WLayout {
  static constexpr uint32_t kKV = kWTK * HD * 2;   // K or V tile
  static constexpr uint32_t kQ = kWTQ * HD * 2;    // Q or dO tile
  static constexpr uint32_t K = 0, V = kKV, Q0 = 2 * kKV;
  static constexpr uint32_t DS = Q0 + kWStages * 2 * kQ;   // two dSᵀ buffers
  static constexpr uint32_t DQ = DS + 2 * kDSBytes;       // dQ partial
  static constexpr uint32_t META = DQ + (HD / 64) * kHalf * 4;  // lse2, D
  static constexpr uint32_t BARS = META + kWStages * 2 * kMetaBytes;
  static constexpr uint32_t TICKET = BARS + 8 * (2 * kWStages + 1);
  static constexpr size_t kBytes = TICKET + 16 + 1024;
};

// the live 64-row query tiles [lo, hi] of 128-key tile kt (the forward's
// liveness test at these tile sizes; schedule.py mirrors it)
__device__ __forceinline__ void w_q_range(int kt, int nq, int causal,
                                          int window, int& lo, int& hi) {
  lo = causal ? (kWTK / kWTQ) * kt : 0;
  hi = nq - 1;
  if (window > 0) hi = min(hi, (window + kWTK * kt + kWTK - 2) / kWTQ);
}

// the live 128-key tiles [lo, hi] of 64-row query tile qi
__device__ __forceinline__ void w_k_range(int qi, int nk, int causal,
                                          int window, int& lo, int& hi) {
  hi = nk - 1;
  if (causal) hi = min(hi, (kWTQ * qi + kWTQ - 1) / kWTK);
  lo = 0;
  if (window > 0) {
    const int x = kWTQ * qi - (kWTK - 1) - window;
    if (x >= 0) lo = x / kWTK + 1;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
template <int N>
__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// D = rowsum(dO ∘ O) and lse·log2(e) of each padded row (zeros past S), as
// meta (2, BH, S_pad); zeroes the ticket and the dQ counters (n_sync ints)
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ meta, int* __restrict__ sync,
                          long long rows, int S, int S_pad, int n_sync) {
  const long long gid = (long long)blockIdx.x * 256 + threadIdx.x;
  if (gid < n_sync) sync[gid] = 0;
  const long long row = gid >> 5;   // one warp a padded row
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / S_pad;
  const int s = (int)(row % S_pad);
  float acc = 0.f;
  if (s < S) {
    const size_t r = (size_t)bh * S + s;
    for (int d = lane; d < HD; d += 32)
      acc += __bfloat162float(o[r * HD + d]) *
             __bfloat162float(dout[r * HD + d]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    meta[row] = s < S ? lse[(size_t)bh * S + s] * sm90::kLog2e : 0.f;
    meta[rows + row] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ meta,
                           float* __restrict__ dq_acc, int* __restrict__ sync,
                           __nv_bfloat16* __restrict__ dq,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int BH, int BKV,
                           int S, int causal, int window, int has_softcap,
                           float softcap, float scale) {
  using namespace sm90;
  using L = Swz<HD>;
  using M = WLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of the shared address
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  auto full_bar = [&](int st) { return base + M::BARS + 8 * st; };
  auto empty_bar = [&](int st) {
    return base + M::BARS + 8 * (kWStages + st);
  };
  const uint32_t kv_bar = base + M::BARS + 16 * kWStages;
  int* s_ticket = reinterpret_cast<int*>(gbase + M::TICKET);

  const int G = BH / BKV;
  const int nq = (S + kWTQ - 1) / kWTQ, nk = (S + kWTK - 1) / kWTK;
  const int S_pad = nq * kWTQ;
  if (threadIdx.x == 0) {
    *s_ticket = atomicAdd(sync, 1);
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 8);   // one arrival per warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tickets in (key tile, KV row) order: the items of a lower key tile,
  // which a query tile's dQ adds first, hold earlier tickets
  const int ticket = *s_ticket;
  const int kt = ticket / BKV, kvrow = ticket % BKV;
  const int k0 = kt * kWTK;
  int q_lo, q_hi;
  w_q_range(kt, nq, causal, window, q_lo, q_hi);
  // step i: query tile q_hi − i / G of head i % G
  const int n_steps = (q_hi - q_lo + 1) * G;

  // thread 0 issues every copy: K and V, then step i's Q, dO, lse and D
  // into stage i % kWStages once the step that used the stage before has
  // been read by all eight warps
  auto load_step = [&](int i) {
    const int st = i % kWStages;
    const int qi = q_hi - i / G, bh = kvrow * G + i % G;
    const uint32_t sq = base + M::Q0 + st * 2 * M::kQ;
    const uint32_t smeta = base + M::META + st * 2 * kMetaBytes;
    const float* mrow = meta + (size_t)bh * S_pad + qi * kWTQ;
    mbar_expect_tx(full_bar(st), 2 * M::kQ + 2 * kMetaBytes);
    tma_tile<HD, kWTQ>(&tq, qi * kWTQ, bh, sq, full_bar(st));
    tma_tile<HD, kWTQ>(&tdo, qi * kWTQ, bh, sq + M::kQ, full_bar(st));
    bulk_load(smeta, mrow, kMetaBytes, full_bar(st));
    bulk_load(smeta + kMetaBytes, mrow + (size_t)BH * S_pad, kMetaBytes,
              full_bar(st));
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * M::kKV);
    tma_tile<HD, kWTK>(&tk, k0, kvrow, base + M::K, kv_bar);
    tma_tile<HD, kWTK>(&tv, k0, kvrow, base + M::V, kv_bar);
    for (int i = 0; i < kWStages && i < n_steps; ++i) load_step(i);
  }

  // warpgroup w owns keys [k0 + 64w, k0 + 64w + 64) and dQ's hd columns
  // [64w, 64w + 64) (hd 64: warpgroup 0 all of them).  The warpgroup index
  // is broadcast from lane 0, so the compiler sees it warp-uniform.
  const int w = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int kw0 = k0 + 64 * w;
  // this thread's accumulator rows r0, r0 + 8; columns 8j + col2 (+1)
  const int r0 = 16 * warp + (lane >> 2), col2 = 2 * (lane & 3);
  const float c_exp = has_softcap ? kLog2e : scale * kLog2e;
  const bool does_dq = HD == 128 || w == 0;
  // the dQ add this warpgroup's thread 0 has issued and not yet released:
  // its counter's index in sync (-1: none); it releases rank + 1
  int pend = -1;
  auto release = [&]() {
    const int qp = ((pend - 1) >> 1) % nq;
    int lo, hi;
    w_k_range(qp, nk, causal, window, lo, hi);
    bulk_wait();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __threadfence();
    st_release(sync + pend, kt - lo + 1);
  };

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait_or_trap(kv_bar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kWStages;
    const int qi = q_hi - i / G, bh = kvrow * G + i % G;
    const int q0 = qi * kWTQ;
    const uint32_t sQ = base + M::Q0 + st * 2 * M::kQ, sdO = sQ + M::kQ;
    // K's and V's addresses, opaque to the compiler each step: their 16
    // descriptors are cheap to rebuild, and hoisted out of the loop they
    // would hold 32 registers the accumulators need
    uint32_t sK = base + M::K, sV = base + M::V;
    asm volatile("" : "+r"(sK), "+r"(sV));
    const float* lse2 = reinterpret_cast<const float*>(
        gbase + M::META + st * 2 * kMetaBytes);
    const float* Dr = lse2 + kWTQ;
    const uint32_t sDS = base + M::DS + (i & 1) * kDSBytes;
    uint8_t* gDS = gbase + M::DS + (i & 1) * kDSBytes;
    // no pair of this warpgroup's keys and the tile's queries masked:
    // skip the per-element test (a tile with every pair masked runs the
    // products all the same, on P = 0: the wgmma issue stays uniform)
    const bool full = kw0 + 64 <= S && q0 + kWTQ <= S &&
                      (!causal || kw0 + 63 <= q0) &&
                      (window <= 0 || q0 + kWTQ - 1 - kw0 < window);
    mbar_wait_or_trap(full_bar(st), (i / kWStages) & 1);

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys × queries), K-major operands
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (16 * kk / L::CB) * L::W,
                     in_row = (16 * kk % L::CB) * 2;
      wgmma_ss_m64n64(
          s,
          smem_desc(sK + col * kWTK + 64 * w * L::W + in_row, 16, 8 * L::W,
                    L::kLayout),
          smem_desc(sQ + col * kWTQ + in_row, 16, 8 * L::W, L::kLayout), kk);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (16 * kk / L::CB) * L::W,
                     in_row = (16 * kk % L::CB) * 2;
      wgmma_ss_m64n64(
          dp,
          smem_desc(sV + col * kWTK + 64 * w * L::W + in_row, 16, 8 * L::W,
                    L::kLayout),
          smem_desc(sdO + col * kWTQ + in_row, 16, 8 * L::W, L::kLayout), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // Pᵀ and dSᵀ as bf16 A fragments: k16 slice kk of the accumulator,
    // elements 8kk .. 8kk + 7, is the fragment's layout; element
    // 8kk + 2r + e sits at key row r0 + 8(r & 1), query column
    // 16kk + 8(r >> 1) + col2 + e
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = kw0 + r0 + 8 * (r & 1);
        const int qc = 16 * kk + 8 * (r >> 1) + col2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + qc);
        const float2 dd = *reinterpret_cast<const float2*>(Dr + qc);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[8 * kk + 2 * r + e];
          float x, dcap = 1.f;
          if (has_softcap) {
            const float t = tanhf(sv * scale / softcap);
            x = softcap * t * kLog2e;
            dcap = 1.f - t * t;
          } else {
            x = sv * c_exp;
          }
          bool ok = true;
          if (!full) {
            const int qpos = q0 + qc + e;
            ok = qpos < S && kpos < S;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && (qpos - kpos) < window;
          }
          const float pv = ok ? ex2(x - (e ? l2.y : l2.x)) : 0.f;
          p[e] = pv;
          ds[e] = pv * (dp[8 * kk + 2 * r + e] - (e ? dd.y : dd.x)) * dcap *
                  scale;
        }
        __nv_bfloat162 pb = __floats2bfloat162_rn(p[0], p[1]);
        __nv_bfloat162 db = __floats2bfloat162_rn(ds[0], ds[1]);
        pf[kk][r] = *reinterpret_cast<uint32_t*>(&pb);
        dsf[kk][r] = *reinterpret_cast<uint32_t*>(&db);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q: A from registers, B MN-major
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n<HD>(dv_acc, pf[kk],
                     smem_desc(sdO + 16 * kk * L::W, kWTQ * L::W, 8 * L::W,
                               L::kLayout),
                     1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n<HD>(dk_acc, dsf[kk],
                     smem_desc(sQ + 16 * kk * L::W, kWTQ * L::W, 8 * L::W,
                               L::kLayout),
                     1);
    wgmma_commit();

    // dSᵀ → shared memory once (rows = keys, 64 queries = 128 bytes a row,
    // 128-byte swizzle): the A operand of dQ = dS·K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 64 * w + r0 + 8 * (r & 1), chunk = 2 * kk + (r >> 1);
        *reinterpret_cast<uint32_t*>(gDS + row * 128 +
                                     ((chunk ^ (row & 7)) << 4) + 2 * col2) =
            dsf[kk][r];
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar<256>(1);   // both halves of dSᵀ are in shared memory

    // dQ_partial (queries × this warpgroup's hd columns) = dS·K over the
    // item's 128 keys; dS (MN-major: dSᵀ rows) and K (MN-major) both
    // through the transpose bits
    float dqp[32];
    if (does_dq) {
      fence_regs(dqp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWTK / 16; ++kk)
        wgmma_ss_m64n64<1, 1>(
            dqp, smem_desc(sDS + 16 * kk * 128, kWTK * 128, 1024, 1),
            smem_desc(sK + w * kWTK * L::W + 16 * kk * L::W, kWTK * L::W,
                      8 * L::W, L::kLayout),
            kk);
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    // Q, dO, lse and D of this stage are read: refill it two steps ahead
    if (lane == 0) mbar_arrive(empty_bar(st));
    if (threadIdx.x == 0 && i + kWStages < n_steps) {
      mbar_wait_or_trap(empty_bar(st), (i / kWStages) & 1);
      load_step(i + kWStages);
    }
    if (!does_dq) continue;
    fence_regs(dqp);

    // ---- the ordered dQ add of query tile qi, after the items of its
    // lower live key tiles (a counter per (head row, tile, column half));
    // thread 0 of the warpgroup waits, copies and releases ----
    int k_lo, k_hi;
    w_k_range(qi, nk, causal, window, k_lo, k_hi);
    const int rank = kt - k_lo;
    const bool last = kt == k_hi;
    const int cnt = 1 + (bh * nq + qi) * 2 + w;
    // the workspace's tile (bh, qi) holds its column halves one after the
    // other, each a dense 64 × 64 block in the `half_pos` layout
    float* ws = dq_acc + ((size_t)bh * S_pad + q0) * HD + w * kHalf;
    if (tid == 0) {
      // release the previous step's add: its bulk copy has had a step to
      // complete
      if (pend >= 0) {
        release();
        pend = -1;
      }
      if (rank > 0) {
        const long long t0 = clock64();
        while (ld_acquire(sync + cnt) != rank) {
          __nanosleep(32);
          if (clock64() - t0 > kWatchdogCycles) __trap();
        }
      }
    }
    // the counter is at this rank, and the shared partial of the previous
    // step has been read
    named_bar<128>(2 + w);
    if (last) {
      // the last key tile: workspace + partial, rounded into dq (a row
      // half at a time: fewer live registers)
      __nv_bfloat16* out = dq + ((size_t)bh * S + q0) * HD + 64 * w;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        float2 y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          y[j] = rank > 0 ? __ldcg(reinterpret_cast<const float2*>(
                                ws + half_pos(row, 8 * j + col2)))
                          : make_float2(0.f, 0.f);
        if (q0 + row >= S) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + row * HD + 8 * j + col2) =
              __floats2bfloat162_rn(y[j].x + dqp[4 * j + 2 * h],
                                    y[j].y + dqp[4 * j + 2 * h + 1]);
      }
      continue;
    }
    // not the last: the partial → shared memory (the half tile's layout)
    // → stored (rank 0) or added (f32, one add an element) into the
    // workspace by one bulk copy, released one step later
    float* part = reinterpret_cast<float*>(gbase + M::DQ) + w * kHalf;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(part + half_pos(r0 + 8 * h, 8 * j + col2)) =
            make_float2(dqp[4 * j + 2 * h], dqp[4 * j + 2 * h + 1]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar<128>(2 + w);
    if (tid == 0) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      const uint32_t src = base + M::DQ + w * kHalf * 4;
      if (rank == 0)
        bulk_store(ws, src, kHalf * 4);
      else
        bulk_reduce_add_f32(ws, src, kHalf * 4);
      bulk_commit();
      pend = cnt;
    }
  }
  if (tid == 0 && pend >= 0) release();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw0 + r0 + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* dkp = dk + ((size_t)kvrow * S + row) * HD + col2;
    __nv_bfloat16* dvp = dv + ((size_t)kvrow * S + row) * HD + col2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * j) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * j) = __floats2bfloat162_rn(
          dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// bf16 at hd 64 / 128: the prep kernel, then one CTA a (KV row, 128-key
// tile) item.  meta (2, BH, S_pad) f32, dq_acc (BH, S_pad, hd) f32 and sync
// (1 + BH·nq·2) int32 are the wrapper's workspace (S_pad = nq·64).
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* meta, void* dq_acc,
                 void* sync, void* dq, void* dk, void* dv, int BH, int BKV,
                 int S, int causal, int window, int has_softcap,
                 float softcap, float scale, cudaStream_t st) {
  if (meta == nullptr || dq_acc == nullptr || sync == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nq = (S + kWTQ - 1) / kWTQ, nk = (S + kWTK - 1) / kWTK;
  const int S_pad = nq * kWTQ;
  const long long rows = (long long)BH * S_pad;
  const long long n_sync = 1 + (long long)BH * nq * 2;
  const long long items = (long long)BKV * nk;
  if ((rows + 7) / 8 > 0x7fffffffLL || n_sync > 0x7fffffffLL ||
      items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int err_map = sm90::tensor_map<HD>(&tq, q, BH, S, kWTQ);
  if (err_map == 0) err_map = sm90::tensor_map<HD>(&tdo, dout, BH, S, kWTQ);
  if (err_map == 0) err_map = sm90::tensor_map<HD>(&tk, k, BKV, S, kWTK);
  if (err_map == 0) err_map = sm90::tensor_map<HD>(&tv, v, BKV, S, kWTK);
  if (err_map != 0) return err_map;

  flash_bwd_prep_kernel<HD><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(meta), static_cast<int*>(sync), rows, S, S_pad,
      (int)n_sync);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = WLayout<HD>::kBytes;
  err = allow_smem(flash_bwd_wgmma_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wgmma_kernel<HD><<<(unsigned)items, kWThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(meta),
      static_cast<float*>(dq_acc), static_cast<int*>(sync),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), BH, BKV, S, causal, window,
      has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

// f32 (CUDA cores) and bf16 at hd 16 / 32 (mma.sync): D, then dK/dV, then
// dQ; dvec (BH, S) f32 scratch
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

// the path of (dtype, hd), chosen explicitly: bf16 at hd 64 / 128 runs the
// wgmma kernel, bf16 at hd 16 / 32 the mma.sync kernels, f32 the CUDA-core
// kernels (kernel.py's `bwd_path` is the same choice)
template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const void* lse, void* dvec,
              void* dq_acc, void* sync, void* dq, void* dk, void* dv, int BH,
              int BKV, int S, int causal, int window, int has_softcap,
              float softcap, float scale, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                                  BKV, S, causal, window, has_softcap,
                                  softcap, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                                  BKV, S, causal, window, has_softcap,
                                  softcap, scale, st);
    case 64:
      if constexpr (kBf16)
        return launch_wgmma<64>(q, k, v, o, dout, lse, dvec, dq_acc, sync, dq,
                                dk, dv, BH, BKV, S, causal, window,
                                has_softcap, softcap, scale, st);
      else
        return launch<T, 64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH, BKV,
                             S, causal, window, has_softcap, softcap, scale,
                             st);
    case 128:
      if constexpr (kBf16)
        return launch_wgmma<128>(q, k, v, o, dout, lse, dvec, dq_acc, sync, dq,
                                 dk, dv, BH, BKV, S, causal, window,
                                 has_softcap, softcap, scale, st);
      else
        return launch<T, 128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH,
                              BKV, S, causal, window, has_softcap, softcap,
                              scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the first failing launch's cudaError_t (0 = success).  q, o, dout,
// dq (BH, S, hd); k, v, dk, dv (BKV, S, hd); lse (BH, S) f32; all
// contiguous and of one dtype (0 = float32, 1 = bfloat16) but the f32 ones;
// hd in {16, 32, 64, 128}; window <= 0 means no window; softcap is read
// only when has_softcap is set.  Workspace, by path (kernel.py's
// `bwd_workspace`): bf16 at hd 64 / 128 takes dvec (2, BH, S_pad) f32,
// dq_acc (BH, S_pad, hd) f32 and sync (1 + BH·nq·2) int32, S_pad = nq·64,
// nq = ⌈S / 64⌉; the other paths take dvec (BH, S) f32 and null dq_acc and
// sync.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq_acc, void* sync,
    void* dq, void* dk, void* dv, int BH, int BKV, int S, int hd, int dtype,
    int causal, int window, int has_softcap, float softcap, float scale,
    void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, dout, lse, dvec, dq_acc, sync, dq,
                            dk, dv, BH, BKV, S, causal, window, has_softcap,
                            softcap, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, dvec, dq_acc,
                                    sync, dq, dk, dv, BH, BKV, S, causal,
                                    window, has_softcap, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
