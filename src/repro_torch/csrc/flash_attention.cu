// Blocked attention with an online softmax: bf16 on the tensor cores, f32
// on the CUDA cores.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py).  Computes the same
// function: q (BH, S, hd), k/v (BKV, S, hd), query row i reads KV row
// i / G (G = BH / BKV); scale 1/sqrt(hd), optional tanh softcap, causal and
// sliding-window masks, an online softmax whose running max, sum and output
// accumulator are f32; a key tile that no (query, key) pair of the block
// may attend is skipped by the Pallas kernel's own liveness test; the
// output is cast to q's dtype.  Any S is taken: rows past S are loaded as
// zeros, masked as keys and not written as queries.  CTAs of the longest
// (last) causal query tiles are issued first.
//
// What bounds it on an H100: at the serving shape (B 4, S 1 024, H 16,
// hd 128, causal) the work is 2·S²·hd FLOPs per head for each of q·kᵀ and
// p·v against ~4·S·hd bytes, far above the card's ~295 FLOP/byte ridge:
// the bound is the tensor cores' 989 TFLOP/s (bf16).  Each dtype has one
// kernel, chosen by `flash_attention_launch`:
//
// * bf16 (the serving path): one CTA per (head row, 128 query rows), two
//   warpgroups of 64 query rows each.  S = Q·Kᵀ is `wgmma` m64n64k16 with
//   Q and K bf16 in shared memory; P·V is `wgmma` m64n{hd}k16 with P taken
//   from registers (the f32 score fragment, softmaxed and rounded to bf16
//   in place: the accumulator layout of one k16 slice is the A-fragment
//   layout) and V read MN-major through the descriptor's transpose bit, so
//   V is never transposed.  Tiles are stored in the 32/64/128-byte swizzled
//   layout that the descriptors name (a 16-byte chunk's index XORed with
//   its row's bits), which is the layout a TMA tensor map of the same
//   swizzle writes: one thread issues `cp.async.bulk.tensor` per column
//   block, into a two-stage K/V ring whose stages each complete on an
//   mbarrier; tile t+1's copies go out right after tile t's Q·Kᵀ, one CTA
//   barrier a tile frees the stage they overwrite, and rows past S arrive
//   as zeros.  Mask, softcap and the online softmax work on the
//   accumulator fragment: thread (warp w, lane l) holds rows 16w + l/4 and
//   +8, columns 8j + 2(l%4) (+1), so a row's max and sum are two shuffles
//   within its quad; masked scores are -inf and a weight is one FFMA and
//   one ex2.  A warpgroup skips a tile dead for all its rows, and the
//   per-element mask where no pair is masked.  The row sum is taken from
//   the f32 P before it is rounded; P in bf16 costs a relative error of
//   ~2^-9 a weight against the reference's f32 P.  Shared memory: 97 KB at
//   hd 128; registers capped at 128 a thread, so two CTAs run on an SM.
//   One thread's TMA copies, not 8 `cp.async` a thread a tile: those
//   copies' issue was the kernel's largest cost.  What holds it back now:
//   each warpgroup's product → softmax → product chain is serial;
//   overlapping it (a third stage, a producer warp, one CTA an SM with more
//   registers) is the next step.
// * f32 (exactness against the f32 reference, 1e-5): the CUDA-core kernel
//   of the first port.  256 threads as a 16 × 16 grid over a 64 × 64 score
//   tile, scalar FMAs, masks as -1e30, P through shared memory; TF32 would
//   not hold 1e-5.
//
// Both kernels also write each query row's log-sum-exp of its scaled (and
// softcapped) scores, f32 (BH, S), when the caller passes an `lse` buffer:
// the training path's backward kernels (flash_attention_bwd.cu) rebuild P
// from it.  Serving passes none and stores nothing more.
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------- bf16 ----

constexpr int kTQ = 128;          // query rows per CTA: two warpgroups of 64
constexpr int kTK = 64;           // key rows per K/V tile
constexpr int kStages = 2;        // K/V tiles in flight in shared memory
constexpr int kTThreads = 256;

template <int HD>
constexpr size_t bf16_smem_bytes() {
  // Q, kStages stages of (K, V), their barriers and Q's, and slack to
  // align the base to 1 KB
  return (size_t)(kTQ + 2 * kStages * kTK) * HD * 2 + 8 * (kStages + 1) +
         1024;
}

// two CTAs an SM: registers capped at 128 a thread (hd 128 spills a few
// bytes; 12 % faster than one CTA an SM at the serving shape)
template <int HD>
__global__ void __launch_bounds__(kTThreads, 2)
    flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int BH, int S, int G,
                           int causal, int window, int has_softcap,
                           float softcap, float scale) {
  using L = Swz<HD>;
  constexpr uint32_t kQBytes = kTQ * HD * 2, kKVBytes = kTK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of the shared address
  const uint32_t sQ =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  auto sK = [&](int st) { return sQ + kQBytes + 2 * st * kKVBytes; };
  auto sV = [&](int st) { return sK(st) + kKVBytes; };
  // a barrier a stage (one arrival, which expects the stage's bytes), then Q's
  const uint32_t bars = sQ + kQBytes + 2 * kStages * kKVBytes;
  auto kv_bar = [&](int st) { return bars + 8 * st; };
  const uint32_t qbar = bars + 8 * kStages;

  const int nq = (S + kTQ - 1) / kTQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * kTQ;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  // this thread's rows of the score and output fragments: row0, row0 + 8
  const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int col2 = 2 * (lane & 3);

  // the live key tiles, an interval: the Pallas kernel's liveness test
  const int nk = (S + kTK - 1) / kTK;
  int kt_hi = nk - 1;
  if (causal) kt_hi = min(kt_hi, (q0 + kTQ - 1) / kTK);
  int kt_lo = 0;
  if (window > 0)
    while (kt_lo < kt_hi && q0 - (kt_lo * kTK + kTK - 1) >= window) ++kt_lo;

  // one thread sets up the barriers and loads Q and the first kStages - 1
  // live tiles; it also issues every later tile's loads
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages; ++j) mbar_init(kv_bar(j), 1);
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, kQBytes);
    tma_tile<HD, kTQ>(&tq, q0, bh, sQ, qbar);
    for (int j = 0; j < kStages - 1 && kt_lo + j <= kt_hi; ++j) {
      mbar_expect_tx(kv_bar(j), 2 * kKVBytes);
      tma_tile<HD, kTK>(&tk, (kt_lo + j) * kTK, bh / G, sK(j), kv_bar(j));
      tma_tile<HD, kTK>(&tv, (kt_lo + j) * kTK, bh / G, sV(j), kv_bar(j));
    }
  }
  mbar_wait(qbar, 0);

  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c_exp = has_softcap ? kLog2e : scale * kLog2e;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) % kStages;
    // tile kt has landed, and every warpgroup is done with tile kt - 1,
    // whose stage the next load overwrites
    mbar_wait(kv_bar(st), ((kt - kt_lo) / kStages) & 1);
    __syncthreads();

    // this warpgroup's rows [qlo, qlo + 64) against the tile's keys: dead
    // (every pair masked: skip both products), full (no pair masked: skip
    // the per-element tests) or mixed
    const int k0 = kt * kTK, qlo = q0 + 64 * wg;
    const bool dead = qlo >= S || (causal && k0 > qlo + 63) ||
                      (window > 0 && qlo - (k0 + kTK - 1) >= window);
    const bool full = k0 + kTK <= S && (!causal || k0 + kTK - 1 <= qlo) &&
                      (window <= 0 || qlo + 63 - k0 < window);

    // S = Q·Kᵀ for this warpgroup's 64 rows and the tile's 64 keys, issued
    // before the next tile's loads so that the copies overlap the product
    float s[32];
    if (!dead) {
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (16 * kk / L::CB) * L::W,
                       in_row = (16 * kk % L::CB) * 2;
        const uint64_t da =
            smem_desc(sQ + col * kTQ + 64 * wg * L::W + in_row, 16, 8 * L::W,
                      L::kLayout);
        const uint64_t db =
            smem_desc(sK(st) + col * kTK + in_row, 16, 8 * L::W, L::kLayout);
        wgmma_ss_m64n64(s, da, db, kk);
      }
      wgmma_commit();
    }
    const int next = kt + kStages - 1;
    if (threadIdx.x == 0 && next <= kt_hi) {
      const int sn = (next - kt_lo) % kStages;
      mbar_expect_tx(kv_bar(sn), 2 * kKVBytes);
      tma_tile<HD, kTK>(&tk, next * kTK, bh / G, sK(sn), kv_bar(sn));
      tma_tile<HD, kTK>(&tv, next * kTK, bh / G, sV(sn), kv_bar(sn));
    }
    if (dead) continue;
    wgmma_wait_all();
    fence_regs(s);

    // the softcap on the fragment (scale inside it), then the masks as
    // -inf; the row max is of these values, and a weight is
    // exp2(x·c − m·c) by one FFMA, c = log2(e) (· scale without softcap).
    // A row with no live key so far has m = -inf and takes 0 as its max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = s[i];
      if (has_softcap) x = softcap * tanhf(x * scale / softcap);
      if (!full) {
        const int kpos = k0 + 8 * (i >> 2) + col2 + (i & 1);
        const int qpos = row0 + 8 * h;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2], mc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = m_new == -INFINITY ? 1.f : ex2((m[h] - m_new) * c_exp);
      m[h] = m_new;
      mc[h] = m_new == -INFINITY ? 0.f : m_new * c_exp;
      l[h] *= corr[h];
    }
    // P in f32 (the row sums), then bf16 A fragments: k16 slice kk of the
    // accumulator, s[8kk .. 8kk + 7], is exactly the fragment's layout
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1;
        const float p0 = ex2(fmaf(s[8 * kk + 2 * r], c_exp, -mc[h]));
        const float p1 = ex2(fmaf(s[8 * kk + 2 * r + 1], c_exp, -mc[h]));
        l[h] += p0 + p1;
        __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        pf[kk][r] = *reinterpret_cast<uint32_t*>(&pb);
      }
    // rescale the output only where a row's max moved (warp-uniform test)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    }

    // O += P·V; V (keys × hd) is the MN-major B operand
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n<HD>(oacc, pf[kk],
                   smem_desc(sV(st) + 16 * kk * L::W, kTK * L::W, 8 * L::W,
                             L::kLayout), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    // log Σ exp(x) = (m·c + log2 l) / log2 e, x the scaled (softcapped) score
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * S + row] =
          m[h] == -INFINITY ? -INFINITY
                            : (m[h] * c_exp + log2f(l[h])) * (1.f / kLog2e);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out = o + ((size_t)bh * S + row) * HD + col2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          oacc[4 * j + 2 * h] * inv, oacc[4 * j + 2 * h + 1] * inv);
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr float kNegInf = -1e30f;

// 256 threads as a 16 × 16 grid: thread (ty, tx) owns score rows ty + 16i
// and columns tx + 16j (i, j < 4) of a 64 × 64 tile; P goes through shared
// memory for p·V; Q and K rows are padded by 4 floats against bank conflicts.
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // key rows per tile
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 16;  // a warp's two P rows sit 16 banks apart

// Rows [row0, row0 + 64) of a row-major (S, HD) f32 matrix → shared memory
// with row stride ld; rows past S become zeros.  16-byte loads.
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int row0, int S, float* dst, int ld) {
  constexpr int CPR = HD / 4;
  for (int c = threadIdx.x; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + col) =
        row0 + r < S
            ? *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + col)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int HD>
constexpr size_t f32_smem_bytes() {
  return (size_t)(2 * kBQ * (HD + 4) + kBK * HD + kBQ * kPStride) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int BH, int S, int G,
                          int causal, int window, int has_softcap,
                          float softcap, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LDQ = HD + 4;
  constexpr int NJ = HD / 16;
  float* Qs = reinterpret_cast<float*>(smem4);  // kBQ × LDQ
  float* Ks = Qs + kBQ * LDQ;                   // kBK × LDQ
  float* Vs = Ks + kBK * LDQ;                   // kBK × HD
  float* Ps = Vs + kBK * HD;                    // kBQ × kPStride

  const int nq = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - blockIdx.x / BH;
  const int q0 = qt * kBQ;
  const float* qp = q + (size_t)bh * S * HD;
  const float* kp = k + (size_t)(bh / G) * S * HD;
  const float* vp = v + (size_t)(bh / G) * S * HD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<HD>(qp, q0, S, Qs, LDQ);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // the Pallas kernel's block liveness test (uniform over the CTA)
    bool live = true;
    if (causal) live = k0 <= q0 + kBQ - 1;
    if (window > 0) live = live && (q0 - (k0 + kBK - 1) < window);
    if (!live) continue;

    __syncthreads();  // the previous tile's readers of Ks / Vs / Ps are done
    load_tile<HD>(kp, k0, S, Ks, LDQ);
    load_tile<HD>(vp, k0, S, Vs, HD);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(l[i]);
    float* out = o + ((size_t)bh * S + row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[tx + 16 * j] = acc[i][j] / denom;
  }
}


template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int G, int S, int causal, int window,
               int has_softcap, float softcap, float scale,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)BH * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_f32_kernel<HD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, BH, S, G,
      causal, window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}


template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int BH, int G, int S, int causal, int window,
                int has_softcap, float softcap, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err_map = tensor_map<HD>(&tq, q, BH, S, kTQ);
  if (err_map == 0) err_map = tensor_map<HD>(&tk, k, BH / G, S, kTK);
  if (err_map == 0) err_map = tensor_map<HD>(&tv, v, BH / G, S, kTK);
  if (err_map != 0) return err_map;
  const size_t smem = bf16_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bf16_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)BH * ((S + kTQ - 1) / kTQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_bf16_kernel<HD><<<(unsigned)blocks, kTThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, BH, S, G, causal,
      window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

#define REPRO_LAUNCH_HD(fn)                                                  \
  switch (hd) {                                                              \
    case 16: return fn<16>(q, k, v, o, lse_f, BH, G, S, causal, window,      \
                           has_softcap, softcap, scale, st);                 \
    case 32: return fn<32>(q, k, v, o, lse_f, BH, G, S, causal, window,      \
                           has_softcap, softcap, scale, st);                 \
    case 64: return fn<64>(q, k, v, o, lse_f, BH, G, S, causal, window,      \
                           has_softcap, softcap, scale, st);                 \
    case 128: return fn<128>(q, k, v, o, lse_f, BH, G, S, causal, window,    \
                             has_softcap, softcap, scale, st);               \
    default: return (int)cudaErrorInvalidValue;                              \
  }

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  q, o (BH, S, hd);
// k, v (BKV, S, hd); all contiguous, 16-byte aligned, of one dtype
// (0 = float32: the CUDA-core kernel; 1 = bfloat16: the tensor-core
// kernel); hd in {16, 32, 64, 128}; window <= 0 means no window; softcap is
// read only when has_softcap is set.  lse: null, or (BH, S) f32 that takes
// each row's log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int BH, int BKV, int S, int hd,
                                      int dtype, int causal, int window,
                                      int has_softcap, float softcap,
                                      float scale, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = BH / BKV;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) { REPRO_LAUNCH_HD(launch_f32) }
  if (dtype == 1) { REPRO_LAUNCH_HD(launch_bf16) }
  return (int)cudaErrorInvalidValue;
}
