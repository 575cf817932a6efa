// Blocked attention with an online softmax, one CTA per (query head row,
// 64-row query tile).
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py).  Computes the same
// function: q (BH, S, hd), k/v (BKV, S, hd), query row i reads KV row
// i / G (G = BH / BKV); scores, the running max / sum / accumulator and
// p·V all in f32 (q, k and v are converted to f32 as they are staged, as
// the Pallas kernel casts its tiles); scale 1/sqrt(hd), optional tanh
// softcap, causal and sliding-window masks with -1e30; a key tile that no
// (query, key) pair of the block may attend is skipped by the Pallas
// kernel's own liveness test; the output is cast to q's dtype.  Any S is
// taken: rows past S are staged as zeros, masked as keys and not written
// as queries.
//
// What bounds it on an H100: at the serving shapes (S 1 024, hd 128) the
// work is ~2·S²·hd FLOPs per head against ~4·S·hd bytes, far above the
// card's ~295 FLOP/byte ridge, so it is compute-bound — and this first
// kernel runs on the f32 CUDA cores (67 TFLOP/s), not the tensor cores
// (989 TFLOP/s bf16), so it sits well above the bound.  The design keeps
// what the TPU kernel kept out of device memory out of it here too: the
// (64 × 64) score tile, the running statistics and the output accumulator
// never leave the SM.
//   * The Pallas grid's sequential k axis becomes a loop inside the CTA;
//     the Q tile is staged once, each live K/V tile once per CTA.
//   * 256 threads as a 16 × 16 grid: thread (ty, tx) owns score rows
//     ty + 16i and columns tx + 16j (i, j < 4), so a row's 16 owners are
//     one half-warp and its max and sum are two shuffle reductions.
//   * P goes through shared memory for the p·V product, where the same
//     thread owns output columns tx + 16j of the same four rows.
//   * Q and K rows are padded by 4 floats so the float4 reads of 16
//     different K rows fall in different banks.
//   * CTAs of the longest (last) causal query tiles are issued first.
// Tensor cores (wgmma), TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // key rows per tile
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 16;  // a warp's two P rows sit 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of a row-major (S, HD) matrix → shared memory as
// f32 with row stride ld; rows past S become zeros.  16-byte loads.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int S, float* dst, int ld) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = HD / E;
  for (int c = threadIdx.x; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * E;
    float vals[E];
    if (row0 + r < S) {
      load16(src + (size_t)(row0 + r) * HD + col, vals);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(dst + r * ld + col + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(2 * kBQ * (HD + 4) + kBK * HD + kBQ * kPStride) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int BH,
                      int S, int G, int causal, int window, int has_softcap,
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
  const T* qp = q + (size_t)bh * S * HD;
  const T* kp = k + (size_t)(bh / G) * S * HD;
  const T* vp = v + (size_t)(bh / G) * S * HD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(qp, q0, S, Qs, LDQ);

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
    load_tile<T, HD>(kp, k0, S, Ks, LDQ);
    load_tile<T, HD>(vp, k0, S, Vs, HD);
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
    T* out = o + ((size_t)bh * S + row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(out + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int G, int S, int causal, int window, int has_softcap,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)BH * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_kernel<T, HD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, S, G, causal, window,
      has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int BH, int G, int S, int causal, int window, int has_softcap,
              float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, BH, G, S, causal, window,
                                  has_softcap, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, G, S, causal, window,
                                  has_softcap, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, G, S, causal, window,
                                  has_softcap, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, G, S, causal, window,
                                    has_softcap, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  q, o (BH, S, hd);
// k, v (BKV, S, hd); all contiguous, 16-byte aligned, of one dtype
// (0 = float32, 1 = bfloat16); hd in {16, 32, 64, 128}; window <= 0 means
// no window; softcap is read only when has_softcap is set.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int BKV,
                                      int S, int hd, int dtype, int causal,
                                      int window, int has_softcap,
                                      float softcap, float scale,
                                      void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = BH / BKV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, BH, G, S, causal, window,
                            has_softcap, softcap, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, BH, G, S, causal, window,
                                    has_softcap, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
