// EmbeddingBag over stacked tables: one warp per (bag, table).
//
// Replaces the TPU kernel `_bag_kernel` / `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/kernel.py).  Computes the same function,
// with a leading table axis so that DLRM's 26 lookups are one launch:
// tables (T, R, D), ids (B, T, H) int32, optional per-id weights (B, T, H)
// in the table's dtype → out (B, T, D) in the table's dtype, where
//   out[b, t] = Σ_h w[b, t, h] · tables[t, ids[b, t, h]]   over ids ≥ 0,
// divided by max(#valid ids, 1) for the mean combiner.  T = 1 is exactly
// the TPU kernel's case.  The sum is taken in f32 in h order; a weighted
// row is rounded to the table's dtype before it is added (the reference
// model's `rows * weights.astype(dtype)`), so at H = 1 the result equals
// the reference bit for bit in both dtypes.  An id ≥ R lies outside the
// contract (the reference reads out of bounds there); the kernel skips it
// and never reads past the table.
//
// What bounds it on an H100: memory.  Each valid id reads one D-element
// row (128 B for DLRM's bf16 D = 64) and each bag writes one row, with no
// arithmetic to speak of: DLRM's serve_bulk moves ~1.77 GB, ~0.53 ms at
// 3.35 TB/s.  The design keeps the reads coalesced and the rest out of
// device memory:
//   * the TPU kernel DMAs each row into a VMEM scratch row; here a warp's
//     lanes read consecutive column pairs (one 128-byte transaction for a
//     bf16 row of 64), and the accumulator lives in registers;
//   * the bag's ids (and weights) are read by every lane of the warp from
//     the same address, a broadcast served by L1;
//   * no shared memory and no block-level synchronisation: warps run
//     independently, 8 to a block, ~850 k blocks at serve_bulk.
// Wider loads, several bags per warp for small D, and prefetching the next
// bag's rows are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void load(const float* p, float* v, int n) {
  if (n == 2) {
    float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v, int n) {
  if (n == 2) {
    float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back (round to nearest even, as a cast in JAX).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, const float* v, int n) {
  if (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v, int n) {
  if (n == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// VEC columns per lane per step (2 when D is even, else 1).
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_kernel(const T* __restrict__ tables, const int* __restrict__ ids,
           const T* __restrict__ weights, T* __restrict__ out,
           long long n_bags, int T_, long long R, int D, int H, int mean) {
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int lane = threadIdx.x & 31;
  const int t = (int)(bag % T_);
  const T* table = tables + (size_t)t * (size_t)R * (size_t)D;
  const int* bag_ids = ids + bag * H;
  const T* bag_w = weights ? weights + bag * H : nullptr;
  T* dst = out + bag * (long long)D;

  int count = 0;
  for (int h = 0; h < H; ++h) {
    const int r = bag_ids[h];
    count += (r >= 0 && r < R);
  }
  const float denom = (float)(count > 0 ? count : 1);

  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool live = col < D;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int h = 0; h < H; ++h) {
      const int r = bag_ids[h];
      if (r < 0 || r >= R) continue;   // the same for every lane of the warp
      if (!live) continue;
      float v[VEC];
      load(table + (size_t)r * D + col, v, VEC);
      if (bag_w) {
        const float w = to_f32(bag_w[h]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] += round_to(__fmul_rn(w, v[e]), table);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += v[e];
      }
    }
    if (!live) continue;
    if (mean) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], denom);
    }
    store(dst + col, acc, VEC);
  }
}

template <typename T>
cudaError_t launch_typed(const void* tables, const void* ids,
                         const void* weights, void* out, long long n_bags,
                         int T_, long long R, int D, int H, int mean,
                         cudaStream_t stream) {
  const long long blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool pairs = (D % 2 == 0);
  const T* tab = static_cast<const T*>(tables);
  const int* id = static_cast<const int*>(ids);
  const T* w = static_cast<const T*>(weights);
  T* o = static_cast<T*>(out);
  if (pairs) {
    bag_kernel<T, 2><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        tab, id, w, o, n_bags, T_, R, D, H, mean);
  } else {
    bag_kernel<T, 1><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        tab, id, w, o, n_bags, T_, R, D, H, mean);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  weights may be null.  Returns the
// launch's cudaError_t (0 on success).  Pointers must be aligned to two
// elements when D is even (the wrapper checks).
extern "C" int embedding_bag_launch(const void* tables, const void* ids,
                                    const void* weights, void* out,
                                    long long n_bags, int T_, long long R,
                                    int D, int H, int dtype, int mean,
                                    void* stream) {
  if (n_bags <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch_typed<float>(tables, ids, weights, out, n_bags, T_, R, D,
                                H, mean, s)
          : launch_typed<__nv_bfloat16>(tables, ids, weights, out, n_bags, T_,
                                        R, D, H, mean, s);
  return (int)err;
}
