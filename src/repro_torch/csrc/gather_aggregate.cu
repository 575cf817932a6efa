// Padded-neighbour gather-aggregate (the GNN's SpMM): one warp per node.
//
// Replaces the TPU kernel `_agg_kernel` / `gather_aggregate_pallas`
// (src/repro/kernels/gather_aggregate/kernel.py).  Computes the same
// function: features (N, F), nbrs (N, Dmax) int32 with pad −1 → out (N, F)
// in the features' dtype,
//   out[i] = Σ_j features[nbrs[i, j]]   over nbrs[i, j] ≥ 0,
// accumulated in f32 in j order, divided by max(#valid, 1) for the mean.
// An id ≥ N lies outside the contract; the kernel skips it and never reads
// past the features.
//
// What bounds it on an H100: memory.  Each valid neighbour reads one
// feature row (1 204 B for GraphSAGE-reddit's bf16 F = 602), each node
// reads its table row and writes one output row; ~1 FLOP per byte.  The
// TPU kernel holds the whole feature matrix in VMEM and walks a node block
// in order; here every warp works alone and reads rows from device memory
// (or L2, where neighbours repeat):
//   * a node's ids are read once, 32 at a time, one per lane; a ballot
//     gives the valid ones, so a row of pads (≥ 85 % of a sampled block's
//     table: only seeds and hop-1 nodes have in-edges) costs one read of
//     its ids and one write of zeros;
//   * the valid ids are visited in j order by walking the ballot's bits,
//     each broadcast from its lane with a shuffle, so the f32 sum is the
//     reference's sequential one;
//   * lanes read consecutive column pairs (4-byte bf16 pairs, 8-byte f32
//     pairs): F = 602 bf16 rows are only 4-byte aligned, so 16-byte
//     vectors would need a scalar tail; pairs need none when F is even
//     (an odd F takes one column per lane);
//   * 8 columns per lane are live at once (4 pairs), 256 columns a pass:
//     F = 602 takes three passes over a node's neighbours.
// 16-byte loads with a peeled tail, and keeping more of a row in flight,
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;   // column groups per lane per pass

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
agg_kernel(const T* __restrict__ feat, const int* __restrict__ nbrs,
           T* __restrict__ out, int N, int F, int Dmax, int mean) {
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (node >= N) return;
  const int lane = threadIdx.x & 31;
  const int* row_ids = nbrs + (size_t)node * Dmax;
  T* dst = out + (size_t)node * F;

  int count = 0;
  for (int base = 0; base < Dmax; base += 32) {
    const int j = base + lane;
    const int id = j < Dmax ? row_ids[j] : -1;
    count += __popc(__ballot_sync(0xffffffffu, id >= 0 && id < N));
  }
  constexpr int kStep = 32 * VEC;            // columns of one group
  constexpr int kPass = kStep * kUnroll;     // columns of one pass
  if (count == 0) {
    const float zero[VEC] = {};
    for (int col = lane * VEC; col < F; col += kStep) store(dst + col, zero, VEC);
    return;
  }
  const float denom = (float)count;

  for (int c0 = 0; c0 < F; c0 += kPass) {
    float acc[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
    for (int base = 0; base < Dmax; base += 32) {
      const int j = base + lane;
      const int id = j < Dmax ? row_ids[j] : -1;
      unsigned valid = __ballot_sync(0xffffffffu, id >= 0 && id < N);
      while (valid) {
        const int src_lane = __ffs(valid) - 1;
        valid &= valid - 1;
        const int src = __shfl_sync(0xffffffffu, id, src_lane);
        const T* row = feat + (size_t)src * F;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int col = c0 + u * kStep + lane * VEC;
          if (col < F) {
            float v[VEC];
            load(row + col, v, VEC);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[u][e] += v[e];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = c0 + u * kStep + lane * VEC;
      if (col < F) {
        if (mean) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[u][e] = __fdiv_rn(acc[u][e], denom);
        }
        store(dst + col, acc[u], VEC);
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* feat, const void* nbrs, void* out, int N,
                         int F, int Dmax, int mean, cudaStream_t stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* f = static_cast<const T*>(feat);
  const int* nb = static_cast<const int*>(nbrs);
  T* o = static_cast<T*>(out);
  if (F % 2 == 0) {
    agg_kernel<T, 2><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        f, nb, o, N, F, Dmax, mean);
  } else {
    agg_kernel<T, 1><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        f, nb, o, N, F, Dmax, mean);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 on
// success).  Pointers must be aligned to two elements when F is even (the
// wrapper checks).
extern "C" int gather_aggregate_launch(const void* feat, const void* nbrs,
                                       void* out, int N, int F, int Dmax,
                                       int dtype, int mean, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch_typed<float>(feat, nbrs, out, N, F, Dmax, mean, s)
          : launch_typed<__nv_bfloat16>(feat, nbrs, out, N, F, Dmax, mean, s);
  return (int)err;
}
