// The transpose of the padded-neighbour gather-aggregate: the gradient of
// the GNN's SpMM with respect to its features, as a gather over the
// out-neighbour table.
//
// Replaces no TPU kernel: the reference trains GraphSAGE through `jax.grad`
// of `gather` + `segment_sum` / `scatter_mean` (src/repro/models/gnn/
// common.py), and its Pallas kernel `_agg_kernel` has no VJP.  The port's
// forward runs the gather-aggregate kernel (gather_aggregate.cu) on every
// CUDA tensor, so its gradient is a kernel too.  For the forward
// out[i] = Σ_j features[nbrs[i, j]] (÷ deg_i for the mean) it computes
//   d_features[u] = Σ over (i, j) with nbrs[i, j] = u of d_out[i] (÷ deg_i),
// where deg_i counts row i's valid ids.  The scatter is turned into a
// gather: the wrapper builds the out-neighbour table of the in-neighbour
// table on the card with a stable sort (CSR: indptr over u, the
// destinations i in ascending (i, j) order), and here one warp sums node
// u's destinations' rows in that order, in f32, and rounds once: the same
// bits on every run, with no atomics.  Every node's row is written (zeros
// where it has no out-edge), so the output needs no fill.
//
// What bounds it on an H100: memory, as the forward.  Each (u, i) pair
// reads one d_out row (1 204 B for GraphSAGE-reddit's bf16 F = 602, often
// from L2 where a row has many sources), each node reads its CSR slice and
// writes one row.  Lanes take consecutive column pairs (4-byte bf16 pairs)
// where F is even, one column where it is odd; 4 column groups a lane are
// live at once, 256 columns a pass over u's destinations; one node a warp,
// 8 warps a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

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
    aggt_kernel(const T* __restrict__ d_out, const int* __restrict__ indptr,
                const int* __restrict__ dst, const int* __restrict__ deg,
                T* __restrict__ d_feat, int N, int F) {
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (u >= N) return;
  const int lane = threadIdx.x & 31;
  const int lo = indptr[u], hi = indptr[u + 1];
  T* out = d_feat + (size_t)u * F;
  constexpr int kStep = 32 * VEC;
  constexpr int kPass = kStep * kUnroll;
  for (int c0 = 0; c0 < F; c0 += kPass) {
    float acc[kUnroll][VEC];
#pragma unroll
    for (int g = 0; g < kUnroll; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    for (int k = lo; k < hi; ++k) {
      const int i = dst[k];
      const float dg = deg == nullptr ? 1.f : (float)max(deg[i], 1);
      const T* row = d_out + (size_t)i * F;
#pragma unroll
      for (int g = 0; g < kUnroll; ++g) {
        const int col = c0 + g * kStep + lane * VEC;
        if (col < F) {
          float v[VEC];
          load(row + col, v, VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] += deg == nullptr ? v[e] : __fdiv_rn(v[e], dg);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kUnroll; ++g) {
      const int col = c0 + g * kStep + lane * VEC;
      if (col < F) store(out + col, acc[g], VEC);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* d_out, const void* indptr,
                         const void* dst, const void* deg, void* d_feat,
                         int N, int F, cudaStream_t st) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* g = static_cast<const T*>(d_out);
  const int* ip = static_cast<const int*>(indptr);
  const int* ds = static_cast<const int*>(dst);
  const int* dg = static_cast<const int*>(deg);
  T* o = static_cast<T*>(d_feat);
  if (F % 2 == 0)
    aggt_kernel<T, 2><<<blocks, kWarpsPerBlock * 32, 0, st>>>(g, ip, ds, dg,
                                                              o, N, F);
  else
    aggt_kernel<T, 1><<<blocks, kWarpsPerBlock * 32, 0, st>>>(g, ip, ds, dg,
                                                              o, N, F);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 on
// success).  d_out and d_feat (N, F) of that dtype, aligned to two elements
// when F is even (the wrapper checks); indptr (N + 1,) and dst (nnz,)
// int32; deg (N,) int32 for the mean, null for the sum.
extern "C" int gather_aggregate_t_launch(const void* d_out, const void* indptr,
                                         const void* dst, const void* deg,
                                         void* d_feat, int N, int F, int dtype,
                                         void* stream) {
  if (N <= 0 || F <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_typed<float>(d_out, indptr, dst, deg, d_feat, N, F, st)
                 : launch_typed<__nv_bfloat16>(d_out, indptr, dst, deg, d_feat,
                                               N, F, st);
  return (int)err;
}
