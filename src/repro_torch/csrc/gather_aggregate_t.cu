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
// destinations i in ascending (i, j) order), and here node u's
// destinations' rows are summed in that order, in f32 (each term
// __fdiv_rn(x, deg_i) for the mean), and rounded once: the same bits on
// every run and on every path, with no atomics.  Every node's row is
// written (zeros where it has no out-edge), so the output needs no fill.
//
// What bounds it on an H100: memory.  Each node reads its CSR slice and
// writes one row; each (u, i) pair reads one d_out row (often from L2).
// In GraphSAGE's layer 1 (F 128, bf16) most nodes of a sampled block have
// no out-edge, so the N × 256 B output write is most of the bound.  Two
// kernels, chosen by the wrapper (`kernel.aggt_mode`):
//   * aggt_vec (rows of 16-byte multiples, 16-byte aligned): L lanes a
//     node, L the power of two ≥ the row's 16-byte chunks (at most 32: a
//     wider row takes passes), so F 128 bf16 is 16 lanes and two nodes a
//     warp, each lane moving 8 bf16 a load and a store.  A node without
//     out-edges reads its two indptr words and stores zeros.  Otherwise its
//     lanes load up to L destinations and their degrees at once (one each),
//     broadcast them by shuffle, issue up to 8 destination rows' loads
//     before the first add, and add them in CSR order.  What bounds it now
//     is latency, not bytes: a node's indptr, destinations, degrees and
//     rows are four dependent loads, and in layer 1 of a sampled block 80 %
//     of the 169 984 nodes have no out-edge.  Hub nodes need no schedule of
//     their own: layer 1's largest out-degree is 139, and starting the
//     heaviest nodes first saved 4 % of the kernel for a sort that took
//     longer than the kernel; 32 nodes a warp with the busy ones first was
//     slower (the busy nodes are the block's low ids).
//   * aggt_kernel (any other F, or a view off its 16-byte alignment): one
//     warp a node, lanes on column pairs (or single columns), 4 groups a
//     lane, 256 columns a pass.
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

// 16 bytes of T as f32 values, and back
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 f = __bfloat1622float2(b);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr int kVecThreads = 256;

// L lanes a node (L = the power of two ≥ the row's C 16-byte chunks, at
// most 32: a wider row takes passes of L chunks), 32 / L nodes a warp;
// grid slot s sums node s
template <typename T, int L>
__global__ void __launch_bounds__(kVecThreads)
    aggt_vec_kernel(const T* __restrict__ d_out, const int* __restrict__ indptr,
                    const int* __restrict__ dst, const int* __restrict__ deg,
                    T* __restrict__ d_feat, int N, int C) {
  using V = Vec16<T>;
  constexpr int U = L < 8 ? L : 8;   // destination rows in flight
  const long long slot =
      ((long long)blockIdx.x * kVecThreads + threadIdx.x) / L;
  const int j = threadIdx.x & (L - 1);
  const bool valid = slot < N;
  int lo = 0, hi = 0;
  if (valid) {
    lo = indptr[slot];
    hi = indptr[slot + 1];
  }
  const uint4* src = reinterpret_cast<const uint4*>(d_out);
  uint4* out = reinterpret_cast<uint4*>(d_feat) + (size_t)slot * C;
  for (int c0 = 0; c0 < C; c0 += L) {   // warp-uniform passes
    const int c = c0 + j;
    const bool has_c = valid && c < C;
    float acc[V::E];
#pragma unroll
    for (int e = 0; e < V::E; ++e) acc[e] = 0.f;
    // every loop below runs alike in all lanes of the warp (the shuffles
    // need them); a group whose node has no entries left only predicates
    for (int k = lo; __any_sync(0xffffffffu, k < hi); k += L) {
      const int ent = k + j, n = hi - k;
      int my_i = 0;
      float my_dg = 1.f;
      if (ent < hi) {
        my_i = dst[ent];
        if (deg != nullptr) my_dg = (float)max(deg[my_i], 1);
      }
      for (int e0 = 0; e0 < L; e0 += U) {
        if (!__any_sync(0xffffffffu, e0 < n)) break;
        int ii[U];
        float dd[U];
        uint4 rv[U];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          ii[t] = __shfl_sync(0xffffffffu, my_i, e0 + t, L);
          dd[t] = __shfl_sync(0xffffffffu, my_dg, e0 + t, L);
        }
#pragma unroll
        for (int t = 0; t < U; ++t)
          if (has_c && e0 + t < n)
            rv[t] = __ldg(src + (size_t)ii[t] * C + c);
#pragma unroll
        for (int t = 0; t < U; ++t)
          if (has_c && e0 + t < n) {
            float v[V::E];
            V::unpack(rv[t], v);
#pragma unroll
            for (int e = 0; e < V::E; ++e)
              acc[e] += deg == nullptr ? v[e] : __fdiv_rn(v[e], dd[t]);
          }
      }
    }
    if (has_c) out[c] = V::pack(acc);
  }
}

template <typename T>
cudaError_t launch_vec(const T* g, const int* ip, const int* ds,
                       const int* dg, T* o, int N, int C, cudaStream_t st) {
  int L = 1;
  while (L < C && L < 32) L *= 2;
  const long long blocks =
      ((long long)N * L + kVecThreads - 1) / kVecThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned b = (unsigned)blocks;
  switch (L) {
    case 1: aggt_vec_kernel<T, 1><<<b, kVecThreads, 0, st>>>(g, ip, ds, dg, o, N, C); break;
    case 2: aggt_vec_kernel<T, 2><<<b, kVecThreads, 0, st>>>(g, ip, ds, dg, o, N, C); break;
    case 4: aggt_vec_kernel<T, 4><<<b, kVecThreads, 0, st>>>(g, ip, ds, dg, o, N, C); break;
    case 8: aggt_vec_kernel<T, 8><<<b, kVecThreads, 0, st>>>(g, ip, ds, dg, o, N, C); break;
    case 16: aggt_vec_kernel<T, 16><<<b, kVecThreads, 0, st>>>(g, ip, ds, dg, o, N, C); break;
    default: aggt_vec_kernel<T, 32><<<b, kVecThreads, 0, st>>>(g, ip, ds, dg, o, N, C); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* d_out, const void* indptr,
                         const void* dst, const void* deg, void* d_feat,
                         int N, int F, int mode, cudaStream_t st) {
  const T* g = static_cast<const T*>(d_out);
  const int* ip = static_cast<const int*>(indptr);
  const int* ds = static_cast<const int*>(dst);
  const int* dg = static_cast<const int*>(deg);
  T* o = static_cast<T*>(d_feat);
  if (mode == 16) {
    if ((F * (int)sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
    return launch_vec<T>(g, ip, ds, dg, o, N, F * (int)sizeof(T) / 16, st);
  }
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (mode == 2 && F % 2 == 0)
    aggt_kernel<T, 2><<<blocks, kWarpsPerBlock * 32, 0, st>>>(g, ip, ds, dg,
                                                              o, N, F);
  else if (mode == 1)
    aggt_kernel<T, 1><<<blocks, kWarpsPerBlock * 32, 0, st>>>(g, ip, ds, dg,
                                                              o, N, F);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 on
// success).  d_out and d_feat (N, F) of that dtype; indptr (N + 1,) and dst
// (nnz,) int32; deg (N,) int32 for the mean, null for the sum.  mode (the
// wrapper's `aggt_mode`): 16 = the 16-byte kernel (F·size a multiple of 16,
// both tensors 16-byte aligned); 2 = column pairs (F even, two-element
// aligned); 1 = single columns.
extern "C" int gather_aggregate_t_launch(const void* d_out, const void* indptr,
                                         const void* dst, const void* deg,
                                         void* d_feat, int N, int F, int dtype,
                                         int mode, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_typed<float>(d_out, indptr, dst, deg, d_feat, N, F,
                                       mode, st)
                 : launch_typed<__nv_bfloat16>(d_out, indptr, dst, deg, d_feat,
                                               N, F, mode, st);
  return (int)err;
}
