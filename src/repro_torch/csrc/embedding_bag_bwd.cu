// The backward of the embedding bag with respect to its tables: a
// deterministic segment reduction over ids sorted by (table, row).
//
// Replaces no TPU kernel: the reference trains DLRM through `jax.grad` of
// `jnp.take` (src/repro/models/embedding.py), and its Pallas kernel
// `_bag_kernel` has no VJP.  The port's forward runs the bag kernel
// (embedding_bag.cu) on every CUDA table, so its gradient is a kernel too.
// It computes, into a (T, R, D) gradient that the wrapper zero-fills,
//   d_tables[t, ids[b, t, h]] = Σ over (b, h) of c[b, t, h] · d_out[b, t],
// where c = w[b, t, h] (1 without weights), divided by the bag's count of
// valid ids for the mean; ids outside [0, R) add nothing, as in the
// forward.  The wrapper sorts the valid entries by key t·R + id with a
// stable sort, so each key's entries form one segment in ascending
// (b, h); here one warp reduces one segment in that order, in f32, and
// rounds once to the tables' dtype: the same bits on every run, with no
// atomics.  (The reference's bf16 scatter rounds after every add.)
//
// What bounds it on an H100: memory.  The dense zero fill of the gradient
// (3.3 GB for DLRM-RM2's 26 × 10⁶ × 64 bf16 tables) dwarfs the segments'
// reads of d_out rows (128 B each) and writes of touched rows; the fill is
// the wrapper's, this kernel moves only the touched rows.  Lanes take
// consecutive column pairs of a row (4-byte bf16 pairs, 8-byte f32 pairs)
// where D is even, one column where it is odd; one segment a warp, 8
// warps a block.
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

// seg_start (n_seg + 1) cuts `entry` (the sorted entries' flat (b, t, h)
// indices) into segments; seg_row[s] is segment s's flat row t·R + id of
// the (T·R, D) gradient; coef[e] the f32 factor of entry e; H ids a bag
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    embbwd_segment_kernel(const T* __restrict__ d_out,
                          const int* __restrict__ entry,
                          const float* __restrict__ coef,
                          const int* __restrict__ seg_start,
                          const long long* __restrict__ seg_row,
                          T* __restrict__ d_tables, int n_seg, int H, int D) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= n_seg) return;
  const int lane = threadIdx.x & 31;
  const int lo = seg_start[seg], hi = seg_start[seg + 1];
  T* dst = d_tables + seg_row[seg] * D;
  for (int c0 = lane * VEC; c0 < D; c0 += 32 * VEC) {
    float acc[VEC] = {};
    for (int k = lo; k < hi; ++k) {
      const int e = entry[k];
      const float c = coef[e];
      float v[VEC];
      load(d_out + (size_t)(e / H) * D + c0, v, VEC);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] = fmaf(c, v[u], acc[u]);
    }
    store(dst + c0, acc, VEC);
  }
}

template <typename T>
cudaError_t launch_typed(const void* d_out, const void* entry,
                         const void* coef, const void* seg_start,
                         const void* seg_row, void* d_tables, int n_seg,
                         int H, int D, cudaStream_t st) {
  const int blocks = (n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* g = static_cast<const T*>(d_out);
  const int* en = static_cast<const int*>(entry);
  const float* cf = static_cast<const float*>(coef);
  const int* ss = static_cast<const int*>(seg_start);
  const long long* sr = static_cast<const long long*>(seg_row);
  T* out = static_cast<T*>(d_tables);
  if (D % 2 == 0)
    embbwd_segment_kernel<T, 2><<<blocks, kWarpsPerBlock * 32, 0, st>>>(
        g, en, cf, ss, sr, out, n_seg, H, D);
  else
    embbwd_segment_kernel<T, 1><<<blocks, kWarpsPerBlock * 32, 0, st>>>(
        g, en, cf, ss, sr, out, n_seg, H, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 on
// success).  d_out (B·T, D) and d_tables (T·R, D) of that dtype, aligned to
// two elements when D is even (the wrapper checks); entry (n_entries,)
// int32; coef (B·T·H,) f32; seg_start (n_seg + 1,) int32; seg_row (n_seg,)
// int64.
extern "C" int embedding_bag_bwd_launch(const void* d_out, const void* entry,
                                        const void* coef, const void* seg_start,
                                        const void* seg_row, void* d_tables,
                                        int n_seg, int H, int D, int dtype,
                                        void* stream) {
  if (n_seg <= 0 || D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch_typed<float>(d_out, entry, coef, seg_start, seg_row,
                                d_tables, n_seg, H, D, st)
          : launch_typed<__nv_bfloat16>(d_out, entry, coef, seg_start, seg_row,
                                        d_tables, n_seg, H, D, st);
  return (int)err;
}
