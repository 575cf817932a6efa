// EmbeddingBag over stacked tables: 16-byte row loads, several bags a warp.
//
// Replaces the TPU kernel `_bag_kernel` / `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/kernel.py).  Computes the same function,
// with a leading table axis so that DLRM's 26 lookups are one launch:
// tables (T, R, D), ids (B, T, H) int32, optional per-id weights (B, T, H)
// in the table's dtype → out (B, T, D) in the table's dtype, where
//   out[b, t] = Σ_h w[b, t, h] · tables[t, ids[b, t, h]]   over 0 ≤ id < R,
// divided by max(#valid ids, 1) for the mean combiner.  T = 1 is exactly
// the TPU kernel's case.  The sum is taken in f32 in h order; a weighted
// row is rounded to the table's dtype before it is added (the reference
// model's `rows * weights.astype(dtype)`), so at H = 1 the result equals
// the reference bit for bit in both dtypes.  An id ≥ R lies outside the
// contract (the reference reads out of bounds there); the kernel skips it,
// as it skips a pad, and never reads past the table.
//
// What bounds it on an H100: memory.  Each valid id reads one D-element
// row (128 B for DLRM's bf16 D = 64) and each bag writes one row, with no
// arithmetic to speak of.  Random 128-byte rows need many loads in flight
// (Little's law at 3.35 TB/s and ~0.7 µs wants ~18 KB an SM), so:
//   * 16-byte loads and stores: G lanes cover a row (G = the power of two
//     at or above D·size/16, at most 32), so a warp serves 32/G bags side
//     by side (4 for bf16 D = 64, 2 for f32 D = 64);
//   * ids ahead of rows: for each h, one load by the warp fetches the ids
//     (and weights) of a step's 32/G · U bags (coalesced at H = 1), one
//     step ahead of the rows that need them, and shuffles hand them to the
//     groups; the count for the mean comes from the same ids, read once;
//   * U = min(4, G) rows in flight per lane (unrolled over bags), loaded
//     through the read-only path (ld.global.nc);
//   * streaming stores (st.global.cs): the outputs are read once, later;
//   * a persistent grid: as many blocks as fit at once walk the warp steps.
// Rows wider than 32 · 16 bytes take several column passes.  A D that is
// not a multiple of 16 bytes, or a table or output pointer that is not
// 16-byte aligned, takes the narrow kernel below (pairs of elements where
// D is even and the pointers allow, else one element a lane), chosen by
// the wrapper from shape and alignment before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back (round to nearest even, as a cast in JAX).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- the 16-byte path ----------------------------------------------------

// 16 bytes of T as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void unpack(uint4 x, float* v, const float*) {
  v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(uint4 x, float* v,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* v, const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bags per group in flight, U = min(4, G), so that a warp step's 32/G · U
// bags are at most 32 (one id a lane).
__host__ __device__ constexpr int bags_in_flight(int G) {
  return G < 4 ? G : 4;
}

// G lanes a row; each lane loads 16 bytes (E elements) of U bags at a time.
// A warp walks (step, column pass, h) triples; the ids of the next triple
// are loaded before the current triple's rows.
template <typename T, int G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_vec16_kernel(const T* __restrict__ tables, const int* __restrict__ ids,
                 const T* __restrict__ weights, T* __restrict__ out,
                 long long n_bags, int T_, long long R, int D, int H,
                 int mean) {
  constexpr int E = 16 / sizeof(T);
  constexpr int GROUPS = 32 / G;                    // bags side by side
  constexpr int U = bags_in_flight(G);
  constexpr int NB = GROUPS * U;                    // bags a warp step
  const int lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G;
  const int chunks = D / E;                         // 16-byte chunks a row
  const int hs = H > 0 ? H : 1;                     // H = 0: one empty pass
  const long long steps = (n_bags + NB - 1) / NB;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  // lane l loads the id (and weight) of the step's bag l at h
  auto fetch = [&](long long st, int h, int& id, float& w) {
    const long long bag = st * NB + lane;
    const bool ok = lane < NB && bag < n_bags && h < H;
    id = ok ? __ldg(ids + bag * H + h) : -1;
    w = (weights && ok) ? to_f32(weights[bag * H + h]) : 1.f;
  };
  long long st = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int c0 = 0, h = 0, my_id;
  float my_w;
  if (st < steps) fetch(st, 0, my_id, my_w);
  const T* table[U];
  float acc[U][E] = {};
  int cnt[U] = {};
  while (st < steps) {
    long long nst = st;
    int nc0 = c0, nh = h + 1;
    if (nh == hs) {
      nh = 0;
      nc0 += G;
      if (nc0 >= chunks) { nc0 = 0; nst += stride; }
    }
    int next_id = -1;
    float next_w = 1.f;
    if (nst < steps) fetch(nst, nh, next_id, next_w);
    const long long b0 = st * NB;
    if (h == 0) {
      const int t0 = (int)(b0 % T_);
#pragma unroll
      for (int u = 0; u < U; ++u)
        table[u] = tables +
                   (size_t)((t0 + u * GROUPS + g) % T_) * (size_t)R * (size_t)D;
    }
    const int ch = c0 + gl;
    const bool col = ch < chunks;
    int r[U];
    float w[U];
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      r[u] = __shfl_sync(0xffffffffu, my_id, u * GROUPS + g);
      w[u] = __shfl_sync(0xffffffffu, my_w, u * GROUPS + g);
      if (r[u] >= R) r[u] = -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = (r[u] >= 0 && col)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       table[u] + (size_t)r[u] * D) + ch)
                 : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r[u] < 0) continue;
      ++cnt[u];
      float v[E];
      unpack(x[u], v, tables);
      if (weights) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[u][e] += round_to(__fmul_rn(w[u], v[e]), tables);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[u][e] += v[e];
      }
    }
    if (h == hs - 1 && col) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long bag = b0 + u * GROUPS + g;
        if (bag >= n_bags) continue;
        if (mean) {
          const float denom = (float)(cnt[u] > 0 ? cnt[u] : 1);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[u][e] = __fdiv_rn(acc[u][e], denom);
        }
        __stcs(reinterpret_cast<uint4*>(out + bag * (long long)D) + ch,
               pack(acc[u], tables));
      }
    }
    if (nh == 0) {   // a new column pass or step starts from zero
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cnt[u] = 0;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
      }
    }
    st = nst; c0 = nc0; h = nh; my_id = next_id; my_w = next_w;
  }
}

// ---- the narrow path: one warp per (bag, table) ------------------------------

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

// VEC columns per lane per step (2 when D is even and the pointers are
// aligned to two elements, else 1).
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

struct Args {
  const void* tables;
  const void* ids;
  const void* weights;
  void* out;
  long long n_bags;
  int T_;
  long long R;
  int D, H, mean;
  cudaStream_t stream;
};

template <typename T, int G>
cudaError_t launch_vec16(const Args& a) {
  auto kernel = bag_vec16_kernel<T, G>;
  constexpr int NB = 32 / G * bags_in_flight(G);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarpsPerBlock * 32, 0);
  if (err != cudaSuccess) return err;
  const long long steps = (a.n_bags + NB - 1) / NB;
  const long long needed = (steps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
  kernel<<<blocks, kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const T*>(a.tables), static_cast<const int*>(a.ids),
      static_cast<const T*>(a.weights), static_cast<T*>(a.out), a.n_bags,
      a.T_, a.R, a.D, a.H, a.mean);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_narrow(const Args& a) {
  const long long blocks = (a.n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bag_kernel<T, VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const T*>(a.tables), static_cast<const int*>(a.ids),
      static_cast<const T*>(a.weights), static_cast<T*>(a.out), a.n_bags,
      a.T_, a.R, a.D, a.H, a.mean);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
cudaError_t launch_typed(const Args& a, int load_bytes) {
  const int row_bytes = a.D * (int)sizeof(T);
  const bool fits = row_bytes % load_bytes == 0 &&
                    aligned(a.tables, load_bytes) && aligned(a.out, load_bytes);
  if (!fits) return cudaErrorInvalidValue;
  if (load_bytes == 16) {
    const int chunks = row_bytes / 16;
    if (chunks <= 1) return launch_vec16<T, 1>(a);
    if (chunks <= 2) return launch_vec16<T, 2>(a);
    if (chunks <= 4) return launch_vec16<T, 4>(a);
    if (chunks <= 8) return launch_vec16<T, 8>(a);
    if (chunks <= 16) return launch_vec16<T, 16>(a);
    return launch_vec16<T, 32>(a);
  }
  if (load_bytes == 2 * (int)sizeof(T)) return launch_narrow<T, 2>(a);
  if (load_bytes == (int)sizeof(T)) return launch_narrow<T, 1>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  weights may be null.  load_bytes picks
// the path: 16 (the 16-byte kernel), two elements or one (the narrow
// kernel); D·size and the tables and out pointers must be multiples of it.
// Returns the launch's cudaError_t (0 on success).
extern "C" int embedding_bag_launch(const void* tables, const void* ids,
                                    const void* weights, void* out,
                                    long long n_bags, int T_, long long R,
                                    int D, int H, int dtype, int mean,
                                    int load_bytes, void* stream) {
  if (n_bags <= 0 || D <= 0) return 0;
  const Args a{tables, ids, weights, out, n_bags, T_, R, D, H, mean,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = dtype == 0 ? launch_typed<float>(a, load_bytes)
                               : launch_typed<__nv_bfloat16>(a, load_bytes);
  return (int)err;
}
