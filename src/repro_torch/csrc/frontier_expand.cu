// Frontier expansion — one whole match level for a bucket of P patterns.
//
// Replaces the TPU kernel `_frontier_kernel` / `frontier_expand`
// (src/repro/kernels/frontier_expand/kernel.py).  Computes exactly the
// single-phase level of `repro_torch.core.matcher._expand_level_torch`: for
// every valid frontier row, gather the anchor's out- or in-CSR neighbours
// `chunk` at a time for `max_chunks` chunks, keep a lane iff label, min
// out/in degree, injectivity against the prefix and the bounded-bisection
// edge checks pass, and append survivors in (chunk, row, lane) order; rows
// past `cap` are dropped while `found` counts them all, and
// `ovf = found > cap`.
//
// What bounds it on an H100: the work is gathers, not arithmetic.  Each live
// lane reads one index word, a label and four indptr words, and each edge
// check a chain of `bisect_iters` dependent loads into the out-CSR — latency
// of dependent L2 hits (the CSR of a paper-size graph, ~17 MB, sits in the
// 50 MB L2), not bandwidth or FLOPs.  Degrees are skewed: one hub row of a
// paper graph has 165 chunks where most rows have one.  The TPU kernel
// pinned the CSR in VMEM and appended survivors serially in a fori_loop,
// relying on in-order grid steps; Hopper blocks run in no order, so the
// design here is three passes that keep the order without atomics:
//   (a) count:  one block per (pattern, tile of 256 rows); each warp owns 32
//               rows and walks the chunks in order, all 32 lanes evaluating
//               one row's chunk (two candidates each) and a ballot giving the
//               row's 64-bit survivor mask, so a hub row costs one warp step
//               per chunk; the block sums its survivors per chunk into one
//               counter per (pattern, chunk, tile).  Blocks past the valid
//               rows exit at once, so the work follows the frontier, not cap;
//   (b) scan:   one block per pattern computes the exclusive prefix of those
//               counters in (chunk, tile) order, plus found / out_count / ovf;
//   (c) write:  the same blocks recompute the masks, take each row's offset
//               from a block scan of the row counts plus the tile's prefix,
//               and write each survivor at offset plus its rank in the mask,
//               dropping rows >= cap.
// Scratch is P * max_chunks * ceil(cap / 256) counters.  The CSR stays in
// global memory (L2-resident); there is no size limit beyond the int32
// indexing the reference also has.  `chunk` is at most 64 (one mask word).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Graph {
  const int* labels;
  const int* out_indptr;
  const int* out_indices;
  const int* in_indptr;
  const int* in_indices;
  int n;
  int n_out;
  int n_in;
};

// plan row layout per pattern: anchor_pos, use_out, cand_label, min_out,
// min_in, check_out[k], check_in[k]
constexpr int kPlanScalars = 5;
constexpr int kRows = 256;           // rows per block in passes (a) and (c)
constexpr int kScanThreads = 1024;   // threads of the scan pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the reference's clipped, branchless search, exactly `iters` iterations
__device__ __forceinline__ bool edge_exists(const int* indptr, const int* indices,
                                            int last, int u, int v, int iters) {
  int lo = indptr[u];
  int hi = indptr[u + 1];
  for (int it = 0; it < iters; ++it) {
    int mid = (lo + hi) >> 1;
    int ms = clampi(mid, 0, last);
    bool go_right = (indices[ms] < v) && (lo < hi);
    lo = go_right ? mid + 1 : lo;
    hi = (go_right || lo >= hi) ? hi : mid;
  }
  int ls = clampi(lo, 0, last);
  return (lo < indptr[u + 1]) && (indices[ls] == v);
}

// candidate at offset `idx` of [out_indices ‖ in_indices]
__device__ __forceinline__ int candidate(const Graph& g, int idx) {
  idx = clampi(idx, 0, g.n_out + g.n_in - 1);
  return idx < g.n_out ? g.out_indices[idx] : g.in_indices[idx - g.n_out];
}

__device__ __forceinline__ bool survives(const Graph& g, const int* row,
                                         const int* plan, int k, int level,
                                         int bisect_iters, int idx) {
  int cand = candidate(g, idx);
  int cs = clampi(cand, 0, g.n - 1);
  if (g.labels[cs] != plan[2]) return false;
  if (g.out_indptr[cs + 1] - g.out_indptr[cs] < plan[3]) return false;
  if (g.in_indptr[cs + 1] - g.in_indptr[cs] < plan[4]) return false;
  for (int j = 0; j < level; ++j)
    if (cand == row[j]) return false;
  const int* check_out = plan + kPlanScalars;
  const int* check_in = check_out + k;
  int last = g.n_out - 1;
  for (int j = 0; j < level; ++j) {
    int prev = clampi(row[j], 0, g.n - 1);
    if (check_out[j] &&
        !edge_exists(g.out_indptr, g.out_indices, last, cs, prev, bisect_iters))
      return false;
    if (check_in[j] &&
        !edge_exists(g.out_indptr, g.out_indices, last, prev, cs, bisect_iters))
      return false;
  }
  return true;
}

// exclusive prefix of `v` over the block's threads in thread order; `*total`
// is the block's sum.  Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* warp_sums) {
  constexpr int kWarps = kThreads / 32;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

// (a) and (c).  Block (tile, p); thread t owns row tile * kRows + t, and its
// warp evaluates the chunks of the warp's 32 rows together.  `tile_sums` is
// (P, max_chunks, tiles): survivor totals after (a), exclusive prefixes
// after (b).
template <bool kWrite>
__global__ void __launch_bounds__(kRows)
expand_pass(Graph g, const int* __restrict__ emb, const int* __restrict__ count,
            const int* __restrict__ plan_rows, int cap, int k, int level,
            int chunk, int max_chunks, int bisect_iters,
            int* __restrict__ tile_sums, int* __restrict__ out_emb) {
  __shared__ int warp_sums[kRows / 32];
  const int p = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int n_valid = count[p];
  if (tile * kRows >= n_valid) return;  // block-uniform: no valid row here
  const int lane = threadIdx.x & 31;
  const int r0 = tile * kRows + (threadIdx.x & ~31);  // the warp's first row
  const int r = tile * kRows + threadIdx.x;
  const int* plan = plan_rows + (long long)p * (kPlanScalars + 2 * k);
  const int* my_row = emb + ((long long)p * cap + r) * k;

  // this thread's row: CSR offset of its anchor's list and its chunk count
  int my_start = 0, my_deg = 0;
  if (r < n_valid) {
    int a = clampi(my_row[plan[0]], 0, g.n - 1);
    if (plan[1]) {
      my_start = g.out_indptr[a];
      my_deg = g.out_indptr[a + 1] - my_start;
    } else {
      int s = g.in_indptr[a];
      my_deg = g.in_indptr[a + 1] - s;
      my_start = s + g.n_out;
    }
  }
  const int my_chunks = min(max_chunks, (my_deg + chunk - 1) / chunk);

  for (int c = 0; __syncthreads_or(c < my_chunks); ++c) {
    const int off0 = c * chunk;
    const int my_lanes = c < my_chunks ? min(chunk, my_deg - off0) : 0;
    // masks of the warp's rows with lanes in this chunk; lane j keeps row j's
    unsigned long long my_mask = 0;
    unsigned live = __ballot_sync(kFull, my_lanes > 0);
    for (unsigned todo = live; todo; todo &= todo - 1) {
      const int j = __ffs(todo) - 1;
      const int start = __shfl_sync(kFull, my_start, j) + off0;
      const int lanes = __shfl_sync(kFull, my_lanes, j);
      const int* row = emb + ((long long)p * cap + r0 + j) * k;
      bool s0 = lane < lanes &&
                survives(g, row, plan, k, level, bisect_iters, start + lane);
      bool s1 = lane + 32 < lanes &&
                survives(g, row, plan, k, level, bisect_iters, start + lane + 32);
      unsigned long long m = (unsigned long long)__ballot_sync(kFull, s0) |
                             ((unsigned long long)__ballot_sync(kFull, s1) << 32);
      if (lane == j) my_mask = m;
    }
    int total;
    int excl = block_exclusive_scan<kRows>(__popcll(my_mask), &total, warp_sums);
    long long slot = ((long long)p * max_chunks + c) * tiles + tile;
    if constexpr (!kWrite) {
      if (threadIdx.x == 0) tile_sums[slot] = total;
    } else {
      const int my_base = tile_sums[slot] + excl;
      for (unsigned todo = live; todo; todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        const int base = __shfl_sync(kFull, my_base, j);
        const unsigned long long m = __shfl_sync(kFull, my_mask, j);
        if (base >= cap || m == 0) continue;
        const int start = __shfl_sync(kFull, my_start, j) + off0;
        const int* row = emb + ((long long)p * cap + r0 + j) * k;
        for (int l = lane; l < 64; l += 32) {
          if (!((m >> l) & 1ull)) continue;
          int dest = base + __popcll(m & ((1ull << l) - 1ull));
          if (dest >= cap) continue;
          int cand = candidate(g, start + l);
          int* out = out_emb + ((long long)p * cap + dest) * k;
          for (int col = 0; col < k; ++col)
            out[col] = col == level ? cand : row[col];
        }
      }
    }
  }
}

// (b): exclusive scan of one pattern's (chunk, tile) counters, in place
__global__ void __launch_bounds__(kScanThreads)
scan_pass(int* __restrict__ tile_sums, int per_p, int cap,
          int* __restrict__ out_count, int* __restrict__ found,
          bool* __restrict__ ovf) {
  __shared__ int warp_sums[kScanThreads / 32];
  int* s = tile_sums + (long long)blockIdx.x * per_p;
  int carry = 0;
  for (int b = 0; b < per_p; b += kScanThreads) {
    int i = b + threadIdx.x;
    int v = i < per_p ? s[i] : 0;
    int total;
    int excl = block_exclusive_scan<kScanThreads>(v, &total, warp_sums);
    if (i < per_p) s[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) {
    found[blockIdx.x] = carry;
    out_count[blockIdx.x] = carry < cap ? carry : cap;
    ovf[blockIdx.x] = carry > cap;
  }
}

}  // namespace

// Counters the launch needs as scratch (`tile_sums`), in ints.
extern "C" long long frontier_expand_scratch(int P, int cap, int max_chunks) {
  return (long long)P * max_chunks * ((cap + kRows - 1) / kRows);
}

// Returns the cudaError_t of the launches (0 = success).  All pointers are
// device pointers; `out_emb` must be pre-filled with -1; `tile_sums` holds
// frontier_expand_scratch(P, cap, max_chunks) ints.  Launches on `stream`,
// does not synchronise.
extern "C" int frontier_expand_launch(
    const int* labels, const int* out_indptr, const int* out_indices,
    const int* in_indptr, const int* in_indices, int n, int n_out, int n_in,
    const int* emb, const int* count, const int* plan_rows, int P, int cap,
    int k, int level, int chunk, int max_chunks, int bisect_iters,
    int* tile_sums, int* out_emb, int* out_count, int* found, bool* ovf,
    void* stream) {
  if (chunk < 1 || chunk > 64 || P < 1 || P > 65535 || cap < 1)
    return (int)cudaErrorInvalidValue;
  Graph g{labels, out_indptr, out_indices, in_indptr, in_indices, n, n_out, n_in};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (cap + kRows - 1) / kRows;
  long long per_p = (long long)max_chunks * tiles;
  if (per_p > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      tile_sums, 0, sizeof(int) * (size_t)P * (size_t)per_p, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, P);
  expand_pass<false><<<grid, kRows, 0, s>>>(
      g, emb, count, plan_rows, cap, k, level, chunk, max_chunks,
      bisect_iters, tile_sums, out_emb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_pass<<<P, kScanThreads, 0, s>>>(tile_sums, (int)per_p, cap, out_count,
                                       found, ovf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  expand_pass<true><<<grid, kRows, 0, s>>>(
      g, emb, count, plan_rows, cap, k, level, chunk, max_chunks,
      bisect_iters, tile_sums, out_emb);
  return (int)cudaGetLastError();
}
