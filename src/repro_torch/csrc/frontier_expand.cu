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
// What bounds it on an H100: the work is gathers, not arithmetic.  Each
// candidate reads its id, a label and four indptr words, and each edge
// check a chain of `bisect_iters` dependent loads into the out-CSR: latency
// of random L2 hits (the CSR of a paper-size graph, ~18 MB, sits in the
// 50 MB L2), which only many threads in flight can hide.  Degrees are
// skewed: a frontier may hold few rows and many candidates (mico's hub
// block: 35 k rows, 25 M candidates, one row of 4 823).  The TPU kernel
// pinned the CSR in VMEM and appended survivors serially, relying on
// in-order grid steps; Hopper blocks run in no order.  So the work is split
// by candidates, not rows, and the order is rebuilt from survivor bits:
//   plan (tiles → offsets; one host read of the totals between the halves)
//   1. tiles:  the first warp tile of each pattern (32 rows a tile);
//   2. sums:   one thread per valid row: its anchor's candidates
//              min(deg, max_chunks·chunk) and chunks, summed by warp over
//              the tile (candidates, slots — one per (row, chunk) — and
//              the tile's largest chunk count);
//   3. scan:   one block scans the tiles' candidates, slots and tile-chunk
//              entries (a tile's largest chunk count) into int64 offsets
//              and writes the totals;
//   run (scratch sized by those totals)
//   4. rows:   one warp per tile: each row's CSR start, and its candidate
//              and slot offsets within the tile by warp scans, at the
//              row's compact index (tile · 32 + lane);
//   5. eval:   one thread per candidate of the flat candidate space; it
//              finds its tile and row by binary search over the offsets
//              and evaluates its predicate once.  A warp's lanes that share
//              a (row, chunk) slot are consecutive, so their survivor bits
//              are one ballot, and-ed with `__match_any_sync` of the slot,
//              shifted into the slot's 64-bit mask with one atomicOr;
//   6. tile:   one warp per tile sums the popcounts of each chunk c over
//              its rows (a warp reduction, no block barrier);
//   7. cross:  one block per (chunk, pattern) scans those sums over the
//              pattern's tiles that reach chunk c;
//   8. chunks: one block per pattern scans its chunk totals: the chunk
//              bases, found, out_count and ovf;
//   9. write:  one warp per tile walks its chunks; the tile's survivors of
//              chunk c sit at chunk base + the tile's cross offset + their
//              rank in (row, bit) order, and the warp's lanes take 32 of
//              them at a time (row by a search over the warp's exclusive
//              scan of popcounts, bit by a select); only the candidate id
//              is read again, and ranks >= cap are dropped.
// A hub row spreads over as many blocks as it has candidates; a row of
// degree 3 takes 3 threads.  Scratch: the plan's 32 bytes a warp tile of
// the (P, cap) table (one byte a table row: its size must be known before
// the totals are), and, sized by the frontier's own totals, 16 bytes a row
// of the valid tiles, 8 a (row, chunk) slot, 4 a tile chunk and 8 a
// (pattern, chunk).  Offsets into the candidate space are int64.  `chunk`
// is at most 64 (one mask word).  Every kernel's name starts with
// `frontier_`, which profiles use to sum the launch's device time.
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
constexpr int kTile = 32;            // rows of a warp tile
constexpr int kBlock = 256;          // threads of the row / eval / tile passes
constexpr int kScan = 1024;          // threads of the single-block scans
constexpr unsigned kFull = 0xffffffffu;

// The plan scratch, carved from one buffer (`frontier_expand_plan_bytes`),
// and the rows' part of the run scratch.  Per-row arrays are indexed by the
// row's compact index, tile · 32 + lane, over the valid tiles only.
struct PlanScratch {
  long long* wt_cand;   // NWmax: a tile's candidates, then their exclusive prefix
  long long* wt_slot;   // NWmax: its (row, chunk) slots, then prefix
  long long* wt_tc;     // NWmax: its tile-chunk entries, then prefix
  int* wt_maxch;        // NWmax: its rows' largest chunk count
  int* wt_p;            // NWmax: its pattern
  int* wt_base;         // P + 1: a pattern's first tile
  int* r_start;         // 32·nw: a row's first candidate in [out ‖ in] indices
  int* r_cand;          // 32·nw: candidates before the row within its tile
  int* r_slot;          // 32·nw: slots before the row within its tile
  int* r_nch;           // 32·nw: the row's chunk count
};

inline size_t align256(size_t x) {
  return (x + 255) & ~(size_t)255;
}

// carves a buffer in order; `take<T>(n)` returns the next n elements
struct Carver {
  char* b;
  size_t off = 0;
  template <typename T>
  T* take(size_t n) {
    char* p = b + off;
    off += align256(n * sizeof(T));
    return reinterpret_cast<T*>(p);
  }
};

// the plan's tile arrays; with `rows_buf`, also the per-row arrays of nw
// valid tiles
PlanScratch carve(void* plan_buf, int P, int cap, void* rows_buf = nullptr,
                  size_t nw = 0) {
  const size_t nw_max = (size_t)P * ((cap + kTile - 1) / kTile);
  Carver c{static_cast<char*>(plan_buf)};
  PlanScratch s{};
  s.wt_cand = c.take<long long>(nw_max);
  s.wt_slot = c.take<long long>(nw_max);
  s.wt_tc = c.take<long long>(nw_max);
  s.wt_maxch = c.take<int>(nw_max);
  s.wt_p = c.take<int>(nw_max);
  s.wt_base = c.take<int>((size_t)P + 1);
  if (rows_buf != nullptr) {
    Carver r{static_cast<char*>(rows_buf)};
    s.r_start = r.take<int>(nw * kTile);
    s.r_cand = r.take<int>(nw * kTile);
    s.r_slot = r.take<int>(nw * kTile);
    s.r_nch = r.take<int>(nw * kTile);
  }
  return s;
}

size_t plan_bytes(int P, int cap) {
  const size_t nw_max = (size_t)P * ((cap + kTile - 1) / kTile);
  return 3 * align256(nw_max * 8) + 2 * align256(nw_max * 4) +
         align256((size_t)(P + 1) * 4);
}

size_t rows_bytes(size_t nw) {
  return 4 * align256(nw * kTile * 4);
}

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

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// exclusive prefix of `v` over the block's threads in thread order; `*total`
// is the block's sum.  Every thread of the block must call it.
template <int kThreads, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total, T* warp_sums) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sums[lane] : T(0);
    w = warp_inclusive_scan(w);
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  T excl = x - v + (warp > 0 ? warp_sums[warp - 1] : T(0));
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

// 1. tiles: wt_base[p] = Σ_{p' < p} ⌈count[p'] / 32⌉
__global__ void __launch_bounds__(kScan)
frontier_tiles(const int* __restrict__ count, int P, int cap, PlanScratch s) {
  __shared__ int warp_sums[kScan / 32];
  int carry = 0;
  for (int b = 0; b < P; b += kScan) {
    const int p = b + threadIdx.x;
    const int v = p < P ? (clampi(count[p], 0, cap) + kTile - 1) / kTile : 0;
    int total;
    const int excl = block_exclusive_scan<kScan>(v, &total, warp_sums);
    if (p < P) s.wt_base[p] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) s.wt_base[P] = carry;
}

// row r of pattern p: its first candidate in [out ‖ in] indices and its
// candidate count min(deg, max_chunks·chunk); 0 candidates past n_valid
__device__ __forceinline__ int row_candidates(const Graph& g, const int* emb,
                                              const int* plan, int p, int r,
                                              int n_valid, int cap, int k,
                                              int chunk, int max_chunks,
                                              int* start) {
  *start = 0;
  if (r >= n_valid) return 0;
  const int a = clampi(emb[((long long)p * cap + r) * k + plan[0]], 0, g.n - 1);
  int deg;
  if (plan[1]) {
    *start = g.out_indptr[a];
    deg = g.out_indptr[a + 1] - *start;
  } else {
    const int s0 = g.in_indptr[a];
    deg = g.in_indptr[a + 1] - s0;
    *start = s0 + g.n_out;
  }
  return (int)min((long long)deg, (long long)max_chunks * chunk);
}

// 2. sums: block (x, p) holds rows [256x, 256x + 256) of pattern p, one
// warp tile a warp; lane 31 writes the tile's sums
__global__ void __launch_bounds__(kBlock)
frontier_sums(Graph g, const int* __restrict__ emb,
              const int* __restrict__ count, const int* __restrict__ plan_rows,
              int cap, int k, int chunk, int max_chunks, PlanScratch s) {
  const int p = blockIdx.y;
  const int n_valid = clampi(count[p], 0, cap);
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const int w = r / kTile;
  if (w * kTile >= n_valid) return;  // warp-uniform: no valid row in this tile
  int start;
  const int ncand = row_candidates(
      g, emb, plan_rows + (long long)p * (kPlanScalars + 2 * k), p, r, n_valid,
      cap, k, chunk, max_chunks, &start);
  const int nch = (ncand + chunk - 1) / chunk;
  const int cand = __reduce_add_sync(kFull, ncand);
  const int slots = __reduce_add_sync(kFull, nch);
  const int maxch = __reduce_max_sync(kFull, nch);
  if ((threadIdx.x & 31) == 31) {
    const int wt = s.wt_base[p] + w;
    s.wt_cand[wt] = cand;
    s.wt_slot[wt] = slots;
    s.wt_tc[wt] = maxch;
    s.wt_maxch[wt] = maxch;
    s.wt_p[wt] = p;
  }
}

// 3. scan: int64 exclusive prefixes of the tiles' candidates, slots and
// tile chunks, in (pattern, tile) order; the totals for the host
__global__ void __launch_bounds__(kScan)
frontier_scan(int P, PlanScratch s, long long* __restrict__ totals) {
  __shared__ long long warp_sums[kScan / 32];
  __shared__ int warp_max[kScan / 32];
  const int nw = s.wt_base[P];
  long long carry[3] = {0, 0, 0};
  long long* arr[3] = {s.wt_cand, s.wt_slot, s.wt_tc};
  int maxch = 0;
  for (int b = 0; b < nw; b += kScan) {
    const int i = b + threadIdx.x;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long long v = i < nw ? arr[a][i] : 0;
      long long total;
      const long long excl = block_exclusive_scan<kScan>(v, &total, warp_sums);
      if (i < nw) arr[a][i] = carry[a] + excl;
      carry[a] += total;
    }
    if (i < nw) maxch = max(maxch, s.wt_maxch[i]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) maxch = max(maxch, __shfl_xor_sync(kFull, maxch, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = maxch;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kScan / 32; ++w) maxch = max(maxch, warp_max[w]);
    totals[0] = nw;
    totals[1] = carry[0];
    totals[2] = carry[1];
    totals[3] = carry[2];
    totals[4] = maxch;
  }
}

// 4. rows: one warp per valid tile; row data at its compact index
__global__ void __launch_bounds__(kBlock)
frontier_rows(Graph g, const int* __restrict__ emb,
              const int* __restrict__ count, const int* __restrict__ plan_rows,
              int cap, int k, int chunk, int max_chunks, PlanScratch s,
              int nw) {
  const int wt = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (wt >= nw) return;
  const int lane = threadIdx.x & 31;
  const int p = s.wt_p[wt];
  const int r = (wt - s.wt_base[p]) * kTile + lane;
  int start;
  const int ncand = row_candidates(
      g, emb, plan_rows + (long long)p * (kPlanScalars + 2 * k), p, r,
      clampi(count[p], 0, cap), cap, k, chunk, max_chunks, &start);
  const int nch = (ncand + chunk - 1) / chunk;
  const long long i = (long long)wt * kTile + lane;
  s.r_start[i] = start;
  s.r_cand[i] = warp_inclusive_scan(ncand) - ncand;
  s.r_slot[i] = warp_inclusive_scan(nch) - nch;
  s.r_nch[i] = nch;
}

// the tile holding flat candidate f: the last tile whose offset is <= f
// (empty tiles share the offset of the next one and are passed over)
__device__ __forceinline__ int find_tile(const long long* off, int n, long long f) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= f) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// 5. eval: one thread a candidate; warps stride over the flat space
__global__ void __launch_bounds__(kBlock)
frontier_eval(Graph g, const int* __restrict__ emb,
              const int* __restrict__ count, const int* __restrict__ plan_rows,
              int cap, int k, int level, int chunk, int bisect_iters,
              PlanScratch s, int nw, long long total_cand,
              unsigned long long* __restrict__ masks) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long base = (long long)blockIdx.x * kBlock + (threadIdx.x & ~31);
       base < total_cand; base += stride) {
    const long long f = base + lane;
    const bool active = f < total_cand;
    bool ok = false;
    long long slot = -1;
    int j = 0;
    if (active) {
      const int wt = find_tile(s.wt_cand, nw, f);
      const int p = s.wt_p[wt];
      const int w = wt - s.wt_base[p];
      const int local = (int)(f - s.wt_cand[wt]);
      const long long row0 = (long long)wt * kTile;  // compact index
      int lo = 0, hi = min(kTile, clampi(count[p], 0, cap) - w * kTile) - 1;
      while (lo < hi) {  // the last row of the tile whose offset is <= local
        const int mid = (lo + hi + 1) >> 1;
        if (s.r_cand[row0 + mid] <= local) lo = mid; else hi = mid - 1;
      }
      const long long i = row0 + lo;
      const int pos = local - s.r_cand[i];
      const int c = pos / chunk;
      j = pos - c * chunk;
      slot = s.wt_slot[wt] + s.r_slot[i] + c;
      ok = survives(g, emb + ((long long)p * cap + w * kTile + lo) * k,
                    plan_rows + (long long)p * (kPlanScalars + 2 * k), k, level,
                    bisect_iters, s.r_start[i] + pos);
    }
    // lanes of one slot are consecutive and hold consecutive positions
    const unsigned surv = __ballot_sync(kFull, ok);
    const unsigned same = __match_any_sync(kFull, (unsigned long long)slot);
    const int leader = __ffs(same) - 1;
    if (active && lane == leader) {
      const unsigned bits = (surv & same) >> leader;
      if (bits) atomicOr(masks + slot, (unsigned long long)bits << j);
    }
  }
}

// the warp tile of a warp of the tile / write passes, and its lane's row
struct TileRow {
  int p, w, r, nch, maxch;
  long long slot0, tc0, i;  // i: the row's compact index
  bool valid;
};

__device__ __forceinline__ TileRow tile_row(const PlanScratch& s,
                                            const int* count, int cap, int wt) {
  TileRow t;
  t.p = s.wt_p[wt];
  t.w = wt - s.wt_base[t.p];
  t.r = t.w * kTile + (threadIdx.x & 31);
  t.valid = t.r < clampi(count[t.p], 0, cap);
  t.i = (long long)wt * kTile + (threadIdx.x & 31);
  t.nch = t.valid ? s.r_nch[t.i] : 0;
  t.slot0 = s.wt_slot[wt] + (t.valid ? s.r_slot[t.i] : 0);
  t.maxch = s.wt_maxch[wt];
  t.tc0 = s.wt_tc[wt];
  return t;
}

// 6. tile: per (tile, chunk) the survivors of the tile's rows
__global__ void __launch_bounds__(kBlock)
frontier_tile_sums(const int* __restrict__ count, int cap, PlanScratch s,
                   int nw, const unsigned long long* __restrict__ masks,
                   int* __restrict__ tc) {
  const int wt = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (wt >= nw) return;
  const TileRow t = tile_row(s, count, cap, wt);
  for (int c = 0; c < t.maxch; ++c) {
    const unsigned v = c < t.nch ? __popcll(masks[t.slot0 + c]) : 0;
    const unsigned sum = __reduce_add_sync(kFull, v);
    if ((threadIdx.x & 31) == 0) tc[t.tc0 + c] = (int)sum;
  }
}

// 7. cross: block (c, p) turns chunk c's tile sums of pattern p into
// exclusive offsets over the pattern's tiles; pc[p, c] is the total
__global__ void __launch_bounds__(kBlock)
frontier_cross(PlanScratch s, int maxc, int* __restrict__ tc,
               long long* __restrict__ pc) {
  __shared__ int warp_sums[kBlock / 32];
  const int c = blockIdx.x, p = blockIdx.y;
  const int w0 = s.wt_base[p], w1 = s.wt_base[p + 1];
  int carry = 0;
  for (int b = w0; b < w1; b += kBlock) {
    const int wt = b + threadIdx.x;
    const bool has = wt < w1 && c < s.wt_maxch[wt];
    const long long at = has ? s.wt_tc[wt] + c : 0;
    const int v = has ? tc[at] : 0;
    int total;
    const int excl = block_exclusive_scan<kBlock>(v, &total, warp_sums);
    if (has) tc[at] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) pc[(long long)p * maxc + c] = carry;
}

// 8. chunks: pattern p's chunk bases (in place), found, out_count, ovf
__global__ void __launch_bounds__(kBlock)
frontier_chunks(int maxc, int cap, long long* __restrict__ pc,
                int* __restrict__ out_count, int* __restrict__ found,
                bool* __restrict__ ovf) {
  __shared__ long long warp_sums[kBlock / 32];
  const int p = blockIdx.x;
  long long carry = 0;
  for (int b = 0; b < maxc; b += kBlock) {
    const int c = b + threadIdx.x;
    const long long v = c < maxc ? pc[(long long)p * maxc + c] : 0;
    long long total;
    const long long excl = block_exclusive_scan<kBlock>(v, &total, warp_sums);
    if (c < maxc) pc[(long long)p * maxc + c] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) {
    found[p] = (int)carry;
    out_count[p] = carry < cap ? (int)carry : cap;
    ovf[p] = carry > cap;
  }
}

// position of the r-th (0-based) set bit of m, r < popcount(m)
__device__ __forceinline__ int select_bit(unsigned long long m, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 32; w > 0; w >>= 1) {
    const int low = __popcll(m & ((1ull << w) - 1ull));
    if (r >= low) {
      r -= low;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// 9. write: the tile's survivors of chunk c are contiguous from its base;
// survivor s goes to lane s % 32, which finds its row (the last lane whose
// exclusive count is <= s) and its bit (the rank-th set bit of that row's
// mask), reads the candidate id and writes the row at base + s
__global__ void __launch_bounds__(kBlock)
frontier_write(Graph g, const int* __restrict__ emb,
               const int* __restrict__ count, int cap, int k, int level,
               int chunk, PlanScratch s, int nw, int maxc,
               const unsigned long long* __restrict__ masks,
               const int* __restrict__ tc, const long long* __restrict__ pc,
               int* __restrict__ out_emb) {
  const int wt = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (wt >= nw) return;
  const int lane = threadIdx.x & 31;
  const TileRow t = tile_row(s, count, cap, wt);
  const int start = t.valid ? s.r_start[t.i] : 0;
  const long long row_base = (long long)t.p * cap + t.w * kTile;
  for (int c = 0; c < t.maxch; ++c) {
    // bases only grow with c: past cap here, past cap for every later c
    const long long base = pc[(long long)t.p * maxc + c] + tc[t.tc0 + c];
    if (base >= cap) break;
    const unsigned long long m = c < t.nch ? masks[t.slot0 + c] : 0ull;
    const int v = __popcll(m);
    const int incl = warp_inclusive_scan(v);
    const int excl = incl - v;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int s0 = 0; s0 < total; s0 += 32) {
      const int sv = s0 + lane;
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, excl, j + step) <= sv) j += step;
      const int rank = sv - __shfl_sync(kFull, excl, j);
      const unsigned long long mj = __shfl_sync(kFull, m, j);
      const int first = __shfl_sync(kFull, start, j) + c * chunk;
      const long long dest = base + sv;
      if (sv >= total || dest >= cap) continue;
      const int cand = candidate(g, first + select_bit(mj, rank));
      const int* row = emb + (row_base + j) * k;
      int* out = out_emb + ((long long)t.p * cap + dest) * k;
      for (int col = 0; col < k; ++col)
        out[col] = col == level ? cand : row[col];
    }
  }
}

}  // namespace

// Bytes of the plan scratch for a (P, cap, ·) frontier.
extern "C" long long frontier_expand_plan_bytes(int P, int cap) {
  return (long long)plan_bytes(P, cap);
}

// Bytes of the run scratch, from the plan's totals: the valid tiles' rows
// (16 B each), slots (8 B), tile chunks (4 B) and the (P, largest chunk
// count) chunk table (8 B).
extern "C" long long frontier_expand_run_bytes(int P, long long nw,
                                               long long slots,
                                               long long tile_chunks,
                                               int maxc) {
  return (long long)(rows_bytes(nw) + align256(slots * 8) +
                     align256(tile_chunks * 4) +
                     align256((size_t)P * maxc * 8));
}

// First half: offsets of the rows and warp tiles; writes the five totals
// (tiles, candidates, slots, tile chunks, largest chunk count) as int64 at
// `totals`, which the caller reads on the host to size the run.  All
// pointers are device pointers; returns the cudaError_t (0 = success).
extern "C" int frontier_expand_plan(
    const int* labels, const int* out_indptr, const int* out_indices,
    const int* in_indptr, const int* in_indices, int n, int n_out, int n_in,
    const int* emb, const int* count, const int* plan_rows, int P, int cap,
    int k, int level, int chunk, int max_chunks, void* plan_scratch,
    long long* totals, void* stream) {
  if (chunk < 1 || chunk > 64 || P < 1 || P > 65535 || cap < 1 || level < 1 ||
      level >= k || max_chunks < 1 ||
      (long long)kTile * max_chunks * chunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Graph g{labels, out_indptr, out_indices, in_indptr, in_indices, n, n_out, n_in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PlanScratch s = carve(plan_scratch, P, cap);
  frontier_tiles<<<1, kScan, 0, st>>>(count, P, cap, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  frontier_sums<<<dim3((cap + kBlock - 1) / kBlock, P), kBlock, 0, st>>>(
      g, emb, count, plan_rows, cap, k, chunk, max_chunks, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  frontier_scan<<<1, kScan, 0, st>>>(P, s, totals);
  return (int)cudaGetLastError();
}

// Second half, given the plan's totals: rows, evaluate, order and write.
// `out_emb` must be pre-filled with -1; `run_scratch` holds
// frontier_expand_run_bytes(P, nw, slots, tile_chunks, maxc) bytes.
extern "C" int frontier_expand_run(
    const int* labels, const int* out_indptr, const int* out_indices,
    const int* in_indptr, const int* in_indices, int n, int n_out, int n_in,
    const int* emb, const int* count, const int* plan_rows, int P, int cap,
    int k, int level, int chunk, int max_chunks, int bisect_iters,
    void* plan_scratch,
    long long nw, long long total_cand, long long slots, long long tile_chunks,
    int maxc, void* run_scratch, int* out_emb, int* out_count, int* found,
    bool* ovf, void* stream) {
  if (nw > 0x7fffffffLL || maxc < 0 || maxc > 65535)
    return (int)cudaErrorInvalidValue;
  Graph g{labels, out_indptr, out_indices, in_indptr, in_indices, n, n_out, n_in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* b = static_cast<char*>(run_scratch);
  PlanScratch s = carve(plan_scratch, P, cap, b, (size_t)nw);
  b += rows_bytes((size_t)nw);
  auto* masks = reinterpret_cast<unsigned long long*>(b);
  auto* tc = reinterpret_cast<int*>(b + align256(slots * 8));
  auto* pc = reinterpret_cast<long long*>(b + align256(slots * 8) +
                                          align256(tile_chunks * 4));
  cudaError_t err;
  const int nwi = (int)nw;
  const int tile_blocks = (nwi + kBlock / 32 - 1) / (kBlock / 32);
  if (total_cand > 0) {
    err = cudaMemsetAsync(masks, 0, (size_t)slots * 8, st);
    if (err != cudaSuccess) return (int)err;
    frontier_rows<<<tile_blocks, kBlock, 0, st>>>(g, emb, count, plan_rows, cap,
                                                  k, chunk, max_chunks, s, nwi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long want = (total_cand + kBlock - 1) / kBlock;
    const unsigned blocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));
    frontier_eval<<<blocks, kBlock, 0, st>>>(g, emb, count, plan_rows, cap, k,
                                             level, chunk, bisect_iters, s, nwi,
                                             total_cand, masks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    frontier_tile_sums<<<tile_blocks, kBlock, 0, st>>>(count, cap, s, nwi,
                                                       masks, tc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    frontier_cross<<<dim3(maxc, P), kBlock, 0, st>>>(s, maxc, tc, pc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  frontier_chunks<<<P, kBlock, 0, st>>>(total_cand > 0 ? maxc : 0, cap, pc,
                                    out_count, found, ovf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (total_cand > 0) {
    frontier_write<<<tile_blocks, kBlock, 0, st>>>(g, emb, count, cap, k,
                                                   level, chunk, s, nwi, maxc,
                                                   masks, tc, pc, out_emb);
    err = cudaGetLastError();
  }
  return (int)err;
}
