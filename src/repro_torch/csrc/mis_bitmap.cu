// Greedy mIS selection over a packed used-vertex bitmap, one CTA per pattern.
//
// Replaces the TPU kernel `_mis_kernel` / `mis_bitmap_select`
// (src/repro/kernels/mis_bitmap/kernel.py).  Computes exactly
// `repro_torch.core.mis.mis_greedy_update`: scan rows in order; row r is
// taken iff r < n_valid, count < tau and none of its k vertices (-1 clipped
// to 0) has its bit set; taking it sets those bits.  Bitmap and count carry
// in and out (the caller passes copies it owns; they are updated in place).
//
// What bounds it on an H100: the decisions are sequential by nature (each
// row's depends on every earlier row's), so the time is the latency of the
// decision path; bytes and operations are small.  The TPU kernel carried the
// bitmap in VMEM scratch from one in-order grid step to the next.  Hopper
// blocks run in no order, so one CTA of 512 threads owns one pattern for
// the whole table, with the bitmap in shared memory while ceil(n/32)*4 bytes
// fit beside the ring below (~1.8 M vertices), else in global memory (L2)
// under the same code.  Everything that cannot change a decision is taken
// off the decider's path:
//   * prefilter (warps 1..15): bits are only ever set, and only by earlier
//     rows, so a row whose bits are set in the bitmap as it stands is dead
//     for good, and one that looks free is checked again at its turn.  The
//     warps load a tile of 960 rows at once (the next tile's loads in
//     flight while one is handed over), test them against the bitmap
//     (volatile reads: the decider writes it meanwhile), and compact the
//     live rows' indices, in order, into a two-stage ring in shared memory
//     (ballot + popc within a warp, a scan of the warps' counts across
//     them).  Named barriers hand the stages back and forth (FULL: ring
//     stage written; EMPTY: stage read), so the next tile's loads and tests
//     overlap the current tile's decisions;
//   * decider (warp 0): takes the ring's rows 32 at a time.  Each lane
//     re-tests its row against the bitmap, the warp builds each lane's
//     mask of earlier live lanes sharing a vertex (k shuffles and k*k
//     compares a live lane; a row never conflicts with itself, duplicates
//     and all), resolves the lanes in lane order in registers (a round
//     decides every lane whose earlier conflicts are decided: dead if one
//     was taken, taken if none was; a conflict chain takes a round a link,
//     the hub block's star one round), keeps the first tau - count taken
//     rows (exact: a greedy decision never depends on later rows, and rows
//     after the tau-th take set no bits), sets their bits with atomicOr
//     (two rows taken together have distinct vertices but may share a
//     word), and stops the scan at tau;
//   * shuffles and compares cover k columns: the kernel is instantiated for
//     k = 1..8, and k = 9..16 runs one instance that loops to k.
// What is left at mico's hub block: the first two tiles reach the decider
// whole (nothing is decided when they are tested), ~14-20 ns a row there,
// and each later tile costs about one load latency; 960-row tiles balance
// the two (PERF.md).
// An optional stats array (P, 4) int64 receives, per pattern, the rows the
// prefilter tested, the rows it passed, the rows the decider examined and
// the CTA's time in ns (%globaltimer).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kProducers = kThreads / 32 - 1;              // warps 1..15
constexpr int kRowsPerLane = 2;                            // per producer lane
constexpr int kTile = kProducers * 32 * kRowsPerLane;      // rows a stage
constexpr int kStages = 2;
constexpr int kMaxK = 16;
// dynamic shared memory, in 4-byte words: the ring of row indices, each
// stage's per-warp live counts, control words, then the bitmap
constexpr int kRingWords = kStages * kTile;
constexpr int kCtlWords = kStages * 32 + 8;
constexpr int kFixedBytes = (kRingWords + kCtlWords) * 4;
// control words: [0, kStages) rows in each ring stage, then the stop flag
// and the rows the prefilter tested
constexpr int kCtlStop = kStages;
constexpr int kCtlScanned = kStages + 1;
// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;       // + stage: producers arrive, decider waits
constexpr int kBarEmpty = 3;      // + stage: decider arrives, producers wait
constexpr int kBarProducers = 5;  // producers only: the scan of warp counts

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Loads row r's first k vertices, -1 clipped to 0 (zeros if !valid).
template <int KC>
__device__ __forceinline__ void load_row(int (&v)[KC], const int* e, int r,
                                         int K, int k, bool valid) {
#pragma unroll
  for (int j = 0; j < KC; ++j)
    v[j] = (j < k && valid) ? max(__ldg(e + (long long)r * K + j), 0) : 0;
}

template <int KC>
__device__ __forceinline__ bool row_free(const volatile uint32_t* bm,
                                         const int (&v)[KC], int k) {
  bool free_row = true;
#pragma unroll
  for (int j = 0; j < KC; ++j)
    if (j < k) free_row &= (bm[v[j] >> 5] & (1u << (v[j] & 31))) == 0;
  return free_row;
}

// Warps 1..15: test tile after tile against the bitmap as it stands and
// write the live rows' indices, in row order, to the tile's ring stage.
template <int KC>
__device__ void prefilter(const volatile uint32_t* bm, const int* e, int* ring,
                          int* wcount, volatile int* ctl, int rows, int n_tiles,
                          int K, int k) {
  const int wp = (threadIdx.x >> 5) - 1;
  const int lane = threadIdx.x & 31;
  // this lane's rows of a tile: r0 + u * 32 + lane
  auto load_tile = [&](int tile, int (&v)[kRowsPerLane][KC], bool on) {
    const int r0 = tile * kTile + wp * 32 * kRowsPerLane;
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) {
      const int r = r0 + u * 32 + lane;
      load_row<KC>(v[u], e, r, K, k, on && r < rows);
    }
  };
  int v[kRowsPerLane][KC];
  load_tile(0, v, n_tiles > 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kStages;
    if (tile >= kStages) bar_sync(kBarEmpty + s, kThreads);
    const bool stop = ctl[kCtlStop] != 0;
    const int r0 = tile * kTile + wp * 32 * kRowsPerLane;
    unsigned bal[kRowsPerLane];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) {
      const int r = r0 + u * 32 + lane;
      bal[u] = __ballot_sync(0xffffffffu,
                             !stop && r < rows && row_free<KC>(bm, v[u], k));
      mine += __popc(bal[u]);
    }
    // the next tile's rows load while this one is handed over
    load_tile(tile + 1, v, !stop && tile + 1 < n_tiles);
    if (lane == 0) wcount[s * 32 + wp] = mine;
    if (!stop && wp == 0 && lane == 0)
      ctl[kCtlScanned] += min(kTile, rows - tile * kTile);
    bar_sync(kBarProducers, kProducers * 32);
    const int cw = lane < kProducers ? wcount[s * 32 + lane] : 0;
    int at = __reduce_add_sync(0xffffffffu, lane < wp ? cw : 0);
    const int total = __reduce_add_sync(0xffffffffu, cw);
    int* stage = ring + s * kTile;
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) {
      if ((bal[u] >> lane) & 1u)
        stage[at + __popc(bal[u] & ((1u << lane) - 1u))] = r0 + u * 32 + lane;
      at += __popc(bal[u]);
    }
    if (wp == 0 && lane == 0) ctl[s] = total;
    bar_arrive(kBarFull + s, kThreads);
  }
}

// Warp 0: decides the ring's rows 32 at a time, in row order.  Returns the
// count; *decided receives the rows examined, *survived the ring's rows.
template <int KC, bool SMEM>
__device__ int decide(uint32_t* bm, const int* e, const int* ring,
                      volatile int* ctl, int n_tiles, int K, int k, int cnt,
                      int tau, long long* decided, long long* survived) {
  const int lane = threadIdx.x & 31;
  const volatile uint32_t* vbm = bm;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kStages;
    bar_sync(kBarFull + s, kThreads);
    const int c = ctl[s];
    if (cnt < tau) *survived += c;
    const int* stage = ring + s * kTile;
    for (int b = 0; b < c && cnt < tau; b += 32) {
      const bool valid = b + lane < c;
      int v[KC];
      load_row<KC>(v, e, valid ? stage[b + lane] : 0, K, k, valid);
      const bool live = valid && row_free<KC>(vbm, v, k);
      const unsigned lm = __ballot_sync(0xffffffffu, live);
      // earlier live lanes that share a vertex with this lane's row
      unsigned cm = 0;
      for (unsigned m = lm; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        bool hit = false;
#pragma unroll
        for (int a = 0; a < KC; ++a) {
          if (a < k) {
            const int x = __shfl_sync(0xffffffffu, v[a], j);
#pragma unroll
            for (int bb = 0; bb < KC; ++bb)
              if (bb < k) hit |= x == v[bb];
          }
        }
        if (hit && j < lane) cm |= 1u << j;
      }
      // in lane order: taken iff live and no earlier taken lane conflicts
      unsigned taken = __ballot_sync(0xffffffffu, live && cm == 0);
      unsigned open = lm & ~taken;
      while (open) {
        const bool mine = (open >> lane) & 1u;
        open &= ~__ballot_sync(0xffffffffu, mine && (cm & taken));
        const unsigned now = __ballot_sync(
            0xffffffffu, ((open >> lane) & 1u) && !(cm & open));
        taken |= now;
        open &= ~now;
      }
      // the tau cut: only the first tau - cnt taken rows count
      const long long need = (long long)tau - cnt;
      while (__popc(taken) > need) taken &= ~(0x80000000u >> __clz(taken));
      if ((taken >> lane) & 1u) {
#pragma unroll
        for (int a = 0; a < KC; ++a)
          if (a < k) atomicOr(bm + (v[a] >> 5), 1u << (v[a] & 31));
      }
      if (!SMEM) __threadfence_block();
      __syncwarp();
      cnt += __popc(taken);
      *decided += min(32, c - b);
    }
    if (cnt >= tau && lane == 0) ctl[kCtlStop] = 1;
    if (tile + kStages < n_tiles) bar_arrive(kBarEmpty + s, kThreads);
  }
  return cnt;
}

template <int KC, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1)
mis_greedy_kernel(uint32_t* __restrict__ bitmap, int* __restrict__ count,
                  const int* __restrict__ emb, const int* __restrict__ n_valid,
                  const int* __restrict__ tau, int cap, int K, int k_arg,
                  int Nw, long long* __restrict__ stats) {
  extern __shared__ __align__(16) uint32_t smem[];
  int* ring = reinterpret_cast<int*>(smem);
  int* wcount = ring + kRingWords;
  volatile int* ctl = wcount + kStages * 32;
  const unsigned long long t_start = stats ? globaltimer() : 0;
  const int k = KC < kMaxK ? KC : k_arg;
  const int p = blockIdx.x;
  uint32_t* gbm = bitmap + (long long)p * Nw;
  uint32_t* bm = SMEM ? smem + kRingWords + kCtlWords : gbm;
  const int* e = emb + (long long)p * cap * K;
  const int rows = min(max(n_valid[p], 0), cap);
  const int t = tau[p];
  const int cnt0 = count[p];
  const int n_tiles = cnt0 < t ? (rows + kTile - 1) / kTile : 0;
  if (SMEM && n_tiles > 0)
    for (int w = threadIdx.x; w < Nw; w += kThreads) bm[w] = gbm[w];
  if (threadIdx.x < kCtlWords - kStages * 32) ctl[threadIdx.x] = 0;
  __syncthreads();
  long long decided = 0, survived = 0;
  int cnt = cnt0;
  if (threadIdx.x < 32)
    cnt = decide<KC, SMEM>(bm, e, ring, ctl, n_tiles, K, k, cnt0, t, &decided,
                           &survived);
  else
    prefilter<KC>(bm, e, ring, wcount, ctl, rows, n_tiles, K, k);
  __syncthreads();
  if (SMEM && n_tiles > 0)
    for (int w = threadIdx.x; w < Nw; w += kThreads) gbm[w] = bm[w];
  if (threadIdx.x == 0) {
    count[p] = cnt;
    if (stats) {
      stats[4 * p + 0] = ctl[kCtlScanned];
      stats[4 * p + 1] = survived;
      stats[4 * p + 2] = decided;
      stats[4 * p + 3] = (long long)(globaltimer() - t_start);
    }
  }
}

struct Args {
  uint32_t* bitmap;
  int* count;
  const int* emb;
  const int* n_valid;
  const int* tau;
  int P, cap, K, k, Nw;
  long long* stats;
  cudaStream_t stream;
};

template <int KC, bool SMEM>
int launch_k(const Args& a) {
  const size_t smem =
      kFixedBytes + (SMEM ? (size_t)a.Nw * sizeof(uint32_t) : 0);
  auto kernel = mis_greedy_kernel<KC, SMEM>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.P, kThreads, smem, a.stream>>>(a.bitmap, a.count, a.emb,
                                            a.n_valid, a.tau, a.cap, a.K, a.k,
                                            a.Nw, a.stats);
  return (int)cudaGetLastError();
}

template <bool SMEM>
int launch(const Args& a) {
  switch (a.k) {
    case 1: return launch_k<1, SMEM>(a);
    case 2: return launch_k<2, SMEM>(a);
    case 3: return launch_k<3, SMEM>(a);
    case 4: return launch_k<4, SMEM>(a);
    case 5: return launch_k<5, SMEM>(a);
    case 6: return launch_k<6, SMEM>(a);
    case 7: return launch_k<7, SMEM>(a);
    case 8: return launch_k<8, SMEM>(a);
    default: return launch_k<kMaxK, SMEM>(a);
  }
}

}  // namespace

// Largest bitmap, in bytes, that one block keeps in shared memory on
// `device` beside the ring (the opt-in limit less the ring and its counts).
extern "C" int mis_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes - kFixedBytes;
}

// Returns the cudaError_t of the launch (0 = success).  bitmap (P, Nw) and
// count (P,) are updated in place; emb (P, cap, K) int32; n_valid/tau (P,);
// stats (P, 4) int64 or null.
extern "C" int mis_greedy_launch(void* bitmap, int* count, const int* emb,
                                 const int* n_valid, const int* tau, int P,
                                 int cap, int K, int k, int Nw, int use_smem,
                                 long long* stats, void* stream) {
  if (k < 1 || k > kMaxK || k > K) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const Args a{static_cast<uint32_t*>(bitmap), count, emb, n_valid, tau, P,
               cap, K, k, Nw, stats, static_cast<cudaStream_t>(stream)};
  return use_smem ? launch<true>(a) : launch<false>(a);
}
