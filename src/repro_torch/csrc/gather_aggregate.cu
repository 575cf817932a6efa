// Gather-aggregate (the GNN's SpMM) over index segments, for power-law rows.
//
// Replaces the TPU kernel `_agg_kernel` / `gather_aggregate_pallas`
// (src/repro/kernels/gather_aggregate/kernel.py).  Computes the same
// function: features (N, F) → out (N, F) in the features' dtype,
//   out[i] = Σ_j features[ids[j]]   over j in node i's segment, ids[j] ≥ 0,
// accumulated in f32 from 0 in j order, divided by max(#valid, 1) with
// __fdiv_rn for the mean, rounded once.  Node i's segment is [start_i,
// end_i) of one int32 index array, in one of two layouts:
//   * padded (the reference kernel's interface): nbrs (N, Dmax), pad −1,
//     the segment [i·Dmax, (i+1)·Dmax) with the pads skipped;
//   * CSR: indptr (N + 1,) and src (nnz,), the segment [indptr[i],
//     indptr[i+1]): a hub of in-degree 10⁵ costs its own ids only.
// Every path below adds the same terms in the same order into one f32
// accumulator a column (one thread owns a column of a row), so the two
// layouts, every path and the plain versions (ref.py) give the same
// bytes.  No column's sum is split into partial sums and nothing is summed
// by atomics.  An id ≥ N lies outside the contract; it is skipped and
// never read.  Row offsets (row × F) are 64-bit: at ogb_products nnz × F
// is 7.9·10⁹ > 2³¹.
//
// What bounds it on an H100: bytes.  Each valid neighbour reads one
// feature row (200 B at ogb_products' bf16 F 100), each node reads its ids
// and writes one row; an f32 add a byte or two.  A warp that adds each
// row before it loads the next has one row in flight: on a power-law graph
// the hub (92 480 ids at ogb_products) took ~37 ms on one warp while the
// other 2.4 M rows were done long before.  So rows are classed by length:
//   * short rows (≤ kLongT ids; every padded row when Dmax ≤ kLongT): one
//     warp a row.  Its lanes read 32 ids at a time; a ballot gives the
//     valid ones and their count (the mean's divisor, taken in that read;
//     a row of ≤ 32 ids is read once and one with none only stores
//     zeros); kInFlight valid neighbours are broadcast by shuffles, their
//     column slices loaded into registers, and only then added in j order.
//     A lane moves VB bytes a load: the widest that divides the row and
//     its address and keeps kBusyLanes lanes on the row (F 128 and 100
//     bf16: 8 bytes, 32 and 25 lanes; F 602 bf16, 4-byte aligned rows: 4;
//     an odd F in bf16: 2), up to 16 bytes a lane a pass;
//   * long rows (> kLongT ids; every padded row when Dmax > kLongT): a
//     whole block a column range of the row — one range, or, for a row of
//     L ≥ 2·kPartIds ids, L / kPartIds ranges each in a block of its own,
//     so the hub's bytes come through several SMs while each column's sum
//     stays whole.  The block's warps copy tiles of K neighbour rows' slices
//     from device memory into a ring of kStages tiles in shared memory
//     with cp.async (zeros for an invalid id: a sum that starts at +0 is
//     never −0, so adding them leaves its bytes), kStages − 1 tiles in
//     flight, each tile's ids fetched by cp.async kStages tiles ahead; the
//     thread that owns a column loads kAddAhead ring rows of it and adds
//     them in j order.  The warps count the valid ids they copy; the
//     counts are summed once.  TMA and cp.async.bulk do not fit: they copy
//     boxes of a tensor or multiples of 16 bytes, not a list of 200-byte
//     rows.
// The schedule lives on the card.  A CSR call (and a padded one with Dmax
// > kLongT) is two CUDA operations: a memset of the queue (its header and
// slots, which the wrapper allocates), then one kernel whose first blocks
// (kLongPerSM an SM) are the long path and the others the short path,
// which skips the long rows.  A long block takes a queued part of a long
// row if there is one, else a chunk of kScanRows rows to scan, pushing
// the parts of the long rows it finds; it leaves once every chunk is
// scanned and the queue is empty, and never waits on a block that has not
// started, so the kernel cannot deadlock on the order blocks are placed
// in.  The long blocks start first, so a hub overlaps the bulk instead of
// following it.  A padded call with Dmax ≤ kLongT is one kernel with no
// long blocks.  No call reads anything back to the host.  The queue's
// waits have no timeout: a block waits only on a slot that a running
// block is writing or on chunks that running blocks scan, each a few
// microseconds of work.  A queue too small for the long rows' parts traps
// (the wrapper sizes it so that it cannot be).
//
// The constants, timed at ogb_products (bf16 mean, F 100 / 128, CUDA
// events, H100 80GB HBM3 at 700 W) by scripts/torch_ab.py --only agg over
// copies of this tree with one constant changed, in one call; the choice
// read 5.96 / 5.87 and 5.96 / 5.89 ms there (PERF.md §6):
//   * kLongT 2 048 (1 752 long rows, 0.188 of nnz): 1 024 9.30 / 8.48 ms,
//     4 096 5.99 / 5.88;
//   * kInFlight 8: 4 in flight 6.65 / 6.53 ms;
//   * kRingBytes 16 KB in kStages 4: 8 KB 7.48 / 6.92 ms, 32 KB 6.97 /
//     6.94 (the ring is every block's shared memory: more of it takes L1
//     from the short rows);
//   * kBusyLanes 24: at 16, F 128 bf16 takes 16-byte loads on 16 lanes,
//     7.87 ms;
//   * kMinBlocks 4 (64 registers; both paths share them): 3 read the same,
//     5.99 / 5.89 ms, and block 0 of sage-minibatch too;
//   * kPartIds 8 192: one range a row read 5.91 / 5.66 ms; the ranges are
//     kept for a call whose hub is its critical path (a star), where one
//     block would carry the hub's bytes alone;
//   * kLongPerSM 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows of more ids than this take the long path (a block a column range)
constexpr int kLongT = 2048;
// short path: valid neighbours whose loads are issued before the first add
constexpr int kInFlight = 8;
// long path: the ring's bytes, its tiles, and the columns a thread owns
constexpr int kRingBytes = 16384;
constexpr int kStages = 4;
// long blocks an SM
constexpr int kLongPerSM = 1;
// blocks an SM must hold (caps the registers: both paths share them)
constexpr int kMinBlocks = 4;
// short path: a lane's words of neighbour rows in flight at most
constexpr int kRawWords = 16;
// the short path narrows a lane's loads until this many lanes share a row
constexpr int kBusyLanes = 24;
// a long row of L ids is summed as min(L / kPartIds, its copy units) (at
// least 1) column ranges, each by a long block of its own: a column's sum
// stays whole, in j order, while the hub's bytes come through more SMs
constexpr int kPartIds = 8192;
constexpr int kOwned = 4;
constexpr int kAddAhead = 8;   // ring rows an owner loads before adding them
// tiles whose ids are in shared memory: a tile's ids arrive kStages
// iterations before its rows are copied
constexpr int kIdSlots = 2 * kStages;
constexpr int kSlice = kThreads * kOwned;   // columns of one slice of a row
constexpr int kMaxK = 128;                  // rows of one tile at most
// the queue: head (next pop), tail (next push), chunks scanned, next
// chunk to scan, then 64-bit slots (part << 32 | row + 1, 0 while being
// written); a chunk is kScanRows rows
constexpr int kHeader = 4;
constexpr int kScanRows = 4096;
constexpr unsigned kFull = 0xffffffffu;

// VB bytes of a row as 32-bit words (VB = 2: one word, its low 16 bits)
template <int VB>
struct Words {
  unsigned w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Words<VB> load_words(const void* p) {
  Words<VB> r;
  if constexpr (VB == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r.w[0] = v.x; r.w[1] = v.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(static_cast<const unsigned*>(p));
  } else {
    r.w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
  return r;
}

// acc[e] += element e of the words (bf16 → f32 is exact: a shift)
template <typename T, int VB>
__device__ __forceinline__ void add_words(float* acc, const Words<VB>& r) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) acc[i] += __uint_as_float(r.w[i]);
  } else if constexpr (VB == 2) {
    acc[0] += __uint_as_float(r.w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      acc[2 * i] += __uint_as_float(r.w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(r.w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VB / sizeof(T) sums, rounded to T, stored as VB bytes
template <typename T, int VB>
__device__ __forceinline__ void store_words(T* p, const float* v) {
  if constexpr (VB == 2 || (sizeof(T) == 4 && VB == 4)) {
    *p = from_float<T>(v[0]);
  } else {
    unsigned w[VB / 4];
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&b);
      }
    }
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

// one VB-byte copy into shared memory, or VB zero bytes when !ok (the
// row of an id outside [0, N): adding its zeros leaves a sum's bytes as
// they are, since a sum that starts at +0 is never −0)
template <int VB>
__device__ __forceinline__ void copy_unit(void* dst, const void* src, bool ok) {
  if constexpr (VB == 2) {
    *static_cast<unsigned short*>(dst) =
        ok ? __ldg(static_cast<const unsigned short*>(src)) : 0;
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const unsigned n = ok ? VB : 0;
    if constexpr (VB == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(n) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                   "l"(src), "n"(VB), "r"(n) : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool in_range(int id, int N) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(N);
}

// the column ranges a long row of `len` ids is summed in (`units`: the
// row's copy units)
__device__ __forceinline__ int parts_of(int len, int units) {
  const int p = len / kPartIds;
  return p < 1 ? 1 : (p > units ? units : p);
}

// The short path: one warp sums the row of `len` ids at `row_ids` into
// dst.  A pass covers U loads of VB bytes a lane; within a pass the valid
// ids are taken G at a time, all G rows' loads issued before the first
// add.  A row of at most 32 ids is read once (its ids stay in registers
// across passes), and one with no valid id only stores zeros.
template <typename T, int VB, int U>
__device__ void short_row(const T* __restrict__ feat,
                          const int* __restrict__ row_ids, int len,
                          T* __restrict__ dst, int N, int F, int mean,
                          int lane) {
  constexpr int E = VB / sizeof(T);       // elements a load
  constexpr int kWords = VB >= 4 ? U * VB / 4 : U;
  constexpr int G = kRawWords / kWords < kInFlight
                        ? (kRawWords / kWords > 0 ? kRawWords / kWords : 1)
                        : kInFlight;
  constexpr int kStep = 32 * E;
  constexpr int kPass = kStep * U;
  int id = -1, count = 0;
  unsigned first = 0;
  if (len <= 32) {
    id = lane < len ? __ldg(row_ids + lane) : -1;
    first = __ballot_sync(kFull, in_range(id, N));
    count = __popc(first);
    if (count == 0) {
      const float zero[E] = {};
      for (int col = lane * E; col < F; col += kStep)
        store_words<T, VB>(dst + col, zero);
      return;
    }
  }
  for (int c0 = 0; c0 < F; c0 += kPass) {
    float acc[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
    const int col0 = c0 + lane * E;
    for (int base = 0; base < len; base += 32) {
      int my = id;
      unsigned valid = first;
      if (len > 32) {
        const int j = base + lane;
        my = j < len ? __ldg(row_ids + j) : -1;
        valid = __ballot_sync(kFull, in_range(my, N));
        if (c0 == 0) count += __popc(valid);
      }
      while (valid) {   // warp-uniform
        int src[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          src[g] = -1;
          if (valid) {
            const int from = __ffs(valid) - 1;
            valid &= valid - 1;
            src[g] = __shfl_sync(kFull, my, from);
          }
        }
        Words<VB> raw[G][U];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (src[g] >= 0) {
            const T* row = feat + (size_t)src[g] * F + col0;
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (col0 + u * kStep < F) raw[g][u] = load_words<VB>(row + u * kStep);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (src[g] >= 0) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (col0 + u * kStep < F) add_words<T, VB>(acc[u], raw[g][u]);
          }
        }
      }
    }
    const float denom = (float)max(count, 1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = col0 + u * kStep;
      if (col < F) {
        if (mean) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[u][e] = __fdiv_rn(acc[u][e], denom);
        }
        store_words<T, VB>(dst + col, acc[u]);
      }
    }
  }
}

// the ring's bytes, rounded up to 16: the tiles' ids follow them
__host__ __device__ constexpr int ring_bytes(int tile_bytes) {
  return (kStages * tile_bytes + 15) / 16 * 16;
}
// the long path's shared memory: the ring at its largest, the ids
constexpr int kLongSmem = ring_bytes(kRingBytes / kStages) +
                          kIdSlots * kMaxK * (int)sizeof(int);

// The long path: the whole block sums columns [c_begin, c_end) of the row
// of `len` ids at `row_ids` into dst, through a ring of kStages tiles of K
// neighbour rows' slices (`slice` columns; a wider range takes slices in
// turn).  Tile x's ids land in a ring of kIdSlots tiles kStages
// iterations before its rows are copied.  A warp copies a row (zeros for
// an invalid id) and counts the valid ids it meets; the counts are summed
// across the warps once.  `counts`: kWarps ints of shared memory.
template <typename T, int VB>
__device__ void long_row(const T* __restrict__ feat,
                         const int* __restrict__ row_ids, int len,
                         T* __restrict__ dst, int N, int F, int mean,
                         int c_begin, int c_end, unsigned char* smem,
                         int* counts) {
  constexpr int es = sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a slice of the columns at a time, as many rows a tile as the ring holds
  constexpr int kCols = kRingBytes / (kStages * es) / (VB / es) * (VB / es);
  const int slice = min(c_end - c_begin, min(kSlice, kCols));
  const int K = max(1, min(kMaxK, kRingBytes / (kStages * slice * es)));
  const int tile_bytes = K * slice * es;
  int* id_ring = reinterpret_cast<int*>(smem + ring_bytes(tile_bytes));
  const int tiles = (len + K - 1) / K;
  int count = 0;   // this warp's valid ids, then (after slice 0) the row's
  for (int c0 = c_begin; c0 < c_end; c0 += slice) {
    const int cols = min(slice, c_end - c0);
    const int units = cols * es / VB;       // copies a neighbour row
    // copy tile x's rows into its ring slot, a warp a row
    auto issue = [&](int x) {
      const int* ids = id_ring + (x % kIdSlots) * K;
      unsigned char* base = smem + (x % kStages) * tile_bytes;
      const int rows = min(K, len - x * K);
      for (int k = warp; k < rows; k += kWarps) {
        const int id = ids[k];
        const bool ok = in_range(id, N);
        if (c0 == c_begin) count += ok;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            feat + (ok ? (size_t)id * F + c0 : 0));
        unsigned char* row = base + k * slice * es;
        for (int u = lane; u < units; u += 32)
          copy_unit<VB>(row + u * VB, src + u * VB, ok);
      }
    };
    float acc[kOwned];
#pragma unroll
    for (int i = 0; i < kOwned; ++i) acc[i] = 0.f;
    // tile x's ids land kStages tiles before its rows are copied: tiles
    // 0 .. 2·kStages − 2 now, each later one with the group kStages
    // iterations ahead of its copy
    auto fetch_ids = [&](int x) {
      const long long j = (long long)x * K + tid;
      if (tid < K && x < tiles && j < len)
        copy_unit<4>(id_ring + (x % kIdSlots) * K + tid, row_ids + j, true);
    };
    for (int x = 0; x < kIdSlots - 1; ++x) fetch_ids(x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int x = 0; x < kStages - 1; ++x) {
      if (x < tiles) issue(x);
      cp_async_commit();
    }
    for (int s = 0; s < tiles; ++s) {
      if (s + kStages - 1 < tiles) issue(s + kStages - 1);
      fetch_ids(s + kIdSlots - 1);   // into the slot tile s − 1's ids left
      cp_async_commit();
      cp_async_wait<kStages - 1>();   // tile s has landed
      __syncthreads();
      const T* tile = reinterpret_cast<const T*>(smem + (s % kStages) * tile_bytes);
      const int rows = min(K, len - s * K);
#pragma unroll
      for (int i = 0; i < kOwned; ++i) {
        const int e = tid + i * kThreads;
        if (i * kThreads + warp * 32 < cols && e < cols) {
          const T* col = tile + e;
          float a = acc[i];
          int k = 0;
          for (; k + kAddAhead <= rows; k += kAddAhead) {
            float v[kAddAhead];   // loads first, then the adds in order
#pragma unroll
            for (int q = 0; q < kAddAhead; ++q)
              v[q] = to_float(col[(k + q) * slice]);
#pragma unroll
            for (int q = 0; q < kAddAhead; ++q) a += v[q];
          }
          for (; k < rows; ++k) a += to_float(col[k * slice]);
          acc[i] = a;
        }
      }
      __syncthreads();   // the slots of tile s are free again
    }
    if (c0 == c_begin) {   // the warps' counts → the row's
      if (lane == 0) counts[warp] = count;
      __syncthreads();
      count = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) count += counts[w];
      __syncthreads();
    }
    const float denom = (float)max(count, 1);
#pragma unroll
    for (int i = 0; i < kOwned; ++i) {
      const int e = tid + i * kThreads;
      if (e < cols) {
        const float v = mean ? __fdiv_rn(acc[i], denom) : acc[i];
        dst[c0 + e] = from_float<T>(v);
      }
    }
  }
}

// thread 0 of a long block: its next work — a part of a long row (part
// << 32 | row) off the queue, a chunk of rows to scan for long ones (−2 −
// chunk), or −1 once every chunk is scanned and the queue is empty.  A
// block takes a row before a chunk and never waits on a block that has
// not started: a claimed queue slot or chunk belongs to a running block.
__device__ long long next_work(int* work, int n_chunks) {
  volatile int* q = work;
  volatile unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(work + kHeader);
  for (;;) {
    const int head = q[0];
    if (head < q[1]) {
      if (atomicCAS(&work[0], head, head + 1) != head) continue;
      unsigned long long v;
      while ((v = slots[head]) == 0) {}   // its pusher is writing it
      return (long long)(v - 1);
    }
    if (q[3] < n_chunks) {
      const int chunk = atomicAdd(&work[3], 1);
      if (chunk < n_chunks) return -2 - chunk;
      continue;
    }
    if (q[2] == n_chunks) {   // every chunk scanned: the tail is final
      __threadfence();
      if (q[0] >= q[1]) return -1;
      continue;
    }
    __nanosleep(64);
  }
}

// Blocks below n_long run the long path over the rows the queue holds;
// the others run the short path, a warp a row, and skip the long rows.
// work: the queue (kHeader ints, then `capacity` 64-bit slots), zeroed
// before the launch; unused when n_long is 0.
template <typename T, int VB, int U>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    agg_kernel(const T* __restrict__ feat, const int* __restrict__ ids,
               const int* __restrict__ indptr, T* __restrict__ out, int N,
               int F, int Dmax, int mean, int* work, int capacity,
               int n_long) {
  extern __shared__ __align__(16) unsigned char agg_smem[];
  if ((int)blockIdx.x < n_long) {
    __shared__ long long next;
    __shared__ int counts[kWarps];
    const int n_chunks = (int)(((long long)N + kScanRows - 1) / kScanRows);
    const int units = F * (int)sizeof(T) / VB;   // copy units of a row
    unsigned long long* slots =
        reinterpret_cast<unsigned long long*>(work + kHeader);
    for (;;) {
      if (threadIdx.x == 0) next = next_work(work, n_chunks);
      __syncthreads();
      const long long w = next;
      __syncthreads();
      if (w == -1) return;
      if (w >= 0) {
        const int row = (int)(w & 0xffffffffLL), part = (int)(w >> 32);
        const size_t start = indptr ? (size_t)indptr[row] : (size_t)row * Dmax;
        const int len = indptr ? indptr[row + 1] - indptr[row] : Dmax;
        const int parts = parts_of(len, units);
        constexpr int E = VB / sizeof(T);
        const int c_begin = (int)((long long)units * part / parts) * E;
        const int c_end = (int)((long long)units * (part + 1) / parts) * E;
        long_row<T, VB>(feat, ids + start, len, out + (size_t)row * F, N, F,
                        mean, c_begin, c_end, agg_smem, counts);
        continue;
      }
      // scan a chunk of rows, push the parts of its long ones
      const long long lo = (long long)(-2 - w) * kScanRows;
      const long long hi = min(lo + kScanRows, (long long)N);
      for (long long r = lo + threadIdx.x; r < hi; r += kThreads) {
        const int len = indptr ? indptr[r + 1] - indptr[r] : Dmax;
        if (len > kLongT) {
          const int parts = parts_of(len, units);
          const int pos = atomicAdd(&work[1], parts);
          if (pos + parts > capacity) __trap();
          for (int p = 0; p < parts; ++p)
            slots[pos + p] = ((unsigned long long)p << 32) | (unsigned)(r + 1);
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(&work[2], 1);
    }
  }
  const long long node =
      (long long)(blockIdx.x - n_long) * kWarps + (threadIdx.x >> 5);
  if (node >= N) return;
  const size_t start = indptr ? (size_t)indptr[node] : (size_t)node * Dmax;
  const int len = indptr ? indptr[node + 1] - indptr[node] : Dmax;
  if (len > kLongT) return;   // a long block sums it
  short_row<T, VB, U>(feat, ids + start, len, out + (size_t)node * F, N, F,
                      mean, threadIdx.x & 31);
}

// the queue's slots for a call (0 when no row can be long): a long row
// holds more than kLongT ids and is pushed as at most 1 + len / kPartIds
// parts
long long work_slots(int N, long long nnz, int Dmax, bool csr) {
  if (N <= 0) return 0;
  long long rows, ids;
  if (csr) {
    rows = nnz / (kLongT + 1);
    if (rows > N) rows = N;
    ids = nnz;
  } else {
    rows = Dmax > kLongT ? N : 0;
    ids = rows * Dmax;
  }
  if (rows == 0) return 0;
  const long long cap = rows + ids / kPartIds;
  return cap < 0x3fffffffLL ? cap : 0x3fffffffLL;
}

template <typename T, int VB, int U>
cudaError_t launch_typed(const void* feat, const void* ids, const void* indptr,
                         void* out, int N, int F, int Dmax, int mean,
                         int* work, long long capacity,
                         cudaStream_t stream) {
  const bool csr = indptr != nullptr;
  int n_long = 0;
  size_t smem = 0;
  long long short_blocks = ((long long)N + kWarps - 1) / kWarps;
  if (capacity > 0) {   // a row may be long
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    n_long = N < sms * kLongPerSM ? N : sms * kLongPerSM;
    if (!csr) short_blocks = 0;   // every padded row is long
    smem = kLongSmem;
    err = cudaFuncSetAttribute(agg_kernel<T, VB, U>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(work, 0,
                          (kHeader + 2 * (size_t)capacity) * sizeof(int),
                          stream);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = n_long + short_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  agg_kernel<T, VB, U><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const int*>(ids),
      static_cast<const int*>(indptr), static_cast<T*>(out), N, F, Dmax, mean,
      work, (int)capacity, n_long);
  return cudaGetLastError();
}

int launch(const void* feat, const void* ids, const void* indptr, void* out,
           int N, int F, int Dmax, int dtype, int mean, int vec, void* work,
           long long nnz, void* stream) {
  if (N <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long capacity = work_slots(N, nnz, Dmax, indptr != nullptr);
  if (capacity > 0 && work == nullptr) return (int)cudaErrorInvalidValue;
  int* w = static_cast<int*>(work);
  // narrower loads (which divide the row and its address too) until
  // kBusyLanes lanes share a row: F 128 bf16 moves 8 bytes a lane on 32
  // lanes, not 16 on 16
  const int es = dtype == 0 ? 4 : 2;
  while (vec > es && (long long)F * es / vec < kBusyLanes) vec /= 2;
  // the short path's loads a lane a pass: enough to cover the row, at
  // most 16 bytes a lane
  const long long need = ((long long)F * es + 32 * vec - 1) / (32 * vec);
  const int cap = 16 / vec;
  const int loads = need < cap ? (int)need : cap;
  const int U = loads <= 1 ? 1 : loads <= 2 ? 2 : loads <= 4 ? 4 : 8;
  cudaError_t err = cudaErrorInvalidValue;
#define AGG_CASE(TYPE, VB, U_)                                              \
  err = launch_typed<TYPE, VB, U_>(feat, ids, indptr, out, N, F, Dmax, mean, \
                                   w, capacity, s)
  if (dtype == 0) {
    if (vec == 16) AGG_CASE(float, 16, 1);
    else if (vec == 8 && U == 1) AGG_CASE(float, 8, 1);
    else if (vec == 8) AGG_CASE(float, 8, 2);
    else if (vec == 4 && U == 1) AGG_CASE(float, 4, 1);
    else if (vec == 4 && U == 2) AGG_CASE(float, 4, 2);
    else if (vec == 4) AGG_CASE(float, 4, 4);
  } else {
    if (vec == 16) AGG_CASE(__nv_bfloat16, 16, 1);
    else if (vec == 8 && U == 1) AGG_CASE(__nv_bfloat16, 8, 1);
    else if (vec == 8) AGG_CASE(__nv_bfloat16, 8, 2);
    else if (vec == 4 && U == 1) AGG_CASE(__nv_bfloat16, 4, 1);
    else if (vec == 4 && U == 2) AGG_CASE(__nv_bfloat16, 4, 2);
    else if (vec == 4) AGG_CASE(__nv_bfloat16, 4, 4);
    else if (vec == 2 && U == 1) AGG_CASE(__nv_bfloat16, 2, 1);
    else if (vec == 2 && U == 2) AGG_CASE(__nv_bfloat16, 2, 2);
    else if (vec == 2 && U == 4) AGG_CASE(__nv_bfloat16, 2, 4);
    else if (vec == 2) AGG_CASE(__nv_bfloat16, 2, 8);
  }
#undef AGG_CASE
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: the bytes a lane moves a load
// (16, 8, 4, or 2 for bf16), which must divide F × the element size and
// the features' and the output's addresses (the wrappers pick it).  work:
// gather_aggregate_work_ints(...) int32 of scratch (none when that is 0).
// Each returns the launch's cudaError_t (0 on success).
extern "C" long long gather_aggregate_work_ints(int N, long long nnz, int Dmax,
                                                int csr) {
  const long long slots = work_slots(N, nnz, Dmax, csr != 0);
  return slots > 0 ? kHeader + 2 * slots : 0;
}

// The long-row threshold kLongT (the wrappers' LONG_ROW must equal it).
extern "C" int gather_aggregate_long_threshold() { return kLongT; }

// The padded layout: nbrs (N, Dmax) int32, pad −1.
extern "C" int gather_aggregate_launch(const void* feat, const void* nbrs,
                                       void* out, int N, int F, int Dmax,
                                       int dtype, int mean, int vec,
                                       void* work, void* stream) {
  return launch(feat, nbrs, nullptr, out, N, F, Dmax, dtype, mean, vec, work,
                0, stream);
}

// The CSR layout: indptr (N + 1,) and src (nnz,) int32.
extern "C" int gather_aggregate_csr_launch(const void* feat,
                                           const void* indptr,
                                           const void* src, void* out, int N,
                                           int F, long long nnz, int dtype,
                                           int mean, int vec, void* work,
                                           void* stream) {
  return launch(feat, src, indptr, out, N, F, 0, dtype, mean, vec, work, nnz,
                stream);
}
