// Greedy mIS selection over a packed used-vertex bitmap, one CTA per pattern.
//
// Replaces the TPU kernel `_mis_kernel` / `mis_bitmap_select`
// (src/repro/kernels/mis_bitmap/kernel.py).  Computes exactly
// `repro_torch.core.mis.mis_greedy_update`: scan rows in order; row r is
// taken iff r < n_valid, count < tau and none of its k vertices (-1 clipped
// to 0) has its bit set; taking it sets those bits.  Bitmap and count carry
// in and out (the caller passes copies it owns; they are updated in place).
//
// What bounds it on an H100: the scan is sequential by nature — each row's
// decision depends on every earlier row — so the time is the latency of the
// dependent bitmap reads and writes, one row after another; bytes and FLOPs
// are negligible.  The TPU kernel carried the bitmap in VMEM scratch from one
// in-order grid step to the next.  Hopper blocks run in no order, so here one
// CTA owns one pattern for the whole table and loops over all rows itself:
//   * the bitmap sits in shared memory while ceil(n/32)*4 bytes fit the
//     card's opt-in limit (227 KB, n up to ~1.86 M vertices), else it is
//     worked on in global memory (L2-resident) by the same code;
//   * warp 0 does the scan: its 32 lanes load a tile of 32 rows at once
//     (coalesced), then lane 0 decides each row in order from registers
//     shuffled to it, so only one thread ever touches the bitmap and no
//     fence is needed inside the scan;
//   * the scan stops at n_valid or as soon as count reaches tau.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

__global__ void mis_greedy_kernel(uint32_t* __restrict__ bitmap,
                                  int* __restrict__ count,
                                  const int* __restrict__ emb,
                                  const int* __restrict__ n_valid,
                                  const int* __restrict__ tau, int cap, int K,
                                  int k, int Nw, bool use_smem) {
  extern __shared__ uint32_t smem[];
  int p = blockIdx.x;
  uint32_t* gbm = bitmap + (long long)p * Nw;
  uint32_t* bm = use_smem ? smem : gbm;
  if (use_smem) {
    for (int w = threadIdx.x; w < Nw; w += blockDim.x) smem[w] = gbm[w];
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    int lane = threadIdx.x;
    int cnt = count[p];
    int t = tau[p];
    int rows = min(max(n_valid[p], 0), cap);
    const int* e = emb + (long long)p * cap * K;
    for (int base = 0; base < rows && cnt < t; base += 32) {
      int v[kMaxK];
      int r = base + lane;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        v[j] = (j < k && r < rows) ? max(e[(long long)r * K + j], 0) : 0;
      int n_tile = min(32, rows - base);
      for (int i = 0; i < n_tile; ++i) {
        int take = 0;
        int vi[kMaxK];
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) vi[j] = __shfl_sync(0xffffffffu, v[j], i);
        if (lane == 0 && cnt < t) {
          bool free_row = true;
          for (int j = 0; j < k; ++j)
            free_row &= (bm[vi[j] >> 5] & (1u << (vi[j] & 31))) == 0;
          if (free_row) {
            for (int j = 0; j < k; ++j) bm[vi[j] >> 5] |= 1u << (vi[j] & 31);
            take = 1;
          }
        }
        cnt += __shfl_sync(0xffffffffu, take, 0);
      }
    }
    if (lane == 0) count[p] = cnt;
  }
  if (use_smem) {
    __syncthreads();
    for (int w = threadIdx.x; w < Nw; w += blockDim.x) gbm[w] = smem[w];
  }
}

}  // namespace

// Largest shared-memory bitmap one block may hold on `device`, in bytes.
extern "C" int mis_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Returns the cudaError_t of the launch (0 = success).  bitmap (P, Nw) and
// count (P,) are updated in place; emb (P, cap, K) int32; n_valid/tau (P,).
extern "C" int mis_greedy_launch(void* bitmap, int* count, const int* emb,
                                 const int* n_valid, const int* tau, int P,
                                 int cap, int K, int k, int Nw, int use_smem,
                                 void* stream) {
  if (k > kMaxK || k > K) return (int)cudaErrorInvalidValue;
  size_t smem = use_smem ? (size_t)Nw * sizeof(uint32_t) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mis_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mis_greedy_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(bitmap), count, emb, n_valid, tau, cap, K, k, Nw,
      use_smem != 0);
  return (int)cudaGetLastError();
}
