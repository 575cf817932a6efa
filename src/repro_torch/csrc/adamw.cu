// The AdamW update of one parameter tensor, fused: one pass that reads the
// parameter, its gradient and both moments and writes the parameter and
// the moments.
//
// Replaces no TPU kernel: the reference updates with `jnp` expressions
// that XLA fuses (src/repro/train/optimizer.py `adamw_update`); the port's
// plain version (`kernels/adamw/ref.py`, used on the CPU) runs the same
// expressions as ~20 elementwise PyTorch passes, which were ~60 % of a
// qwen3-1.7b train step's device time and ~95 % of dlrm-rm2's on the card.
// It computes, per element, exactly the plain version's f32 operations in
// its order, each rounded to nearest (the `__f*_rn` intrinsics keep the
// compiler from contracting a multiply and an add into one FMA), so its
// result equals the plain version's bit for bit:
//   g' = g·scale;  m' = b1·m + (1 − b1)·g';  v' = b2·v + (1 − b2)·g'²
//   p' = p − lr·((m'/c1) / (sqrt(v'/c2) + eps) + wd·p)
// with scale (the global-norm clip), lr, c1 = 1 − b1^t and c2 = 1 − b2^t
// read from a 4-float device array that the wrapper computes without a
// host sync.  f32 parameters, gradients and moments.
//
// What bounds it on an H100: memory, 28 bytes an element (four f32
// reads, three writes) against ~20 FLOPs: 14.4 ms for qwen3-1.7b's 1.72 G
// parameters at 3.35 TB/s.  Each thread takes 4 consecutive elements as
// one 16-byte load of each input (where the tensors are 16-byte aligned
// and the count a multiple of 4; else one element a thread), a grid-stride
// loop over the tensor.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float scale, float lr, float c1,
                                       float c2, const Consts& k) {
  const float gs = __fmul_rn(g, scale);
  const float mn = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, gs));
  const float vn =
      __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.omb2, __fmul_rn(gs, gs)));
  const float mh = __fdiv_rn(mn, c1);
  const float vh = __fdiv_rn(vn, c2);
  const float delta = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), k.eps)),
                                __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
  m = mn;
  v = vn;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, long long n,
                 const float* __restrict__ scalars, Consts k) {
  const float scale = scalars[0], lr = scalars[1], c1 = scalars[2],
              c2 = scalars[3];
  const long long stride = (long long)gridDim.x * kThreads;
  if (VEC) {
    const long long n4 = n / 4;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
         i += stride) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      update(pp.x, gg.x, mm.x, vv.x, scale, lr, c1, c2, k);
      update(pp.y, gg.y, mm.y, vv.y, scale, lr, c1, c2, k);
      update(pp.z, gg.z, mm.z, vv.z, scale, lr, c1, c2, k);
      update(pp.w, gg.w, mm.w, vv.w, scale, lr, c1, c2, k);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
  } else {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride) {
      float pp = p[i], mm = m[i], vv = v[i];
      update(pp, g[i], mm, vv, scale, lr, c1, c2, k);
      p[i] = pp;
      m[i] = mm;
      v[i] = vv;
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = success).  p, g, m, v: n f32 each;
// scalars: 4 f32 on the device (scale, lr, 1 − b1^t, 1 − b2^t); b1, 1 − b1,
// b2, 1 − b2, eps and wd as the f32 values of the configuration's numbers.
// vec4: every pointer 16-byte aligned and n a multiple of 4 (the wrapper
// decides).
extern "C" int adamw_launch(void* p, const void* g, void* m, void* v,
                            long long n, const void* scalars, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, int vec4, int sm_count, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts k{b1, omb1, b2, omb2, eps, wd};
  const long long work = vec4 ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(sm_count > 0 ? sm_count : 132) * 8;
  if (blocks > cap) blocks = cap;
  float* fp = static_cast<float*>(p);
  const float* fg = static_cast<const float*>(g);
  float* fm = static_cast<float*>(m);
  float* fv = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  if (vec4)
    adamw_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(fp, fg, fm, fv,
                                                             n, sc, k);
  else
    adamw_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(fp, fg, fm, fv,
                                                              n, sc, k);
  return (int)cudaGetLastError();
}
