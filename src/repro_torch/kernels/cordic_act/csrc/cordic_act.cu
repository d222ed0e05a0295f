// Elementwise DA-VINCI activation (tanh, sigmoid, exp) on raw int32
// fixed-point words, sm_90a.
//
// Replaces the TPU kernel repro/kernels/cordic_act/kernel.py:_act_kernel
// (reached through cordic_act_raw, kernel.py:118).  Per element, at
// Q(fb) = Q(frac + guard):
//   exp:     a = clip(x << G, -30, 0);      e**a, rounded back
//   tanh:    a' = min(|a|, cap);  q = (e**(-2a') - 1) / (e**(-2a') + 1),
//            -q for a >= 0, rounded back
//   sigmoid: e = e**max(-|a|, -30);  q = 1 / (1 + e),
//            1 - q for a < 0, rounded back
// with e**a from cordic_af.cuh's integer ln2 range extension and
// hyperbolic rotation, and the quotients from its division iterations.
// Bit-exact against kernels/cordic_act/ref.py.
//
// What bounds it on an H100: each element is read once and written once
// (8 bytes), against ~10 integer operations per hyperbolic and per
// division iteration (tanh at FXP16: 5 + 12 iterations, ~200 operations).
// At 25 operations per byte the int32 lanes, not HBM, are the limit for
// any tensor large enough to fill the card.  The design is one thread per
// element in a grid-stride loop, any (R, C) flattened, no tiles and no
// shared memory: the TPU kernel's (256, 256) blocks only existed to feed
// VMEM.  Every constant is a kernel parameter (AfParams), so nothing is
// recomputed per element.

#include "cordic_af.cuh"

#include <cstddef>
#include <cstdint>

namespace {

using namespace cordic_af;

__device__ __forceinline__ int32_t act(int32_t xr, const AfParams& p) {
  const int32_t a = shl(xr, p.guard);
  if (p.af == kExp) {
    const int32_t c = a < neg(p.clamp) ? neg(p.clamp) : (a > 0 ? 0 : a);
    return round_back(exp_neg(c, p), p.guard);
  }
  if (p.af == kTanh) {
    int32_t a_abs = abs32(a);
    a_abs = a_abs < p.cap ? a_abs : p.cap;
    const int32_t e2a = exp_neg(neg(add(a_abs, a_abs)), p);
    const int32_t q = divide(sub(e2a, p.one), add(e2a, p.one), p);
    return round_back(a >= 0 ? neg(q) : q, p.guard);
  }
  int32_t na = neg(abs32(a));  // sigmoid
  na = na > neg(p.clamp) ? na : neg(p.clamp);
  const int32_t e = exp_neg(na, p);
  const int32_t q = divide(p.one, add(p.one, e), p);
  return round_back(a >= 0 ? q : sub(p.one, q), p.guard);
}

__global__ void __launch_bounds__(256)
cordic_act_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  long long n, AfParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = act(x[i], p);
}

}  // namespace

// x, out: n int32 words on the device.  p_host: the AF's constants in host
// memory.  Launches on `stream`; returns a cudaError_t.
extern "C" int cordic_act_raw(const void* x, void* out, long long n,
                              const cordic_af::AfParams* p_host, int device,
                              void* stream) {
  if (n < 0 || p_host == nullptr || p_host->n_hyp < 0 ||
      p_host->n_hyp > cordic_af::kMaxIters || p_host->n_div < 0 ||
      p_host->n_div > cordic_af::kMaxIters || p_host->guard < 1 ||
      p_host->fb > 12)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond
  cordic_act_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n, *p_host);
  return (int)cudaGetLastError();
}
