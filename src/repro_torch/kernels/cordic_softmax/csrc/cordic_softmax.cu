// Row softmax on raw int32 fixed-point words (the RPE's SoftMax FIFO),
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/cordic_softmax/kernel.py:
// _softmax_kernel (reached through cordic_softmax_raw, kernel.py:47).  Per
// row, at Q(fb) = Q(frac + guard), with the integer datapath of
// cordic_act/csrc/cordic_af.cuh:
//   1. m = max(x << G) over the row;
//   2. e = exp_neg(max(a - m, -30)) and tot = max(sum e, 1), an int32 sum
//      that is exact and independent of the order of the adds (every e is
//      at most 1 << fb, so a row of 151552 words sums below 2**31);
//   3. q = e == 0 ? 0 : e / tot by the division iterations, rounded back.
// Bit-exact against kernels/cordic_softmax/ref.py.
//
// What bounds it on an H100: a row is read twice more than the TPU
// kernel's VMEM-resident block (passes 2 and 3 re-read it, from L2 for
// rows up to tens of MB) and written once; the work is two exp_neg and one
// divide per element, ~300 integer operations, so the int32 lanes bound
// it, as for cordic_act.  The design is one block per row with a loop over
// its columns, so a row of any width works (the TPU kernel held the whole
// row in VMEM; a 151552-wide row does not fit in shared memory and is not
// kept there).  Pass 3 recomputes exp_neg instead of storing e.  The block
// is as wide as the row up to 256 threads, so the 16-wide attention rows
// of a prefill do not leave 240 threads idle.  Spreading one long row
// over several blocks is later work.

#include "../../cordic_act/csrc/cordic_af.cuh"

#include <cstddef>
#include <cstdint>

namespace {

using namespace cordic_af;

template <int NT, typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  constexpr int kWarps = NT / 32;
  if (kWarps == 1) return v;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = op(v, scratch[w]);
  return v;
}

template <int NT>
__global__ void __launch_bounds__(NT)
cordic_softmax_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                      int cols, AfParams p) {
  __shared__ int32_t scratch_i[NT / 32];
  __shared__ uint32_t scratch_u[NT / 32];
  const int32_t* row = x + (size_t)blockIdx.x * cols;
  int32_t* orow = out + (size_t)blockIdx.x * cols;

  int32_t m = INT32_MIN;
  for (int c = threadIdx.x; c < cols; c += NT) {
    const int32_t a = shl(row[c], p.guard);
    m = a > m ? a : m;
  }
  m = block_reduce<NT>(m, [](int32_t u, int32_t v) { return u > v ? u : v; },
                       scratch_i);

  const int32_t lo = neg(p.clamp);
  auto e_at = [&](int c) {
    const int32_t d = sub(shl(row[c], p.guard), m);
    return exp_neg(d > lo ? d : lo, p);
  };
  uint32_t s = 0u;
  for (int c = threadIdx.x; c < cols; c += NT) s += (uint32_t)e_at(c);
  s = block_reduce<NT>(s, [](uint32_t u, uint32_t v) { return u + v; },
                       scratch_u);
  const int32_t tot = (int32_t)s < 1 ? 1 : (int32_t)s;

  for (int c = threadIdx.x; c < cols; c += NT) {
    const int32_t e = e_at(c);
    orow[c] = round_back(e == 0 ? 0 : divide(e, tot, p), p.guard);
  }
}

template <int NT>
cudaError_t launch(const int32_t* x, int32_t* out, int rows, int cols,
                   const cordic_af::AfParams& p, cudaStream_t stream) {
  cordic_softmax_kernel<NT><<<rows, NT, 0, stream>>>(x, out, cols, p);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, cols) row-major int32 words on the device.  p_host: the
// constants of exp_neg and the divide in host memory.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int cordic_softmax_raw(const void* x, void* out, int rows,
                                  int cols, const cordic_af::AfParams* p_host,
                                  int device, void* stream) {
  if (rows < 0 || cols < 0 || p_host == nullptr || p_host->n_hyp < 0 ||
      p_host->n_hyp > cordic_af::kMaxIters || p_host->n_div < 0 ||
      p_host->n_div > cordic_af::kMaxIters || p_host->guard < 1 ||
      p_host->fb > 12)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  const auto* xp = static_cast<const int32_t*>(x);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cols <= 32) return (int)launch<32>(xp, op, rows, cols, *p_host, s);
  if (cols <= 64) return (int)launch<64>(xp, op, rows, cols, *p_host, s);
  if (cols <= 128) return (int)launch<128>(xp, op, rows, cols, *p_host, s);
  return (int)launch<256>(xp, op, rows, cols, *p_host, s);
}
