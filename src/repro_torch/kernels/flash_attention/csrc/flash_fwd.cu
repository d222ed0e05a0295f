// Flash attention forward with the per-row log-sum-exp, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// _flash_kernel, reached through flash_attention_nhd (kernel.py:82):
// online-softmax attention, causal or not, GQA (q head h reads kv head
// h / group), float32 math, out in q's dtype and, on request, the per-row
// lse = m + log(max(l, 1e-30)) of the scaled scores that the fused
// backward (flash_bwd.cu) recomputes probabilities from.  The causal mask
// is the TPU kernel's, qpos >= kpos aligned top-left; masked scores are
// -1e30 as there.  Any sq, sk and d <= 256: tail tiles are masked here,
// where the TPU kernel clamps its tile to a divisor of the length.
//
// What bounds it on an H100: 4 sq sk d operations per head (2 sq sk d
// for Q Kᵀ, 2 for P V; half of each when causal) against reading q, k,
// v once and writing out and lse — operations, by far, at the bf16
// tensor-core peak.  This first kernel runs on the CUDA cores in float32
// (67 TFLOP/s at best), so it sits well above that bound; wgmma and TMA
// are later work.
// The design: one block of 256 threads per (q head, tile of R q rows); Q
// stays in shared memory while K and V tiles of R rows stream through it
// (stride DP + 1 floats against bank conflicts).  Each q row belongs to
// TPR = 256 / R neighbouring lanes: each lane scores R / TPR keys, the
// row's max and sum go through warp shuffles, the probabilities through
// a shared tile, and each lane keeps DP / TPR columns of the output row
// in registers.  Causally dead k tiles are never loaded.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP, int R>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  constexpr int TPR = kThreads / R;   // lanes per q row
  constexpr int CPT = R / TPR;        // keys per lane per tile
  constexpr int DPT = DP / TPR;       // output columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + R * (DP + 1);
  float* sV = sK + R * (DP + 1);
  float* sP = sV + R * (DP + 1);      // R x (R + 1)

  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const long long qh = blockIdx.y;
  const long long kh = qh / a.group;
  const int q0 = blockIdx.x * R;
  const int qpos = q0 + row;
  const int q_last = min(q0 + R, a.sq) - 1;

  load_tile<DP, R>(sQ, a.q, a.dt_q, qh, q0, a.sq, a.d);
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < a.sk; k0 += R) {
    if (a.causal && k0 > q_last) break;          // dead from here on
    __syncthreads();                             // last tile's reads done
    load_tile<DP, R>(sK, a.k, a.dt_k, kh, k0, a.sk, a.d);
    load_tile<DP, R>(sV, a.v, a.dt_v, kh, k0, a.sk, a.d);
    __syncthreads();

    float s[CPT];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = sub + TPR * j;
      const int kpos = k0 + col;
      float dot = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DP; ++c)
        dot = fmaf(sQ[row * (DP + 1) + c], sK[col * (DP + 1) + c], dot);
      float sv = dot * a.scale;
      if (a.causal && qpos < kpos) sv = kNegInf;
      s[j] = sv;
      if (kpos < a.sk) tmax = fmaxf(tmax, sv);
    }
    const float m_new = fmaxf(m, row_max<TPR>(tmax));
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = sub + TPR * j;
      const float p = (k0 + col < a.sk) ? expf(s[j] - m_new) : 0.0f;
      sP[row * (R + 1) + col] = p;
      psum += p;
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + row_sum<TPR>(psum);
    m = m_new;
    __syncwarp();                                // the row's P is written
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= alpha;
    for (int kk = 0; kk < R; ++kk) {
      const float p = sP[row * (R + 1) + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        acc[c] = fmaf(p, sV[kk * (DP + 1) + sub + TPR * c], acc[c]);
    }
  }

  if (qpos >= a.sq) return;
  const float denom = fmaxf(l, 1e-30f);
  const long long o = (qh * a.sq + qpos) * a.d;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int col = sub + TPR * c;
    if (col < a.d) st(a.out, o + col, a.dt_out, acc[c] / denom);
  }
  if (a.lse != nullptr && sub == 0) a.lse[qh * a.sq + qpos] = m + logf(denom);
}

template <int DP, int R>
cudaError_t launch(const FlashArgs& a, cudaStream_t s) {
  const int smem = (3 * R * (DP + 1) + R * (R + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + R - 1) / R, a.hq);
  flash_fwd_kernel<DP, R><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// a: device pointers, shapes and dtype codes in host memory.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int flash_forward(const FlashArgs* a, int device, void* stream) {
  if (a == nullptr || a->hq <= 0 || a->hkv <= 0 || a->group <= 0 ||
      a->hq != a->group * a->hkv || a->sq < 0 || a->sk < 0)
    return (int)cudaErrorInvalidValue;
  const int dp = flash::padded_dim(a->d);
  if (dp == 0 || a->hq > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->sq == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 32: return (int)launch<32, 64>(*a, s);
    case 64: return (int)launch<64, 64>(*a, s);
    case 128: return (int)launch<128, 64>(*a, s);
    default: return (int)launch<256, 32>(*a, s);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
