// Flash attention backward, the recompute scheme, sm_90a.
//
// Replaces the TPU kernels repro/kernels/flash_attention/kernel_bwd.py:
// _dq_kernel and _dkv_kernel (with _tile_grads), reached through
// flash_attention_bwd_nhd (kernel_bwd.py:141).  From the forward's
// per-row lse and delta = rowsum(dO * O) (computed by the wrapper), each
// probability is rebuilt as p = exp(q·k scale - lse) and
//   ds = p (dO·v - delta) scale,
//   dQ = dS K,  dK = dSᵀ Q,  dV = Pᵀ dO,
// float32 throughout, dK and dV summed over each kv head's group of q
// heads.  The causal mask is the TPU kernel's, qpos >= kpos aligned
// top-left, -1e30 as there; causally dead tiles are skipped.  Any sq, sk
// and d <= 256, tails masked.
//
// What bounds it on an H100: 8 sq sk d operations per q head (Q Kᵀ and
// dO Vᵀ recomputed, then dS K, dSᵀ Q and Pᵀ dO; half when causal) at the
// bf16 tensor-core peak, against reading q, k, v, dO, lse and delta and
// writing dq, dk, dv once: operations.  Here, as in the forward, the
// products run on the CUDA cores in float32; wgmma is later work.
// The design: two launches, as on the TPU.
//  * dQ: one block per (q head, tile of R q rows); Q and dO stay in
//    shared memory while K and V tiles stream through.  TPR = 256 / R
//    neighbouring lanes own a q row: each recomputes R / TPR entries of
//    p and ds, ds goes through a shared tile, and each lane accumulates
//    DP / TPR columns of the row's dQ in registers.
//  * dK/dV: one block per (kv head, tile of R kv rows); K and V stay in
//    shared memory while, for each q head of the group, Q and dO tiles
//    stream through, so the GQA group-sum happens in the accumulation;
//    lanes own kv rows and accumulate their dK and dV columns.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP, int R>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashArgs a) {
  constexpr int TPR = kThreads / R;
  constexpr int CPT = R / TPR;
  constexpr int DPT = DP / TPR;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + R * (DP + 1);      // dO
  float* sK = sO + R * (DP + 1);
  float* sV = sK + R * (DP + 1);
  float* sS = sV + R * (DP + 1);      // ds, R x (R + 1)

  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const long long qh = blockIdx.y;
  const long long kh = qh / a.group;
  const int q0 = blockIdx.x * R;
  const int qpos = q0 + row;
  const int q_last = min(q0 + R, a.sq) - 1;

  load_tile<DP, R>(sQ, a.q, a.dt_q, qh, q0, a.sq, a.d);
  load_tile<DP, R>(sO, a.dout, a.dt_do, qh, q0, a.sq, a.d);
  const bool live_row = qpos < a.sq;
  const float lse = live_row ? a.lse_in[qh * a.sq + qpos] : 0.0f;
  const float delta = live_row ? a.delta[qh * a.sq + qpos] : 0.0f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < a.sk; k0 += R) {
    if (a.causal && k0 > q_last) break;
    __syncthreads();
    load_tile<DP, R>(sK, a.k, a.dt_k, kh, k0, a.sk, a.d);
    load_tile<DP, R>(sV, a.v, a.dt_v, kh, k0, a.sk, a.d);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = sub + TPR * j;
      const int kpos = k0 + col;
      float qk = 0.0f, dp = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DP; ++c) {
        qk = fmaf(sQ[row * (DP + 1) + c], sK[col * (DP + 1) + c], qk);
        dp = fmaf(sO[row * (DP + 1) + c], sV[col * (DP + 1) + c], dp);
      }
      float sv = qk * a.scale;
      if (a.causal && qpos < kpos) sv = kNegInf;
      const float p = (kpos < a.sk) ? expf(sv - lse) : 0.0f;
      sS[row * (R + 1) + col] = p * (dp - delta) * a.scale;
    }
    __syncwarp();
    for (int kk = 0; kk < R; ++kk) {
      const float ds = sS[row * (R + 1) + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        acc[c] = fmaf(ds, sK[kk * (DP + 1) + sub + TPR * c], acc[c]);
    }
  }

  if (!live_row) return;
  const long long o = (qh * a.sq + qpos) * a.d;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int col = sub + TPR * c;
    if (col < a.d) a.dq[o + col] = acc[c];
  }
}

template <int DP, int R>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashArgs a) {
  constexpr int TPR = kThreads / R;
  constexpr int CPT = R / TPR;
  constexpr int DPT = DP / TPR;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + R * (DP + 1);
  float* sQ = sV + R * (DP + 1);
  float* sO = sQ + R * (DP + 1);      // dO
  float* sP = sO + R * (DP + 1);      // p,  R kv rows x (R + 1)
  float* sS = sP + R * (R + 1);       // ds
  float* sL = sS + R * (R + 1);       // the q tile's lse
  float* sD = sL + R;                 // and delta

  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const long long kh = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const int kpos = k0 + row;

  load_tile<DP, R>(sK, a.k, a.dt_k, kh, k0, a.sk, a.d);
  load_tile<DP, R>(sV, a.v, a.dt_v, kh, k0, a.sk, a.d);
  float dk[DPT], dv[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk[c] = dv[c] = 0.0f;

  // The first q tile with a live row: q_last >= k0 when causal.
  const int qt0 = a.causal ? (k0 / R) * R : 0;
  for (int g = 0; g < a.group; ++g) {
    const long long qh = kh * a.group + g;
    for (int q0 = qt0; q0 < a.sq; q0 += R) {
      __syncthreads();
      load_tile<DP, R>(sQ, a.q, a.dt_q, qh, q0, a.sq, a.d);
      load_tile<DP, R>(sO, a.dout, a.dt_do, qh, q0, a.sq, a.d);
      for (int i = threadIdx.x; i < R; i += kThreads) {
        const bool in = q0 + i < a.sq;
        sL[i] = in ? a.lse_in[qh * a.sq + q0 + i] : 0.0f;
        sD[i] = in ? a.delta[qh * a.sq + q0 + i] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int qc = sub + TPR * j;
        const int qpos = q0 + qc;
        float qk = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int c = 0; c < DP; ++c) {
          qk = fmaf(sQ[qc * (DP + 1) + c], sK[row * (DP + 1) + c], qk);
          dp = fmaf(sO[qc * (DP + 1) + c], sV[row * (DP + 1) + c], dp);
        }
        float sv = qk * a.scale;
        if (a.causal && qpos < kpos) sv = kNegInf;
        const float p = (qpos < a.sq) ? expf(sv - sL[qc]) : 0.0f;
        sP[row * (R + 1) + qc] = p;
        sS[row * (R + 1) + qc] = p * (dp - sD[qc]) * a.scale;
      }
      __syncwarp();
      for (int qq = 0; qq < R; ++qq) {
        const float p = sP[row * (R + 1) + qq];
        const float ds = sS[row * (R + 1) + qq];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv[c] = fmaf(p, sO[qq * (DP + 1) + sub + TPR * c], dv[c]);
          dk[c] = fmaf(ds, sQ[qq * (DP + 1) + sub + TPR * c], dk[c]);
        }
      }
    }
  }

  if (kpos >= a.sk) return;
  const long long o = (kh * a.sk + kpos) * a.d;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int col = sub + TPR * c;
    if (col < a.d) {
      a.dk[o + col] = dk[c];
      a.dv[o + col] = dv[c];
    }
  }
}

template <int DP, int R>
cudaError_t launch(const FlashArgs& a, cudaStream_t s) {
  const int tile = R * (DP + 1);
  const int smem_dq = (4 * tile + R * (R + 1)) * (int)sizeof(float);
  const int smem_dkv =
      (4 * tile + 2 * R * (R + 1) + 2 * R) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<DP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel<DP, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<DP, R>
      <<<dim3((a.sq + R - 1) / R, a.hq), kThreads, smem_dq, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<DP, R>
      <<<dim3((a.sk + R - 1) / R, a.hkv), kThreads, smem_dkv, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// a: device pointers, shapes and dtype codes in host memory.  Launches
// the dQ pass, then the dK/dV pass, on `stream`; returns a cudaError_t.
extern "C" int flash_backward(const FlashArgs* a, int device, void* stream) {
  if (a == nullptr || a->hq <= 0 || a->hkv <= 0 || a->group <= 0 ||
      a->hq != a->group * a->hkv || a->sq < 0 || a->sk < 0)
    return (int)cudaErrorInvalidValue;
  const int dp = flash::padded_dim(a->d);
  if (dp == 0 || a->hq > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->sq == 0 || a->sk == 0) return (int)cudaSuccess;
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
