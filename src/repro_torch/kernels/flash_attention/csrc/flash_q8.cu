// Flash attention forward over an int8 K/V cache, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel_q8.py:
// _flash_q8_kernel, reached through flash_attention_q8_nhd (kernel_q8.py:81):
// kernel 4's online-softmax forward (flash_fwd.cu) with K and V stored as
// int8 words and one float32 scale per (kv head, position) vector, the
// per-block format of core/quant_cache.py.  Each K/V tile is dequantized
// on chip; the softmax runs in float32 (running max, running sum, float32
// accumulator), the denominator is max(l, 1e-30), out is in q's dtype, q
// head h reads kv head h / group.  The causal mask is the TPU kernel's,
// qpos >= kpos aligned top-left (kernel_q8.py:57-60); masked scores are
// -1e30.  So a decode query (Sq = 1) sees only key 0 when causal: the
// decode-shape call is causal = false over the filled prefix of the cache.
// Any sq, sk and d <= 256: tail tiles and rows are masked here, where the
// TPU kernel clamps its tiles to divisors of the lengths.  Forward only.
//
// What bounds it on an H100: reading q, the int8 K/V words and their
// scales once and writing out, against 4 operations per live (q, k) pair
// and channel (Q Kᵀ and P V) at the bf16 tensor-core peak.  A decode call
// (sq = 1) does 4 sk d operations per q head for d + 4 bytes per cached
// vector: bytes, by far.  A causal prefill of 4096 tokens is bounded by
// its operations.  This first kernel runs on the CUDA cores in float32,
// as kernel 4 does; wgmma on dequantized bf16 tiles and TMA are later
// work.
// The design: the group of q heads that share a kv head is packed into
// the rows of one block, so each K/V tile is read from device memory once
// per group, not once per q head (at the decode shape of glm4-9b all 16 q
// heads of a kv head are the rows of one block).  Block (x, kv head) owns
// rows i = x * R + r of the kv head's sq * group (q position, q head)
// pairs, i = qpos * group + g.  One block of 256 threads walks the K/V
// tiles of R keys: it stages the tile's 2 R scales in shared memory, then
// reads the int8 words and writes them dequantized to float32 tiles of
// stride DP + 1 (against bank conflicts).  As in kernel 4, each row
// belongs to TPR = 256 / R neighbouring lanes: each lane scores R / TPR
// keys, the row's max and sum go through warp shuffles, the probabilities
// through a shared tile, and each lane keeps DP / TPR output columns in
// registers.  Tiles past the block's last live q position are never read
// when causal.

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP, int R>
__global__ void __launch_bounds__(kThreads)
    flash_q8_kernel(FlashArgs a, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale) {
  constexpr int TPR = kThreads / R;   // lanes per row
  constexpr int CPT = R / TPR;        // keys per lane per tile
  constexpr int DPT = DP / TPR;       // output columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + R * (DP + 1);
  float* sV = sK + R * (DP + 1);
  float* sP = sV + R * (DP + 1);      // R x (R + 1)
  float* sS = sP + R * (R + 1);       // the tile's K scales, then V scales

  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const long long kh = blockIdx.y;
  const long long i0 = (long long)blockIdx.x * R;   // first (qpos, g) pair
  const long long n_rows = (long long)a.sq * a.group;
  const long long i = i0 + row;
  const bool live_row = i < n_rows;
  const int qpos = live_row ? (int)(i / a.group) : a.sq;
  const long long qh = kh * a.group + (live_row ? i % a.group : 0);
  const long long i_last = (i0 + R < n_rows ? i0 + R : n_rows) - 1;
  const int q_last = (int)(i_last / a.group);   // the block's last qpos

  // the block's q rows: row r is q head qh at position qpos
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int rr = idx / DP, c = idx % DP;
    const long long ii = i0 + rr;
    float x = 0.0f;
    if (ii < n_rows && c < a.d) {
      const long long h = kh * a.group + ii % a.group;
      x = ld(a.q, (h * a.sq + ii / a.group) * a.d + c, a.dt_q);
    }
    sQ[rr * (DP + 1) + c] = x;
  }
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.0f;

  const int8_t* kw = static_cast<const int8_t*>(a.k);
  const int8_t* vw = static_cast<const int8_t*>(a.v);
  for (int k0 = 0; k0 < a.sk; k0 += R) {
    if (a.causal && k0 > q_last) break;          // dead from here on
    __syncthreads();                             // last tile's reads done
    for (int rr = threadIdx.x; rr < 2 * R; rr += kThreads) {
      const int pos = k0 + rr % R;
      const float* sc = rr < R ? k_scale : v_scale;
      sS[rr] = pos < a.sk ? sc[kh * a.sk + pos] : 0.0f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
      const int rr = idx / DP, c = idx % DP;
      const int pos = k0 + rr;
      float kx = 0.0f, vx = 0.0f;
      if (pos < a.sk && c < a.d) {
        const long long o = (kh * a.sk + pos) * a.d + c;
        kx = (float)kw[o] * sS[rr];
        vx = (float)vw[o] * sS[R + rr];
      }
      sK[rr * (DP + 1) + c] = kx;
      sV[rr * (DP + 1) + c] = vx;
    }
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

  if (!live_row) return;
  const float denom = fmaxf(l, 1e-30f);
  const long long o = (qh * a.sq + qpos) * a.d;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int col = sub + TPR * c;
    if (col < a.d) st(a.out, o + col, a.dt_out, acc[c] / denom);
  }
}

template <int DP, int R>
cudaError_t launch(const FlashArgs& a, const float* ks, const float* vs,
                   cudaStream_t s) {
  const int smem =
      (3 * R * (DP + 1) + R * (R + 1) + 2 * R) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_q8_kernel<DP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.sq * a.group;
  const dim3 grid((unsigned)((rows + R - 1) / R), a.hkv);
  flash_q8_kernel<DP, R><<<grid, kThreads, smem, s>>>(a, ks, vs);
  return cudaGetLastError();
}

}  // namespace

// a: device pointers, shapes and dtype codes in host memory (k, v int8);
// k_scale, v_scale: device pointers to (hkv, sk) float32.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int flash_forward_q8(const FlashArgs* a, const float* k_scale,
                                const float* v_scale, int device,
                                void* stream) {
  if (a == nullptr || k_scale == nullptr || v_scale == nullptr ||
      a->hq <= 0 || a->hkv <= 0 || a->group <= 0 ||
      a->hq != a->group * a->hkv || a->sq < 0 || a->sk < 0 ||
      a->dt_k != flash::kI8 || a->dt_v != flash::kI8 ||
      a->dt_q == flash::kI8 || a->dt_out != a->dt_q)
    return (int)cudaErrorInvalidValue;
  const int dp = flash::padded_dim(a->d);
  if (dp == 0 || a->hkv > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->sq == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 32: return (int)launch<32, 64>(*a, k_scale, v_scale, s);
    case 64: return (int)launch<64, 64>(*a, k_scale, v_scale, s);
    case 128: return (int)launch<128, 64>(*a, k_scale, v_scale, s);
    default: return (int)launch<256, 32>(*a, k_scale, v_scale, s);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
