// Shared by flash_fwd.cu, flash_bwd.cu and flash_q8.cu: the argument
// block, typed loads and stores, and the tiling constants.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Mirror of FlashArgs in kernels/flash_attention/kernel.py, field for
// field.  q/do (hq, sq, d), k/v (hkv, sk, d), hq = group * hkv: q head h
// reads kv head h / group (a batch folds into the head axes).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward: dO, q's layout
  void* out;            // forward: O in dt_out
  float* lse;           // forward: (hq, sq), or null
  const float* lse_in;  // backward: the forward's lse
  const float* delta;   // backward: rowsum(dO * O), (hq, sq)
  float* dq;            // backward: (hq, sq, d) float32
  float* dk;            // backward: (hkv, sk, d) float32
  float* dv;
  int hq, hkv, sq, sk, d, group, causal;
  int dt_q, dt_k, dt_v, dt_do, dt_out;
  float scale;          // float32(1 / sqrt(d)), from the host
};

namespace flash {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float ld(const void* p, long long i, int dt) {
  if (dt == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, int dt, float x) {
  if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else if (dt == kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// Rows [r0, r0 + R) of a (heads, s, d) tensor's head `h` into a shared
// tile of R rows of stride DP + 1 floats; rows past s and columns past d
// read as zero.
template <int DP, int R>
__device__ __forceinline__ void load_tile(float* tile, const void* src,
                                          int dt, long long h, int r0,
                                          int s, int d) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int rr = idx / DP, c = idx % DP;
    const int pos = r0 + rr;
    float x = 0.0f;
    if (pos < s && c < d) x = ld(src, (h * s + pos) * d + c, dt);
    tile[rr * (DP + 1) + c] = x;
  }
}

// Sum over the TPR lanes that share a tile row (neighbouring lanes).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The padded head width DP in {32, 64, 128, 256} and the tile rows R
// (64, or 32 at DP = 256, where four 64-row tiles would not fit shared
// memory) for a head width d <= 256; 0 when d is out of range.
inline int padded_dim(int d) {
  if (d <= 0 || d > 256) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

}  // namespace flash
