// Shared by flash_fwd.cu, flash_bwd.cu and flash_q8.cu: the argument
// block, typed loads and stores, and the tiling constants; for the
// tensor-core kernels (flash_bwd.cu, flash_q8.cu) the bf16 mma.sync,
// ldmatrix and cp.async wrappers and the hi/lo split of a float32 value
// into two bf16 values.
#pragma once

#include <cstdint>

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

// ---------------------------------------------------------------------
// Tensor-core building blocks (sm_80 and later; built here for sm_90a).
//
// mma.sync.m16n8k16, bf16 inputs, float32 accumulation.  Fragments, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
//   B (16 x 8):             b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
//   C (16 x 8, float32):    c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, ..).
// The lower-indexed element of a pair sits in the low 16 bits.  A C tile
// pair (n8 tiles 2j, 2j + 1) is therefore the A fragment of the next
// product's k16 step j, with no trip through shared memory.
// ---------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Without .trans lane l receives (row g, cols 2t..2t+1) of
// each matrix, with .trans (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 tile at (r0, c0) of a row-major bf16 tile
// of row stride ld elements.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int ld, int r0,
                                       int c0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, t + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + c0 + (l >> 4) * 8);
}

// B fragments of two n8 tiles (n0..n0+15) at depth k0..k0+15, from a tile
// stored [n][k] (k contiguous): b[0], b[1] for n0.., b[2], b[3] for n0 + 8..
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int ld,
                                          int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, t + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (n contiguous), through .trans.
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int ld,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 (float32) as hi = bf16(x) and lo = bf16(x - hi): hi + lo holds x
// to 2^-17 of its value, so hi·w + lo·w on the tensor cores keeps a
// float32 operand's product to float32's band where one bf16 rounding
// (2^-9) would not.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 16 bytes from global to shared memory, asynchronously; valid = false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace flash
