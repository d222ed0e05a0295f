// Output-stationary CORDIC matmul on raw int32 fixed-point words, sm_90a.
//
// Replaces the TPU kernel repro/kernels/cordic_mac/kernel.py:_mac_kernel
// (reached through cordic_matmul_raw, kernel.py:64).  Every scalar multiply
// is the RPE's n-stage linear-CORDIC shift-add recurrence on the weight
// residual z (delta = +1 when z >= 0, so a zero weight is no zero product):
//
//     for stage i in 0..n-1:
//         delta = z >= 0 ? +1 : -1
//         acc  += delta * (x >> i)        // arithmetic shift
//         z    -= delta * E_i             // E_i = constant(2**-i, fmt)
//
// Semantics kept bit for bit:
//   * E_i come from the host (fixed_point.constant, half-to-even), never
//     1 << (frac - i): for FXP8, E_5 = round(0.5) = 0 and z stops moving.
//   * The accumulator wraps mod 2**32 like the reference's int32: every add
//     runs in uint32 (signed overflow is undefined in C++).
//   * The sum is exact integer arithmetic, so tile order and K split do not
//     change a bit; ragged edges are bounds-checked, never padded.
//
// What bounds it on an H100: decode (M = max_batch = 4) reads every int32
// weight word once, about 35 GB per step at glm4-9b width, so >= 10.5 ms at
// 3.35 TB/s; prefill (M = 64) is integer-ALU bound, M*N*K*n_stages adds.
// The design does the per-weight work once and shares it: each block owns
// one output tile (SYCore's output-stationary dataflow) and stages K-slices
// in shared memory; a weight's n sign bits are computed once per (k, n) in
// the block and reused for every row of the tile (the Pallas kernel's
// delta of shape (1, bn) shared across bm); x >> i is computed once per
// (m, k).  The inner step is one uint32 multiply-add per (m, k, n, stage),
// and the next K-slice is loaded into registers while the current one is
// consumed.
// Small M gets a 4-row tile so decode does no work on absent rows; the K
// axis is split across blocks until the grid fills the card, and the
// partial sums meet in uint32 atomicAdd, which is exact and commutative.
// Tensor cores (wgmma on s8 sign planes), TMA and deeper pipelines are later
// work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxStages = 32;

struct Stages {
  int32_t e[kMaxStages];
};

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
cordic_mac_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                  uint32_t* __restrict__ out, int M, int N, int K,
                  int k_per_split, int n_stages, Stages st) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;                      // threads along N
  constexpr int XLOADS = (BM * BK + NT - 1) / NT;  // x words per thread
  constexpr int WLOADS = (BK * BN + NT - 1) / NT;  // w words per thread
  static_assert(TM % 4 == 0, "rows are read from shared memory as uint4");

  __shared__ uint32_t e_sh[kMaxStages];
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                          // [BK][n_stages][BM]: x >> i
  uint32_t* wb = smem + BK * n_stages * BM;     // [BK][BN]: bit i <=> z_i < 0

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  if (tid == 0) {  // static indices: the parameter block stays in registers
#pragma unroll
    for (int i = 0; i < kMaxStages; ++i) e_sh[i] = (uint32_t)st.e[i];
  }

  // The next K-slice's words wait in registers while the current one is
  // consumed, so global-load latency hides behind the shift-adds.
  int32_t xr[XLOADS], wr[WLOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < XLOADS; ++q) {
      const int e = tid + q * NT;
      const int mm = e % BM, kk = e / BM;
      const int m = m0 + mm, k = k0 + kk;
      // absent rows/cols are 0, which adds nothing whatever the signs
      xr[q] = (e < BM * BK && m < M && k < k_end) ? x[(size_t)m * K + k] : 0;
    }
#pragma unroll
    for (int q = 0; q < WLOADS; ++q) {
      const int e = tid + q * NT;
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, k = k0 + kk;
      wr[q] = (e < BK * BN && n < N && k < k_end) ? w[(size_t)k * N + n] : 0;
    }
  };
  auto stage = [&]() {
    // every shifted copy of x once per (m, k)
#pragma unroll
    for (int q = 0; q < XLOADS; ++q) {
      const int e = tid + q * NT;
      if (e < BM * BK) {
        const int mm = e % BM, kk = e / BM;
        for (int i = 0; i < n_stages; ++i)
          xs[(kk * n_stages + i) * BM + mm] = (uint32_t)(xr[q] >> i);
      }
    }
    // the residual recurrence once per (k, n), kept as sign bits
#pragma unroll
    for (int q = 0; q < WLOADS; ++q) {
      const int e = tid + q * NT;
      if (e < BK * BN) {
        uint32_t z = (uint32_t)wr[q];
        uint32_t bits = 0u;
        for (int i = 0; i < n_stages; ++i) {
          const bool neg = (int32_t)z < 0;
          bits |= (uint32_t)neg << i;
          z = neg ? z + e_sh[i] : z - e_sh[i];
        }
        wb[e] = bits;  // [kk][nn]
      }
    }
  };

  uint32_t acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0u;

  if (k_begin < k_end) load(k_begin);
  __syncthreads();  // e_sh
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < k_end) load(k0 + BK);

    for (int kk = 0; kk < BK; ++kk) {
      uint32_t b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wb[kk * BN + tx + j * TX];
      for (int i = 0; i < n_stages; ++i) {
        uint32_t v[TM];
        const uint4* row =
            reinterpret_cast<const uint4*>(xs + (kk * n_stages + i) * BM + ty * TM);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const uint4 t = row[q];
          v[4 * q] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const uint32_t d = ((b[j] >> i) & 1u) ? 0xFFFFFFFFu : 1u;  // -1 : +1
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[r][j] += d * v[r];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty * TM + r;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (m < M && n < N) atomicAdd(&out[(size_t)m * N + n], acc[r][j]);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const int32_t* x, const int32_t* w, uint32_t* out, int M,
                   int N, int K, const Stages& st, int n_stages, int n_sms,
                   cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + BM - 1) / BM;
  const int k_tiles = (K + BK - 1) / BK;
  // split K until the grid holds about four blocks per SM
  const int want = (4 * n_sms + tiles_n * tiles_m - 1) / (tiles_n * tiles_m);
  int splits = want < 1 ? 1 : (want > k_tiles ? k_tiles : want);
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  if (splits > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(uint32_t) * (size_t)BK * (n_stages * BM + BN);
  auto kernel = cordic_mac_kernel<BM, BN, BK, TM, TN>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tiles_n, tiles_m, splits);
  kernel<<<grid, NT, smem, stream>>>(x, w, out, M, N, K,
                                     tiles_per_split * BK, n_stages, st);
  return cudaGetLastError();
}

}  // namespace

// out (M, N) uint32 must be zero-filled by the caller: blocks that share an
// output tile across K splits add into it.  e_host points to n_stages
// int32 stage constants in host memory.  Returns a cudaError_t.
extern "C" int cordic_mac_raw(const void* x, const void* w, void* out, int M,
                              int N, int K, const int32_t* e_host,
                              int n_stages, int device, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || M < 0 || N < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || N == 0 || K == 0) return (int)cudaSuccess;
  static int sm_count[64] = {};  // per device, read once
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_sms = sm_count[device];
  Stages st = {};
  for (int i = 0; i < n_stages; ++i) st.e[i] = e_host[i];
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  auto* op = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4)  // decode: one 4-row tile, one output column per thread
    err = launch<4, 256, 16, 4, 1>(xp, wp, op, M, N, K, st, n_stages, n_sms, s);
  else         // prefill: 64x128 tiles, an 8x4 register tile per thread
    err = launch<64, 128, 16, 8, 4>(xp, wp, op, M, N, K, st, n_stages, n_sms, s);
  return (int)err;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
