// Flash attention backward, the recompute scheme, on Hopper's tensor
// cores (bf16 mma.sync with float32 accumulation), sm_90a.
//
// Replaces the TPU kernels repro/kernels/flash_attention/kernel_bwd.py:
// _dq_kernel and _dkv_kernel (with _tile_grads), reached through
// flash_attention_bwd_nhd (kernel_bwd.py:141).  From the forward's
// per-row lse and delta = rowsum(dO * O) (computed by the wrapper), each
// probability is rebuilt as p = exp(q·k scale - lse) and
//   ds = p (dO·v - delta) scale,
//   dQ = dS K,  dK = dSᵀ Q,  dV = Pᵀ dO,
// float32 out, dK and dV summed over each kv head's group of q heads.
// The causal mask is the TPU kernel's, qpos >= kpos aligned top-left,
// -1e30 as there; causally dead tiles are skipped.  Any sq, sk and
// d <= 256, tails masked.
//
// What bounds it on an H100: 10 sq sk d flops per q head (Q Kᵀ and dO Vᵀ
// recomputed, then dS K, dSᵀ Q and Pᵀ dO; half when causal) at the bf16
// tensor-core peak, against reading q, k, v, dO, lse and delta and
// writing dq, dk, dv once: operations.  The first kernel ran every
// product on the CUDA cores in float32, with 128 dK/dV blocks on 132 SMs
// at glm4-9b's layout (129-130 ms, 101-160x SDPA).
//
// The design:
//  * Every product is a bf16 m16n8k16 mma.sync with float32 sums, the
//    fragments read by ldmatrix from shared tiles of row stride DP + 8
//    (against bank conflicts).  Q Kᵀ and dO Vᵀ of bf16 inputs are exact
//    products.  P and dS are float32 and a bf16 rounding (2^-9) would
//    break the float32 band of the TPU kernel, which casts every tile to
//    float32: each is split into hi = bf16(x) and lo = bf16(x - hi) and
//    multiplied twice (2^-17).  Inputs that are not bf16 (float32, fp16)
//    are split the same way by a first pass into two bf16 planes, and a
//    product of two split operands is hi·hi + hi·lo + lo·hi.  A bf16
//    input whose rows are not 16-byte multiples (d % 8 != 0) is copied
//    to one padded plane by the same pass.
//  * The products chain through registers: the float32 accumulator of
//    Sᵀ = K Qᵀ (dK/dV pass) or S = Q Kᵀ (dQ pass) is, split, the A
//    fragment of the product that consumes P or dS.
//  * Two passes, as on the TPU, so every sum is taken in a fixed order:
//    dQ: one block per (q head, 16 NW q rows, output column chunk), Q
//        and dO resident, K/V tiles streamed through a cp.async ring of
//        two stages;
//    dK/dV: one block per (16 NW keys, kv head, part of its group,
//        column chunk), K and V resident, Q/dO tiles (with their lse and
//        delta) streamed through the ring over the part's q heads.  The
//        group of q heads is cut into `nsplit` parts (the wrapper picks
//        the fewest that give the card four blocks an SM), whose
//        float32 partial sums a last short pass adds in part order:
//        deterministic, no atomics.  At glm4-9b's layout the pass has
//        1024 blocks where the first kernel had 128.
//  * Each warp owns 16 rows; a thread keeps its rows' output columns in
//    registers, at most 128 columns (DC): at d > 128 the output columns
//    are cut over two blocks that recompute the same scores.

#include "flash_common.cuh"

// Mirror of FlashBwdWork in kernels/flash_attention/kernel.py.
struct FlashBwdWork {
  void* planes;    // bf16 planes of q, k, v, dO (np each, rows of ld), or
                   // null: the inputs are read as they are (bf16, ld = d)
  float* dk_part;  // (nsplit, hkv, sk, d) float32 partial sums, or null
  float* dv_part;  // when nsplit == 1
  int np;          // 1: one bf16 plane; 2: hi and lo planes
  int ld;          // the planes' row stride in elements, a multiple of 8
  int nsplit;      // dK/dV parts of each kv head's group; divides group
};

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// The bf16 operands as the main passes read them: plane p of q and dO at
// q + p * q_plane, of k and v at k + p * k_plane; rows of ld elements.
struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  long long q_plane, k_plane;
  int ld;
};

// Rows [r0, r0 + ROWS) of head h (of s rows) of every plane into a shared
// tile [NP][ROWS][DP + 8], 16 bytes a copy; rows past s and columns past
// ld read as zero.
template <int DP, int ROWS, int NP, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long plane, long long h,
                                          int r0, int s, int ld) {
  constexpr int CH = DP / 8;
  constexpr int LDS = DP + 8;
  for (int idx = threadIdx.x; idx < NP * ROWS * CH; idx += THREADS) {
    const int p = idx / (ROWS * CH);
    const int rem = idx - p * ROWS * CH;
    const int r = rem / CH, c = rem - (rem / CH) * CH;
    const int pos = r0 + r;
    const bool ok = pos < s && c * 8 < ld;
    const bf16* g = ok ? src + p * plane + (h * s + pos) * ld + c * 8 : src;
    cp_async16(dst + (p * ROWS + r) * LDS + c * 8, g, ok);
  }
}

// dQ pass.  NW warps of 16 q rows each; BS keys a streamed tile.
template <int DP, int NP, int NW, int BS>
__global__ void __launch_bounds__(32 * NW)
    dq_kernel(FlashArgs a, Operands op) {
  constexpr int THREADS = 32 * NW, BQ = 16 * NW, LDS = DP + 8;
  constexpr int DC = DP < 128 ? DP : 128;  // output columns a block
  constexpr int NT = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [NP][BQ][LDS]
  bf16* sO = sQ + NP * BQ * LDS;                  // dO
  bf16* sK = sO + NP * BQ * LDS;                  // [2][NP][BS][LDS]
  bf16* sV = sK + 2 * NP * BS * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qh = blockIdx.y;
  const long long kh = qh / a.group;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * DC;
  const int q_last = min(q0 + BQ, a.sq) - 1;
  int n_tiles = (a.sk + BS - 1) / BS;
  if (a.causal) n_tiles = min(n_tiles, q_last / BS + 1);

  load_rows<DP, BQ, NP, THREADS>(sQ, op.q, op.q_plane, qh, q0, a.sq, op.ld);
  load_rows<DP, BQ, NP, THREADS>(sO, op.o, op.q_plane, qh, q0, a.sq, op.ld);
  auto issue = [&](int it) {
    const int st = it & 1;
    load_rows<DP, BS, NP, THREADS>(sK + st * NP * BS * LDS, op.k, op.k_plane,
                                   kh, it * BS, a.sk, op.ld);
    load_rows<DP, BS, NP, THREADS>(sV + st * NP * BS * LDS, op.v, op.k_plane,
                                   kh, it * BS, a.sk, op.ld);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  int qpos[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + warp * 16 + g + 8 * r;
    const bool live = qpos[r] < a.sq;
    lse[r] = live ? a.lse_in[qh * a.sq + qpos[r]] : 0.0f;
    dlt[r] = live ? a.delta[qh * a.sq + qpos[r]] : 0.0f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tK = sK + (it & 1) * NP * BS * LDS;
    const bf16* tV = sV + (it & 1) * NP * BS * LDS;
    const int k0 = it * BS;

    float s[BS / 8][4], dp[BS / 8][4];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    // S = Q Kᵀ and dP = dO Vᵀ over the head width
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t qa[NP][4], oa[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        frag_a(qa[p], sQ + p * BQ * LDS, LDS, warp * 16, kk);
        frag_a(oa[p], sO + p * BQ * LDS, LDS, warp * 16, kk);
      }
#pragma unroll
      for (int j = 0; j < BS / 16; ++j) {
        uint32_t kb[NP][4], vb[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          frag_b_nk(kb[p], tK + p * BS * LDS, LDS, j * 16, kk);
          frag_b_nk(vb[p], tV + p * BS * LDS, LDS, j * 16, kk);
        }
#pragma unroll
        for (int pa = 0; pa < NP; ++pa)
#pragma unroll
          for (int pb = 0; pb + pa < NP; ++pb) {
            mma_bf16(s[2 * j], qa[pa], kb[pb][0], kb[pb][1]);
            mma_bf16(s[2 * j + 1], qa[pa], kb[pb][2], kb[pb][3]);
            mma_bf16(dp[2 * j], oa[pa], vb[pb][0], vb[pb][1]);
            mma_bf16(dp[2 * j + 1], oa[pa], vb[pb][2], vb[pb][3]);
          }
      }
    }
    // p and ds, in place of s
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        float sv = s[j][e] * a.scale;
        if (a.causal && qpos[r] < kpos) sv = kNegInf;
        const float p = kpos < a.sk ? expf(sv - lse[r]) : 0.0f;
        s[j][e] = p * (dp[j][e] - dlt[r]) * a.scale;
      }
    // dQ += dS K, dS split hi/lo
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) {
      uint32_t hi[4], lo[4];
      split2(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
      split2(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        uint32_t kb[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          frag_b_kn(kb[p], tK + p * BS * LDS, LDS, j * 16, c0 + n * 16);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(acc[2 * n], hi, kb[p][0], kb[p][1]);
          mma_bf16(acc[2 * n + 1], hi, kb[p][2], kb[p][3]);
        }
        mma_bf16(acc[2 * n], lo, kb[0][0], kb[0][1]);
        mma_bf16(acc[2 * n + 1], lo, kb[0][2], kb[0][3]);
      }
    }
    __syncthreads();   // the stage is free for the load two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qpos[e >> 1];
      const int col = c0 + n * 8 + 2 * t + (e & 1);
      if (r < a.sq && col < a.d) a.dq[(qh * a.sq + r) * a.d + col] = acc[n][e];
    }
}

// dK/dV pass.  NW warps of 16 keys each; BS q rows a streamed tile.  The
// block walks heads_per_part q heads of kv head kh's group, its part
// `part` of nsplit, and writes its partial sums to out_k/out_v + part.
template <int DP, int NP, int NW, int BS>
__global__ void __launch_bounds__(32 * NW)
    dkv_kernel(FlashArgs a, Operands op, float* out_k, float* out_v,
               int nsplit) {
  constexpr int THREADS = 32 * NW, BK = 16 * NW, LDS = DP + 8;
  constexpr int DC = DP < 128 ? DP : 128;
  constexpr int NT = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [NP][BK][LDS]
  bf16* sV = sK + NP * BK * LDS;
  bf16* sQ = sV + NP * BK * LDS;                  // [2][NP][BS][LDS]
  bf16* sO = sQ + 2 * NP * BS * LDS;              // dO
  float* sL = reinterpret_cast<float*>(sO + 2 * NP * BS * LDS);  // [2][BS]
  float* sD = sL + 2 * BS;                        // delta, [2][BS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long kh = blockIdx.y / nsplit;
  const int part = blockIdx.y % nsplit;
  const int heads = a.group / nsplit;
  const long long h0 = kh * a.group + (long long)part * heads;
  const int k0 = blockIdx.x * BK;
  const int c0 = blockIdx.z * DC;
  const int n_qt = (a.sq + BS - 1) / BS;
  // the first q tile with a live row: its last row reaches k0
  const int qt0 = a.causal ? min(k0 / BS, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = per_head * heads;

  load_rows<DP, BK, NP, THREADS>(sK, op.k, op.k_plane, kh, k0, a.sk, op.ld);
  load_rows<DP, BK, NP, THREADS>(sV, op.v, op.k_plane, kh, k0, a.sk, op.ld);
  auto issue = [&](int it) {
    const int st = it & 1;
    const long long h = h0 + it / per_head;
    const int q0 = (qt0 + it % per_head) * BS;
    load_rows<DP, BS, NP, THREADS>(sQ + st * NP * BS * LDS, op.q, op.q_plane,
                                   h, q0, a.sq, op.ld);
    load_rows<DP, BS, NP, THREADS>(sO + st * NP * BS * LDS, op.o, op.q_plane,
                                   h, q0, a.sq, op.ld);
    for (int i = threadIdx.x; i < BS; i += THREADS) {
      const bool ok = q0 + i < a.sq;
      const long long o = h * a.sq + q0 + i;
      cp_async4(sL + st * BS + i, ok ? a.lse_in + o : a.lse_in, ok);
      cp_async4(sD + st * BS + i, ok ? a.delta + o : a.delta, ok);
    }
  };
  if (n_it > 0) issue(0);
  cp_async_commit();

  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + warp * 16 + g + 8 * r;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const bf16* tQ = sQ + st * NP * BS * LDS;
    const bf16* tO = sO + st * NP * BS * LDS;
    const float* tL = sL + st * BS;
    const float* tD = sD + st * BS;
    const int q0 = (qt0 + it % per_head) * BS;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x BS q rows a warp
    float s[BS / 8][4], dp[BS / 8][4];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t ka[NP][4], va[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        frag_a(ka[p], sK + p * BK * LDS, LDS, warp * 16, kk);
        frag_a(va[p], sV + p * BK * LDS, LDS, warp * 16, kk);
      }
#pragma unroll
      for (int j = 0; j < BS / 16; ++j) {
        uint32_t qb[NP][4], ob[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          frag_b_nk(qb[p], tQ + p * BS * LDS, LDS, j * 16, kk);
          frag_b_nk(ob[p], tO + p * BS * LDS, LDS, j * 16, kk);
        }
#pragma unroll
        for (int pa = 0; pa < NP; ++pa)
#pragma unroll
          for (int pb = 0; pb + pa < NP; ++pb) {
            mma_bf16(s[2 * j], ka[pa], qb[pb][0], qb[pb][1]);
            mma_bf16(s[2 * j + 1], ka[pa], qb[pb][2], qb[pb][3]);
            mma_bf16(dp[2 * j], va[pa], ob[pb][0], ob[pb][1]);
            mma_bf16(dp[2 * j + 1], va[pa], ob[pb][2], ob[pb][3]);
          }
      }
    }
    // Pᵀ in place of s, dSᵀ in place of dp
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const int qpos = q0 + qc;
        float sv = s[j][e] * a.scale;
        if (a.causal && qpos < kpos[e >> 1]) sv = kNegInf;
        const float p = qpos < a.sq ? expf(sv - tL[qc]) : 0.0f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - tD[qc]) * a.scale;
      }
    // dV += Pᵀ dO and dK += dSᵀ Q, P and dS split hi/lo
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split2(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split2(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
      split2(dp[2 * j][0], dp[2 * j][1], sh[0], sl[0]);
      split2(dp[2 * j][2], dp[2 * j][3], sh[1], sl[1]);
      split2(dp[2 * j + 1][0], dp[2 * j + 1][1], sh[2], sl[2]);
      split2(dp[2 * j + 1][2], dp[2 * j + 1][3], sh[3], sl[3]);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        uint32_t ob[NP][4], qb[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          frag_b_kn(ob[p], tO + p * BS * LDS, LDS, j * 16, c0 + n * 16);
          frag_b_kn(qb[p], tQ + p * BS * LDS, LDS, j * 16, c0 + n * 16);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(dv[2 * n], ph, ob[p][0], ob[p][1]);
          mma_bf16(dv[2 * n + 1], ph, ob[p][2], ob[p][3]);
          mma_bf16(dk[2 * n], sh, qb[p][0], qb[p][1]);
          mma_bf16(dk[2 * n + 1], sh, qb[p][2], qb[p][3]);
        }
        mma_bf16(dv[2 * n], pl, ob[0][0], ob[0][1]);
        mma_bf16(dv[2 * n + 1], pl, ob[0][2], ob[0][3]);
        mma_bf16(dk[2 * n], sl, qb[0][0], qb[0][1]);
        mma_bf16(dk[2 * n + 1], sl, qb[0][2], qb[0][3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long base = (long long)part * a.hkv * a.sk * a.d;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kpos[e >> 1];
      const int col = c0 + n * 8 + 2 * t + (e & 1);
      if (r < a.sk && col < a.d) {
        const long long o = base + (kh * a.sk + r) * a.d + col;
        out_k[o] = dk[n][e];
        out_v[o] = dv[n][e];
      }
    }
}

// out[i] = sum over z < nsplit of part[z * n + i], in order of z.
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long n,
                                 int nsplit) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < nsplit; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

// rows x d values of type dt -> bf16 planes of rows x width (hi, and lo
// at + plane when np == 2); columns d..width-1 are zero.
__global__ void planes_kernel(const void* __restrict__ src, int dt,
                              bf16* __restrict__ dst, long long rows, int d,
                              int width, long long plane, int np) {
  const long long n = rows * width;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / width;
    const int c = (int)(i - r * width);
    const float x = c < d ? ld(src, r * d + c, dt) : 0.0f;
    const bf16 hi = __float2bfloat16_rn(x);
    dst[i] = hi;
    if (np == 2) dst[plane + i] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
}

unsigned grid_1d(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

template <int DP, int NP, int NW, int BS>
cudaError_t launch(const FlashArgs& a, const Operands& op,
                   const FlashBwdWork& w, cudaStream_t s) {
  constexpr int LDS = DP + 8;
  constexpr int DC = DP < 128 ? DP : 128;
  constexpr int B16 = (int)sizeof(bf16);
  const int smem_dq = (2 * NP * 16 * NW + 4 * NP * BS) * LDS * B16;
  const int smem_dkv =
      (2 * NP * 16 * NW + 4 * NP * BS) * LDS * B16 + 4 * BS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP, NP, NW, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<DP, NP, NW, BS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  const unsigned chunks = (unsigned)((a.d + DC - 1) / DC);
  dq_kernel<DP, NP, NW, BS>
      <<<dim3((a.sq + 16 * NW - 1) / (16 * NW), a.hq, chunks), 32 * NW,
         smem_dq, s>>>(a, op);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* out_k = w.nsplit > 1 ? w.dk_part : a.dk;
  float* out_v = w.nsplit > 1 ? w.dv_part : a.dv;
  dkv_kernel<DP, NP, NW, BS>
      <<<dim3((a.sk + 16 * NW - 1) / (16 * NW), a.hkv * w.nsplit, chunks),
         32 * NW, smem_dkv, s>>>(a, op, out_k, out_v, w.nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.nsplit == 1) return err;
  const long long n = (long long)a.hkv * a.sk * a.d;
  sum_parts_kernel<<<grid_1d(n), 256, 0, s>>>(w.dk_part, a.dk, n, w.nsplit);
  sum_parts_kernel<<<grid_1d(n), 256, 0, s>>>(w.dv_part, a.dv, n, w.nsplit);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_dp(int dp, const FlashArgs& a, const Operands& op,
                      const FlashBwdWork& w, cudaStream_t s) {
  switch (dp) {
    case 32: return launch<32, NP, 4, 32>(a, op, w, s);
    case 64: return launch<64, NP, 4, 32>(a, op, w, s);
    case 128: return launch<128, NP, 4, 32>(a, op, w, s);
    default: return launch<256, NP, 2, 32>(a, op, w, s);
  }
}

}  // namespace

// a: device pointers, shapes and dtype codes in host memory; w: the
// wrapper's scratch and plan.  Splits the inputs into bf16 planes where
// w->planes is set, launches the dQ pass, then the dK/dV pass, then the
// sum of its parts, on `stream`; returns a cudaError_t.
extern "C" int flash_backward(const FlashArgs* a, const FlashBwdWork* w,
                              int device, void* stream) {
  if (a == nullptr || w == nullptr || a->hq <= 0 || a->hkv <= 0 ||
      a->group <= 0 || a->hq != a->group * a->hkv || a->sq < 0 || a->sk < 0)
    return (int)cudaErrorInvalidValue;
  const int dp = flash::padded_dim(a->d);
  if (dp == 0 || a->hq > 65535 || (w->np != 1 && w->np != 2) ||
      w->nsplit < 1 || a->group % w->nsplit != 0 ||
      (long long)a->hkv * w->nsplit > 65535 || w->ld % 8 != 0 ||
      w->ld < a->d || w->ld > dp || (w->nsplit > 1 && !w->dk_part) ||
      (w->nsplit > 1 && !w->dv_part) ||
      (w->planes == nullptr &&
       (w->np != 1 || w->ld != a->d || a->dt_q != flash::kBF16 ||
        a->dt_k != flash::kBF16 || a->dt_v != flash::kBF16 ||
        a->dt_do != flash::kBF16)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->sq == 0 || a->sk == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);

  Operands op;
  op.ld = w->ld;
  if (w->planes == nullptr) {
    op.q = static_cast<const __nv_bfloat16*>(a->q);
    op.k = static_cast<const __nv_bfloat16*>(a->k);
    op.v = static_cast<const __nv_bfloat16*>(a->v);
    op.o = static_cast<const __nv_bfloat16*>(a->dout);
    op.q_plane = op.k_plane = 0;
  } else {
    const long long q_rows = (long long)a->hq * a->sq;
    const long long k_rows = (long long)a->hkv * a->sk;
    op.q_plane = q_rows * w->ld;
    op.k_plane = k_rows * w->ld;
    auto* base = static_cast<__nv_bfloat16*>(w->planes);
    __nv_bfloat16* pq = base;
    __nv_bfloat16* pk = pq + w->np * op.q_plane;
    __nv_bfloat16* pv = pk + w->np * op.k_plane;
    __nv_bfloat16* po = pv + w->np * op.k_plane;
    const struct { const void* src; int dt; __nv_bfloat16* dst;
                   long long rows, plane; } jobs[4] = {
        {a->q, a->dt_q, pq, q_rows, op.q_plane},
        {a->k, a->dt_k, pk, k_rows, op.k_plane},
        {a->v, a->dt_v, pv, k_rows, op.k_plane},
        {a->dout, a->dt_do, po, q_rows, op.q_plane}};
    for (const auto& j : jobs) {
      planes_kernel<<<grid_1d(j.rows * w->ld), 256, 0, s>>>(
          j.src, j.dt, j.dst, j.rows, a->d, w->ld, j.plane, w->np);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    op.q = pq;
    op.k = pk;
    op.v = pv;
    op.o = po;
  }
  return (int)(w->np == 1 ? launch_dp<1>(dp, *a, op, *w, s)
                          : launch_dp<2>(dp, *a, op, *w, s));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
