// Flash attention forward over an int8 K/V cache, on Hopper's tensor
// cores (bf16 mma.sync with float32 accumulation), sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel_q8.py:
// _flash_q8_kernel, reached through flash_attention_q8_nhd (kernel_q8.py:81):
// kernel 4's online-softmax forward (flash_fwd.cu) with K and V stored as
// int8 words and one float32 scale per (kv head, position) vector, the
// per-block format of core/quant_cache.py.  The softmax runs in float32
// (running max, running sum, float32 accumulator), the denominator is
// max(l, 1e-30), out is in q's dtype, q head h reads kv head h / group.
// The causal mask is the TPU kernel's, qpos >= kpos aligned top-left
// (kernel_q8.py:57-60); masked scores are -1e30, whose probability is
// exactly 0.  So a decode query (Sq = 1) sees only key 0 when causal: the
// decode-shape call is causal = false over the filled prefix of the cache.
// Any sq, sk and d <= 256: tail tiles and rows are masked here, where the
// TPU kernel clamps its tiles to divisors of the lengths.  Forward only.
//
// What bounds it on an H100: reading q, the int8 K/V words and their
// scales once and writing out, against 4 operations per live (q, k) pair
// and channel (Q Kᵀ and P V) at the bf16 tensor-core peak.  A decode call
// (sq = 1) does 4 sk d operations per q head for d + 4 bytes per cached
// vector: bytes, by far.  A causal prefill of 4096 tokens is bounded by
// its operations.  The first kernel ran on the CUDA cores in float32,
// with one block per (kv head, 64 rows): 8 blocks at a 4-slot decode,
// each reading all 4096 keys a byte a thread (2.4 ms, 34-57x SDPA).
//
// The design:
//  * Rows: the group of q heads that share a kv head is packed into the
//    rows of one block, so each K/V tile is read once per group: block
//    (x, kv head, split) owns rows i of the kv head's sq * group
//    (q position, q head) pairs, i = qpos * group + g, in m16 tiles.
//  * Keys: a block walks 64-key tiles from split * chunk to the end of
//    its chunk.  Where the rows alone do not give the card four blocks an
//    SM (decode), the wrapper cuts the key axis into nsplit chunks
//    (flash-decoding: 512 blocks at a 4-slot decode over 4096 positions);
//    each block writes its rows' float32 (m, l, acc) to the wrapper's
//    scratch and q8_combine_kernel combines the parts, every sum in a
//    fixed order: out = sum_z acc_z e^(m_z - M) / max(sum_z l_z
//    e^(m_z - M), 1e-30), M = max_z m_z.
//  * Products: S = Q Wₖᵀ is a bf16 mma.sync over exact words (an int8
//    word is exact in bf16), each key's column multiplied by its scale
//    afterwards; a float32 q is split into hi + lo bf16 planes, two
//    products.  P V runs as (p s_v) W_v, the float32 p s_v split hi/lo
//    (2^-17) and multiplied twice; the float32 accumulator of S is the A
//    fragment of P V, through registers.
//  * Prefill (q8_kernel): 4 warps of 16 rows; the words and scales of
//    the next tile are copied by cp.async (16 bytes a copy where
//    d % 16 == 0) into a ring of two int8 stages while the current one
//    is used, and each tile is converted once into shared bf16 tiles for
//    ldmatrix.
//  * Decode (q8_decode_kernel, a kv head's rows fit 16): one warp of
//    rows would chain the whole tile's work and leave each SM scheduler
//    about one warp to issue from, so 4 warps split each tile, 16 keys a
//    warp; they exchange the row max and sum through shared memory (every
//    warp keeps the same m and l) and add their accumulators in order of
//    warp at the end.  The words stay int8 in shared memory and are
//    converted as each fragment is loaded, which keeps a block at 57 KB
//    and four blocks on an SM.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;       // keys a tile
constexpr int kThreadsQ8 = 128;

// The rows and keys a block owns: rows [i0, i0 + R) of the kv head's
// sq * group, keys [kbeg, kend) in n_tiles tiles.
struct Span {
  int rows, i0, kbeg, kend, n_tiles;
};

__device__ __forceinline__ Span span(const FlashArgs& a, int R, int chunk) {
  Span sp;
  sp.rows = a.sq * a.group;                // < 2^31, checked by the host
  sp.i0 = blockIdx.x * R;
  const int q_last = (min(sp.i0 + R, sp.rows) - 1) / a.group;
  sp.kbeg = blockIdx.z * chunk;
  sp.kend = min(a.sk, sp.kbeg + chunk);
  if (a.causal) sp.kend = min(sp.kend, q_last + 1);
  sp.n_tiles = sp.kend > sp.kbeg ? (sp.kend - sp.kbeg + KT - 1) / KT : 0;
  return sp;
}

// Rows [i0, i0 + R) into sQ [NP][R][DP + 8]: a bf16 q with 16-byte rows
// copied as it is (cp.async), any other split into NP bf16 planes.
template <int DP, int NP, int R>
__device__ __forceinline__ void load_q(bf16* sQ, const FlashArgs& a,
                                       long long kh, const Span& sp,
                                       int qvec) {
  constexpr int LDS = DP + 8;
  if (NP == 1 && qvec) {
    const bf16* qb = static_cast<const bf16*>(a.q);
    for (int idx = threadIdx.x; idx < R * (DP / 8); idx += kThreadsQ8) {
      const int rr = idx / (DP / 8), c = idx - rr * (DP / 8);
      const int ii = sp.i0 + rr;
      const bool ok = ii < sp.rows && c * 8 < a.d;
      const long long h = kh * a.group + ii % a.group;
      cp_async16(sQ + rr * LDS + c * 8,
                 ok ? qb + (h * a.sq + ii / a.group) * a.d + c * 8 : qb, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreadsQ8) {
    const int rr = idx / DP, c = idx - rr * DP;
    const int ii = sp.i0 + rr;
    float x = 0.0f;
    if (ii < sp.rows && c < a.d) {
      const long long h = kh * a.group + ii % a.group;
      x = ld(a.q, (h * a.sq + ii / a.group) * a.d + c, a.dt_q);
    }
    const bf16 hi = __float2bfloat16_rn(x);
    sQ[rr * LDS + c] = hi;
    if (NP == 2)
      sQ[R * LDS + rr * LDS + c] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
}

// The words of keys [t0, t0 + KT) (zero past kend) into sW [k|v][KT][DP +
// 16], 16 bytes a copy where `vec`, and their scales into sS [k|v][KT].
template <int DP>
__device__ __forceinline__ void load_words(int8_t* sW, float* sS,
                                           const FlashArgs& a,
                                           const float* k_scale,
                                           const float* v_scale,
                                           long long kh, int t0, int kend,
                                           int vec) {
  constexpr int LDW = DP + 16;
  const int8_t* kw = static_cast<const int8_t*>(a.k);
  const int8_t* vw = static_cast<const int8_t*>(a.v);
  if (vec) {
    constexpr int CH = DP / 16;
    for (int idx = threadIdx.x; idx < 2 * KT * CH; idx += kThreadsQ8) {
      const int which = idx / (KT * CH);
      const int rem = idx - which * KT * CH;
      const int r = rem / CH, c = rem - (rem / CH) * CH;
      const int pos = t0 + r;
      const bool ok = pos < kend && c * 16 < a.d;
      const int8_t* src = which ? vw : kw;
      cp_async16(sW + which * KT * LDW + r * LDW + c * 16,
                 ok ? src + (kh * a.sk + pos) * a.d + c * 16 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * KT * DP; idx += kThreadsQ8) {
      const int which = idx / (KT * DP);
      const int rem = idx - which * KT * DP;
      const int r = rem / DP, c = rem - (rem / DP) * DP;
      const int pos = t0 + r;
      const int8_t* src = which ? vw : kw;
      sW[which * KT * LDW + r * LDW + c] =
          pos < kend && c < a.d ? src[(kh * a.sk + pos) * a.d + c] : 0;
    }
  }
  for (int idx = threadIdx.x; idx < 2 * KT; idx += kThreadsQ8) {
    const int which = idx / KT, r = idx - which * KT;
    const int pos = t0 + r;
    const bool ok = pos < kend;
    const float* src = which ? v_scale : k_scale;
    cp_async4(sS + which * KT + r, ok ? src + kh * a.sk + pos : src, ok);
  }
}

// Two int8 words as a bf16 pair (exact), the first in the low half.
__device__ __forceinline__ uint32_t i8x2(int8_t lo, int8_t hi) {
  return bf16x2_bits(__floats2bfloat162_rn((float)lo, (float)hi));
}

// frag_b_nk and frag_b_kn (flash_common.cuh) read from int8 words: two n8
// tiles at n0, depth k0..k0+15, the words stored [n][k] or [k][n].
__device__ __forceinline__ void frag_b_nk_i8(uint32_t (&b)[4],
                                             const int8_t* w, int ld, int n0,
                                             int k0) {
  const int l = threadIdx.x & 31;
  const int8_t* r = w + (n0 + (l >> 2)) * ld + k0 + (l & 3) * 2;
  b[0] = i8x2(r[0], r[1]);
  b[1] = i8x2(r[8], r[9]);
  b[2] = i8x2(r[8 * ld], r[8 * ld + 1]);
  b[3] = i8x2(r[8 * ld + 8], r[8 * ld + 9]);
}

__device__ __forceinline__ void frag_b_kn_i8(uint32_t (&b)[4],
                                             const int8_t* w, int ld, int k0,
                                             int n0) {
  const int l = threadIdx.x & 31;
  const int8_t* c = w + (k0 + (l & 3) * 2) * ld + n0 + (l >> 2);
  b[0] = i8x2(c[0], c[ld]);
  b[1] = i8x2(c[8 * ld], c[9 * ld]);
  b[2] = i8x2(c[8], c[ld + 8]);
  b[3] = i8x2(c[8 * ld + 8], c[9 * ld + 8]);
}

// Row i's result: out in q's dtype when the key axis is whole, else its
// float32 part (acc, and (m, l) once a row) for q8_combine_kernel.  part:
// (nsplit, hkv, rows, d) accumulators, then (nsplit, hkv, rows, 2).
struct Sink {
  float* pacc;   // this block's (split, kv head) slab, or null
  float* pml;
};

__device__ __forceinline__ Sink sink(const FlashArgs& a, float* part,
                                     int nsplit, long long kh, int rows) {
  if (nsplit == 1) return {nullptr, nullptr};
  const long long slot = ((long long)blockIdx.z * a.hkv + kh) * rows;
  return {part + slot * a.d,
          part + (long long)nsplit * a.hkv * rows * a.d + slot * 2};
}

__device__ __forceinline__ void put(const FlashArgs& a, const Sink& sk,
                                    long long kh, int i, int col, float acc,
                                    float l) {
  if (sk.pacc) {
    sk.pacc[(long long)i * a.d + col] = acc;
    return;
  }
  const long long qh = kh * a.group + i % a.group;
  st(a.out, (qh * a.sq + i / a.group) * a.d + col, a.dt_out,
     acc / fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------
// Prefill: 4 warps of 16 rows a block, the 64-key tiles through a ring of
// two int8 stages, each tile converted once into shared bf16 tiles.
// ---------------------------------------------------------------------

template <int DP, int NP>
struct PrefillSmem {
  static constexpr int R = 64, LDS = DP + 8, LDW = DP + 16;
  static constexpr int q_bytes = NP * R * LDS * 2;
  static constexpr int w_bytes = 2 * 2 * KT * LDW;   // [stage][k|v]
  static constexpr int t_bytes = 2 * KT * LDS * 2;   // bf16 K, V
  static constexpr int s_bytes = 2 * 2 * KT * 4;     // scales
  static constexpr int total = q_bytes + w_bytes + t_bytes + s_bytes;
};

template <int DP, int NP>
__global__ void __launch_bounds__(kThreadsQ8)
    q8_kernel(FlashArgs a, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, float* part, int chunk,
              int nsplit, int vec, int qvec) {
  using L = PrefillSmem<DP, NP>;
  constexpr int R = L::R, LDS = L::LDS, LDW = L::LDW, NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);               // [NP][R][LDS]
  int8_t* sW = reinterpret_cast<int8_t*>(smem_raw + L::q_bytes);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + L::q_bytes + L::w_bytes);
  bf16* sV = sK + KT * LDS;
  float* sS = reinterpret_cast<float*>(smem_raw + L::q_bytes + L::w_bytes +
                                       L::t_bytes);           // [stage][k|v][KT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long kh = blockIdx.y;
  const Span sp = span(a, R, chunk);

  load_q<DP, NP, R>(sQ, a, kh, sp, qvec);
  auto issue = [&](int it) {
    load_words<DP>(sW + (it & 1) * 2 * KT * LDW, sS + (it & 1) * 2 * KT, a,
                   k_scale, v_scale, kh, sp.kbeg + it * KT, sp.kend, vec);
  };
  if (sp.n_tiles > 0) issue(0);
  cp_async_commit();

  int row[2], qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = sp.i0 + warp * 16 + g + 8 * r;
    qpos[r] = row[r] < sp.rows ? row[r] / a.group : a.sq;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < sp.n_tiles; ++it) {
    if (it + 1 < sp.n_tiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const int t0 = sp.kbeg + it * KT;
    // the tile's words to bf16, 16 a thread
    for (int idx = threadIdx.x; idx < 2 * KT * (DP / 16); idx += kThreadsQ8) {
      const int which = idx / (KT * (DP / 16));
      const int rem = idx - which * KT * (DP / 16);
      const int r = rem / (DP / 16), c = rem - (rem / (DP / 16)) * (DP / 16);
      const int4 w = *reinterpret_cast<const int4*>(
          sW + (st * 2 + which) * KT * LDW + r * LDW + c * 16);
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = i8x2(b[2 * e], b[2 * e + 1]);
      uint4* dst = reinterpret_cast<uint4*>((which ? sV : sK) + r * LDS +
                                            c * 16);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();
    const float* ksc = sS + st * 2 * KT;
    const float* vsc = ksc + KT;

    // S = Q Wₖᵀ: 16 rows x 64 keys a warp
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t qa[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        frag_a(qa[p], sQ + p * R * LDS, LDS, warp * 16, kk);
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        uint32_t kb[4];
        frag_b_nk(kb, sK, LDS, j * 16, kk);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(s[2 * j], qa[p], kb[0], kb[1]);
          mma_bf16(s[2 * j + 1], qa[p], kb[2], kb[3]);
        }
      }
    }
    // scale, mask and the online softmax; rows g (e < 2) and g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);
        const int kpos = t0 + kc;
        const int r = e >> 1;
        const bool live = kpos < sp.kend && !(a.causal && qpos[r] < kpos);
        const float sv = live ? s[j][e] * ksc[kc] * a.scale : kNegInf;
        s[j][e] = sv;
        if (live) mx[r] = fmaxf(mx[r], sv);
      }
    float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[j][e] == kNegInf ? 0.0f : expf(s[j][e] - mx[r]);
        psum[r] += p;
        s[j][e] = p * vsc[8 * j + 2 * t + (e & 1)];   // p s_v
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    // O += (p s_v) W_v, p s_v split hi/lo
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      uint32_t ph[4], pl[4];
      split2(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split2(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        uint32_t vb[4];
        frag_b_kn(vb, sV, LDS, j * 16, n * 16);
        mma_bf16(acc[2 * n], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * n + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * n], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * n + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const Sink sk = sink(a, part, nsplit, kh, sp.rows);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = n * 8 + 2 * t + (e & 1);
      if (row[r] < sp.rows && col < a.d)
        put(a, sk, kh, row[r], col, acc[n][e], l[r]);
    }
  if (sk.pml && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < sp.rows) {
        sk.pml[(long long)row[r] * 2] = m[r];
        sk.pml[(long long)row[r] * 2 + 1] = l[r];
      }
  }
}

// ---------------------------------------------------------------------
// Decode: the kv head's rows fit one m16 tile (16 rows); 4 warps split
// each 64-key tile, 16 keys a warp, so that a block's work is spread over
// four warps and not chained in one.  The words stay int8 in shared
// memory and are converted to bf16 as each fragment is loaded.  The
// warps share the row max and sum through shared memory (the same m and
// l in every warp) and add their accumulators, in order of warp, at the
// end.
// ---------------------------------------------------------------------

template <int DP, int NP>
struct DecodeSmem {
  static constexpr int R = 16, LDS = DP + 8, LDW = DP + 16;
  static constexpr int q_bytes = NP * R * LDS * 2;
  static constexpr int w_bytes = 2 * KT * LDW;        // k|v, one stage
  static constexpr int s_bytes = 2 * KT * 4;          // scales
  static constexpr int r_bytes = 2 * 4 * R * 4;       // row max, row sum
  static constexpr int a_bytes = 4 * R * DP * 4;      // the warps' acc
  static constexpr int total = q_bytes + w_bytes + s_bytes + r_bytes +
                               a_bytes;
};

template <int DP, int NP>
__global__ void __launch_bounds__(kThreadsQ8)
    q8_decode_kernel(FlashArgs a, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, float* part,
                     int chunk, int nsplit, int vec, int qvec) {
  using L = DecodeSmem<DP, NP>;
  constexpr int R = L::R, LDS = L::LDS, LDW = L::LDW, NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);               // [NP][R][LDS]
  int8_t* sW = reinterpret_cast<int8_t*>(smem_raw + L::q_bytes);
  float* sS = reinterpret_cast<float*>(smem_raw + L::q_bytes + L::w_bytes);
  float* sMax = sS + 2 * KT;                                  // [warp][R]
  float* sSum = sMax + 4 * R;
  float* sAcc = sSum + 4 * R;                                 // [warp][R][DP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long kh = blockIdx.y;
  const Span sp = span(a, R, chunk);
  const int k0 = warp * 16;                 // the warp's keys in a tile

  load_q<DP, NP, R>(sQ, a, kh, sp, qvec);
  if (sp.n_tiles > 0)
    load_words<DP>(sW, sS, a, k_scale, v_scale, kh, sp.kbeg, sp.kend, vec);
  cp_async_commit();

  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = sp.i0 + g + 8 * r;
    qpos[r] = i < sp.rows ? i / a.group : a.sq;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < sp.n_tiles; ++it) {
    const int t0 = sp.kbeg + it * KT;
    if (it > 0) {              // the stage was freed by the last barrier
      load_words<DP>(sW, sS, a, k_scale, v_scale, kh, t0, sp.kend, vec);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int8_t* wK = sW;
    const int8_t* wV = sW + KT * LDW;

    // S = Q Wₖᵀ for the warp's 16 keys
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t kb[4];
      frag_b_nk_i8(kb, wK, LDW, k0, kk);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t qa[4];
        frag_a(qa, sQ + p * R * LDS, LDS, 0, kk);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + 8 * j + 2 * t + (e & 1);
        const int kpos = t0 + kc;
        const int r = e >> 1;
        const bool live = kpos < sp.kend && !(a.causal && qpos[r] < kpos);
        const float sv = live ? s[j][e] * sS[kc] * a.scale : kNegInf;
        s[j][e] = sv;
        if (live) mx[r] = fmaxf(mx[r], sv);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) sMax[warp * R + g + 8 * r] = mx[r];
    }
    __syncthreads();
    float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mn = m[r];
#pragma unroll
      for (int w = 0; w < 4; ++w) mn = fmaxf(mn, sMax[w * R + g + 8 * r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[j][e] == kNegInf ? 0.0f : expf(s[j][e] - m[r]);
        psum[r] += p;
        s[j][e] = p * sS[KT + k0 + 8 * j + 2 * t + (e & 1)];   // p s_v
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      if (t == 0) sSum[warp * R + g + 8 * r] = psum[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    // O += (p s_v) W_v over the warp's 16 keys, p s_v split hi/lo
    uint32_t ph[4], pl[4];
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t vb[4];
      frag_b_kn_i8(vb, wV, LDW, k0, n * 16);
      mma_bf16(acc[2 * n], ph, vb[0], vb[1]);
      mma_bf16(acc[2 * n + 1], ph, vb[2], vb[3]);
      mma_bf16(acc[2 * n], pl, vb[0], vb[1]);
      mma_bf16(acc[2 * n + 1], pl, vb[2], vb[3]);
    }
    __syncthreads();           // sSum written; the stage is free
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += sSum[w * R + g + 8 * r];
      l[r] = l[r] * alpha[r] + sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();             // every warp has read the last row sums

  // the four warps' accumulators, added in order of warp
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sAcc[(warp * R + g + 8 * (e >> 1)) * DP + n * 8 + 2 * t + (e & 1)] =
          acc[n][e];
  if (warp == 0 && t == 0) {   // every warp holds the same m and l
    sMax[g] = m[0];
    sMax[g + 8] = m[1];
    sSum[g] = l[0];
    sSum[g + 8] = l[1];
  }
  __syncthreads();
  const Sink sk = sink(a, part, nsplit, kh, sp.rows);
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreadsQ8) {
    const int r = idx / DP, col = idx - r * DP;
    const int i = sp.i0 + r;
    if (i >= sp.rows || col >= a.d) continue;
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) x += sAcc[(w * R + r) * DP + col];
    put(a, sk, kh, i, col, x, sSum[r]);
  }
  if (sk.pml && threadIdx.x < R && sp.i0 + (int)threadIdx.x < sp.rows) {
    const long long i = sp.i0 + threadIdx.x;
    sk.pml[i * 2] = sMax[threadIdx.x];
    sk.pml[i * 2 + 1] = sSum[threadIdx.x];
  }
}

// One block per (row, kv head): the nsplit parts combined.  Warp 0 finds
// M, each part's weight e^(m_z - M) and L; then 4 groups of 128 threads
// each sum a quarter of the parts for 128 columns, and the groups' sums
// are added in order of group (deterministic).
constexpr int kCombineCols = 128, kCombineGroups = 4;

__global__ void __launch_bounds__(kCombineCols * kCombineGroups)
    q8_combine_kernel(FlashArgs a, const float* __restrict__ part,
                      int nsplit) {
  extern __shared__ float wz[];   // [nsplit] weights, L, then [groups][cols]
  float* red = wz + nsplit + 1;
  const long long rows = (long long)a.sq * a.group;
  const long long i = blockIdx.x;
  const long long kh = blockIdx.y;
  const float* pml = part + (long long)nsplit * a.hkv * rows * a.d;
  const long long stride = a.hkv * rows;     // between parts, in slots
  const long long slot0 = kh * rows + i;
  if (threadIdx.x < 32) {
    float mmax = kNegInf, lsum = 0.0f;
    for (int z = threadIdx.x; z < nsplit; z += 32)
      mmax = fmaxf(mmax, pml[(z * stride + slot0) * 2]);
    for (int o = 16; o > 0; o >>= 1)
      mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, o));
    for (int z = threadIdx.x; z < nsplit; z += 32) {
      const float w = expf(pml[(z * stride + slot0) * 2] - mmax);
      wz[z] = w;
      lsum += pml[(z * stride + slot0) * 2 + 1] * w;
    }
    for (int o = 16; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (threadIdx.x == 0) wz[nsplit] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const float denom = wz[nsplit];
  const int grp = threadIdx.x / kCombineCols;
  const int lc = threadIdx.x - grp * kCombineCols;
  const long long qh = kh * a.group + i % a.group;
  const long long out = (qh * a.sq + i / a.group) * a.d;
  for (int c0 = 0; c0 < a.d; c0 += kCombineCols) {
    const int c = c0 + lc;
    float x = 0.0f;
    if (c < a.d)
      for (int z = grp; z < nsplit; z += kCombineGroups)
        x += part[(z * stride + slot0) * a.d + c] * wz[z];
    red[grp * kCombineCols + lc] = x;
    __syncthreads();
    if (grp == 0 && c < a.d) {
      float y = red[lc];
#pragma unroll
      for (int q = 1; q < kCombineGroups; ++q) y += red[q * kCombineCols + lc];
      st(a.out, out + c, a.dt_out, y / denom);
    }
    __syncthreads();
  }
}

template <int DP, int NP>
cudaError_t launch(const FlashArgs& a, const float* ks, const float* vs,
                   float* part, int decode, int chunk, int nsplit,
                   cudaStream_t s) {
  const int vec = a.d % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const int qvec = a.dt_q == kBF16 && a.d % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(a.q) % 16 == 0;
  const long long rows = (long long)a.sq * a.group;
  cudaError_t err;
  if (decode) {
    constexpr int smem = DecodeSmem<DP, NP>::total;
    err = cudaFuncSetAttribute(q8_decode_kernel<DP, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((rows + 15) / 16), a.hkv, nsplit);
    q8_decode_kernel<DP, NP><<<grid, kThreadsQ8, smem, s>>>(
        a, ks, vs, part, chunk, nsplit, vec, qvec);
  } else {
    constexpr int smem = PrefillSmem<DP, NP>::total;
    err = cudaFuncSetAttribute(q8_kernel<DP, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((rows + 63) / 64), a.hkv, nsplit);
    q8_kernel<DP, NP><<<grid, kThreadsQ8, smem, s>>>(a, ks, vs, part, chunk,
                                                     nsplit, vec, qvec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int smem_c =
      (nsplit + 1 + kCombineGroups * kCombineCols) * (int)sizeof(float);
  q8_combine_kernel<<<dim3((unsigned)rows, a.hkv),
                      kCombineCols * kCombineGroups, smem_c, s>>>(a, part,
                                                                  nsplit);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_dp(int dp, const FlashArgs& a, const float* ks,
                      const float* vs, float* part, int decode, int chunk,
                      int nsplit, cudaStream_t s) {
  switch (dp) {
    case 32: return launch<32, NP>(a, ks, vs, part, decode, chunk, nsplit, s);
    case 64: return launch<64, NP>(a, ks, vs, part, decode, chunk, nsplit, s);
    case 128:
      return launch<128, NP>(a, ks, vs, part, decode, chunk, nsplit, s);
    default:
      return launch<256, NP>(a, ks, vs, part, decode, chunk, nsplit, s);
  }
}

}  // namespace

// a: device pointers, shapes and dtype codes in host memory (k, v int8);
// k_scale, v_scale: device pointers to (hkv, sk) float32; the plan from
// the wrapper: `decode` (the kv head's sq * group rows fit 16: the decode
// kernel) or not (64 rows a block), the key axis cut into nsplit chunks
// of `chunk` keys (a multiple of 64), part the wrapper's float32 scratch
// when nsplit > 1.  Launches on `stream`; returns a cudaError_t.
extern "C" int flash_forward_q8(const FlashArgs* a, const float* k_scale,
                                const float* v_scale, float* part, int decode,
                                int chunk, int nsplit, int device,
                                void* stream) {
  if (a == nullptr || k_scale == nullptr || v_scale == nullptr ||
      a->hq <= 0 || a->hkv <= 0 || a->group <= 0 ||
      a->hq != a->group * a->hkv || a->sq < 0 || a->sk < 0 ||
      a->dt_k != flash::kI8 || a->dt_v != flash::kI8 ||
      a->dt_q == flash::kI8 || a->dt_out != a->dt_q)
    return (int)cudaErrorInvalidValue;
  const int dp = flash::padded_dim(a->d);
  const long long rows = (long long)a->sq * a->group;
  if (dp == 0 || a->hkv > 65535 || (decode != 0 && decode != 1) ||
      (decode && rows > 16) || nsplit < 1 || nsplit > 65535 || chunk < 1 ||
      chunk % KT != 0 || (long long)chunk * nsplit < a->sk ||
      rows > 2147483647LL || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->sq == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(a->dt_q != flash::kBF16
                   ? launch_dp<2>(dp, *a, k_scale, v_scale, part, decode,
                                  chunk, nsplit, s)
                   : launch_dp<1>(dp, *a, k_scale, v_scale, part, decode,
                                  chunk, nsplit, s));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
