// RWKV6 wkv backward: the reverse-time adjoint sweep, sm_90a.
//
// Replaces the TPU kernel repro/kernels/wkv/kernel_bwd.py:
// _wkv_bwd_kernel, reached through wkv_recurrence_bwd (kernel_bwd.py:96).
// Forward per token, state S (dk, dv) before token t:
//   y_t = r_t (S_t + diag(u) k_t v_tᵀ),  S_{t+1} = diag(w_t) S_t + k_t v_tᵀ.
// Backward, time reversed, with the state adjoint A = dL/dS_{t+1}
// (zero after the last token):
//   dr_t = S_t dy_t + u ⊙ k_t (v_t·dy_t)
//   dk_t = r_t ⊙ u (v_t·dy_t) + A v_t
//   dv_t = (Σ_i r_i u_i k_i) dy_t + Aᵀ k_t
//   dw_t = rowsum(A ⊙ S_t)
//   du  += r_t ⊙ k_t (v_t·dy_t)
//   A   <- diag(w_t) A + r_t dy_tᵀ
// The states S_t are recomputed block by block from the checkpoints the
// forward (wkv.cu) wrote at the start of every block of block_t steps,
// with the forward's own fmaf update, so they equal the forward's bit for
// bit.  All outputs are float32; the sums run in another order than the
// reference's.
//
// What bounds it on an H100: per state element and step about 10 float32
// operations (recompute k v and the state's multiply-add; S dy and
// A ⊙ S for dr and dw; A v and Aᵀ k for dk and dv; the adjoint's
// multiply-add), at 67 TFLOP/s, against reading r, k, v, w, dy and the
// checkpoints and writing dr, dk, dv, dw once; at rwkv6-3b's shapes the
// operations bound it.  The time loop is sequential, so rows are the
// only parallelism: one block per (batch * head) row.
// The design: one thread per state row i keeps S_t[i, :] and A[i, :] in
// registers, so dr, dk, dw and du are sums local to the thread; only dv
// needs a sum over rows, through a shared (d, d + 1) tile.  A block's
// recomputed states (block_t x dk x dv floats per row: 1 MB at 64, 64,
// 64, past shared memory) go to a scratch buffer the wrapper allocates,
// stored transposed so that the threads' loads of a state column are
// coalesced.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Mirror of WkvBwdArgs in kernels/wkv/kernel.py, field for field.
struct WkvBwdArgs {
  const void* r;          // (rows, T, dk)
  const void* k;          // (rows, T, dk)
  const void* v;          // (rows, T, dv)
  const void* w;          // (rows, T, dk)
  const void* u;          // (rows, dk)
  const void* dy;         // (rows, T, dv)
  const float* ckpt;      // (rows, T / block_t, dk, dv)
  float* scratch;         // (rows, block_t, dv, dk)
  float* dr;              // (rows, T, dk) float32
  float* dk;
  float* dv;              // (rows, T, dv)
  float* dw;              // (rows, T, dk)
  float* du;              // (rows, dk)
  long long t_len;
  long long block_t;      // divides t_len
  int rows;
  int dt_r, dt_k, dt_v, dt_w, dt_u, dt_dy;
};

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float ld(const void* p, long long i, int dt) {
  if (dt == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <int D>
__global__ void __launch_bounds__(D) wkv_bwd_kernel(const WkvBwdArgs a) {
  __shared__ float s_v[D], s_dy[D], s_rku[D];
  __shared__ float s_red[D][D + 1];   // A[i][j] k_i, summed over i for dv
  const int i = threadIdx.x;
  const long long row = blockIdx.x;
  const long long bt = a.block_t;
  const long long nt = a.t_len / bt;
  const long long base = row * a.t_len * D;
  float* scr = a.scratch + row * bt * D * D;
  const float u_i = ld(a.u, row * D + i, a.dt_u);

  float A[D];
#pragma unroll
  for (int j = 0; j < D; ++j) A[j] = 0.0f;
  float du = 0.0f;

  for (long long blk = nt - 1; blk >= 0; --blk) {
    const long long t0 = blk * bt;
    // Recompute the block's states, S_t before each of its tokens.
    float S[D];
    const float* c = a.ckpt + ((row * nt + blk) * D + i) * D;
#pragma unroll
    for (int j = 0; j < D; ++j) S[j] = c[j];
    for (long long tt = 0; tt < bt; ++tt) {
#pragma unroll
      for (int j = 0; j < D; ++j) scr[(tt * D + j) * D + i] = S[j];
      if (tt == bt - 1) break;
      const long long o = base + (t0 + tt) * D + i;
      __syncthreads();
      s_v[i] = ld(a.v, o, a.dt_v);
      __syncthreads();
      const float k_i = ld(a.k, o, a.dt_k), w_i = ld(a.w, o, a.dt_w);
#pragma unroll
      for (int j = 0; j < D; ++j) S[j] = fmaf(w_i, S[j], __fmul_rn(k_i, s_v[j]));
    }
    __syncthreads();  // the block's states are in the scratch

    for (long long tt = bt - 1; tt >= 0; --tt) {
      const long long o = base + (t0 + tt) * D + i;
      const float r_i = ld(a.r, o, a.dt_r), k_i = ld(a.k, o, a.dt_k);
      const float w_i = ld(a.w, o, a.dt_w);
      __syncthreads();  // the last step's reads of the staging are done
      s_v[i] = ld(a.v, o, a.dt_v);
      s_dy[i] = ld(a.dy, o, a.dt_dy);
      s_rku[i] = __fmul_rn(__fmul_rn(r_i, u_i), k_i);
      __syncthreads();
      float vdy = 0.0f, rku = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        vdy = fmaf(s_v[j], s_dy[j], vdy);
        rku += s_rku[j];
      }
      float sdy = 0.0f, av = 0.0f, as = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float s_ij = scr[(tt * D + j) * D + i];
        sdy = fmaf(s_ij, s_dy[j], sdy);
        av = fmaf(A[j], s_v[j], av);
        as = fmaf(A[j], s_ij, as);
        s_red[i][j] = __fmul_rn(A[j], k_i);
      }
      a.dr[o] = fmaf(__fmul_rn(u_i, k_i), vdy, sdy);
      a.dk[o] = fmaf(__fmul_rn(r_i, u_i), vdy, av);
      a.dw[o] = as;
      du = fmaf(__fmul_rn(r_i, k_i), vdy, du);
      __syncthreads();
      float akv = 0.0f;       // thread i as value column j = i
#pragma unroll
      for (int ii = 0; ii < D; ++ii) akv += s_red[ii][i];
      a.dv[o] = fmaf(rku, s_dy[i], akv);
#pragma unroll
      for (int j = 0; j < D; ++j) A[j] = fmaf(w_i, A[j], __fmul_rn(r_i, s_dy[j]));
    }
  }
  a.du[row * D + i] = du;
}

template <int D>
cudaError_t launch(const WkvBwdArgs& a, cudaStream_t s) {
  wkv_bwd_kernel<D><<<a.rows, D, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// a: the tensors' device pointers, shapes and dtype codes in host memory.
// dk == dv in {8, 16, 32, 64}; block_t divides t_len.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int wkv_backward(const WkvBwdArgs* a, int dk, int dv, int device,
                            void* stream) {
  if (a == nullptr || a->rows < 0 || a->t_len < 0 || dk != dv ||
      a->block_t <= 0 || a->t_len % a->block_t)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->rows == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 8: return (int)launch<8>(*a, s);
    case 16: return (int)launch<16>(*a, s);
    case 32: return (int)launch<32>(*a, s);
    case 64: return (int)launch<64>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
