// RWKV6 wkv recurrence, float and int8-state forms, sm_90a.
//
// Replaces the TPU kernels repro/kernels/wkv/kernel.py: _wkv_kernel
// (reached through wkv_recurrence, kernel.py:66) and
// repro/kernels/wkv/kernel_q8.py: _wkv_q8_kernel (wkv_recurrence_q8,
// kernel_q8.py:69).  Per (batch * head) row, with a (dk, dv) state S:
//
//   kv    = k_t v_tᵀ                       (each product rounded once)
//   y_t   = (r_t ⊙ u) · kv + r_t · S
//   S     <- fma(w_t, S, kv)               (one rounding, per element)
//
// S starts at zero, or (q8) at the int8 state times its per-row float32
// scale; the q8 form requantizes the final state in the kernel:
// sc = max_j |S_ij| * (1/127), q = clip(rint(S / max(sc, 1e-30)), +-127).
// The float form can also write the state at the start of every block of
// block_t steps, the checkpoints (rows, T / block_t, dk, dv) from which
// the backward (wkv_bwd.cu) recomputes the states of each block, as the
// TPU kernel does under return_residuals.
// Bit-exact against kernels/wkv/ref.py on S, and so on the int8 words and
// scales; y is a sum in another order.  The reference's compiler contracts
// w * S + kv into one fused multiply-add; this kernel's fmaf rounds once
// as that does, and the plain version spells the same single rounding
// out in float64 (libm.fma_exact).
//
// What bounds it on an H100: the state never leaves the chip, so a step
// reads r, k, w (dk values), v (dv) and writes y (dv); the work is 5
// float32 operations per state element and step (k v, the state's
// multiply-add, r S into y), the bonus being one dk-long dot per row and
// step, v_j sum_i r_i u_i k_i.  At the served shapes (160 rows of 64 x
// 64, 16 steps) that is ~1 us of either, so launch latency dominates; on
// long prompts the sequential time loop does.
// The design: one block per row, one thread per value column j holding
// column S[:, j] in registers (dk floats), the step's r, k, w and r ⊙ u
// staged in shared memory.  The TPU grid's sequential time axis becomes a
// loop over all of T inside the block, so T needs no tiling.  The q8
// requantization stages S through shared memory so that one thread per
// row takes the row's absolute maximum.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Mirror of WkvArgs in kernels/wkv/kernel.py, field for field.
struct WkvArgs {
  const void* r;          // (rows, T, dk)
  const void* k;          // (rows, T, dk)
  const void* v;          // (rows, T, dv)
  const void* w;          // (rows, T, dk)
  const void* u;          // (rows, dk)
  void* out;              // (rows, T, dv)
  const int8_t* s0;       // q8: (rows, dk, dv) int8 state in
  const float* s0_scale;  // q8: (rows, dk)
  int8_t* s_q;            // q8: (rows, dk, dv) int8 state out
  float* s_scale;         // q8: (rows, dk)
  float* ckpt;            // float form: (rows, T / block_t, dk, dv) or null
  long long t_len;
  long long block_t;      // divides t_len; read when ckpt is set
  int rows;
  int dt_r, dt_k, dt_v, dt_w, dt_u, dt_out;
  float inv127;           // float32(1/127), from the host
};

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

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

template <int DK, int DV, bool Q8>
__global__ void __launch_bounds__(DV) wkv_kernel(const WkvArgs a) {
  __shared__ float s_r[DK], s_k[DK], s_w[DK], s_ru[DK], s_u[DK];
  __shared__ float s_rows[Q8 ? DK : 1][Q8 ? DV + 1 : 1];
  __shared__ float s_sc[Q8 ? DK : 1];
  const int j = threadIdx.x;
  const long long row = blockIdx.x;
  const long long kbase = row * a.t_len * DK;
  const long long vbase = row * a.t_len * DV;

  for (int i = j; i < DK; i += DV) s_u[i] = ld(a.u, row * DK + i, a.dt_u);
  float S[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) {
    if constexpr (Q8)
      S[i] = __fmul_rn((float)a.s0[(row * DK + i) * DV + j],
                       a.s0_scale[row * DK + i]);
    else
      S[i] = 0.0f;
  }

  for (long long t = 0; t < a.t_len; ++t) {
    if (!Q8 && a.ckpt != nullptr && t % a.block_t == 0) {
      float* c = a.ckpt + (row * (a.t_len / a.block_t) + t / a.block_t) *
                              (long long)(DK * DV);
#pragma unroll
      for (int i = 0; i < DK; ++i) c[i * DV + j] = S[i];
    }
    __syncthreads();  // the last step's reads of the staging are done
    for (int i = j; i < DK; i += DV) {
      const long long o = kbase + t * DK + i;
      const float r = ld(a.r, o, a.dt_r);
      s_r[i] = r;
      s_k[i] = ld(a.k, o, a.dt_k);
      s_w[i] = ld(a.w, o, a.dt_w);
      s_ru[i] = __fmul_rn(r, s_u[i]);
    }
    __syncthreads();
    const float vj = ld(a.v, vbase + t * DV + j, a.dt_v);
    float y_bonus = 0.0f, y_state = 0.0f;
#pragma unroll
    for (int i = 0; i < DK; ++i) {
      const float kv = __fmul_rn(s_k[i], vj);
      y_bonus = fmaf(s_ru[i], kv, y_bonus);
      y_state = fmaf(s_r[i], S[i], y_state);
      S[i] = fmaf(s_w[i], S[i], kv);
    }
    st(a.out, vbase + t * DV + j, a.dt_out, __fadd_rn(y_bonus, y_state));
  }

  if constexpr (Q8) {
#pragma unroll
    for (int i = 0; i < DK; ++i) s_rows[i][j] = S[i];
    __syncthreads();
    for (int i = j; i < DK; i += DV) {
      float m = 0.0f;
      for (int c = 0; c < DV; ++c) {
        const float x = fabsf(s_rows[i][c]);
        m = (x > m || x != x) && m == m ? x : m;  // NaN propagates
      }
      const float sc = __fmul_rn(m, a.inv127);
      s_sc[i] = sc;
      a.s_scale[row * DK + i] = sc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DK; ++i) {
      const float q = rintf(__fdiv_rn(S[i], fmaxf(s_sc[i], 1e-30f)));
      a.s_q[(row * DK + i) * DV + j] =
          (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
    }
  }
}

template <int D, bool Q8>
cudaError_t launch(const WkvArgs& a, cudaStream_t s) {
  wkv_kernel<D, D, Q8><<<a.rows, D, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool Q8>
cudaError_t launch_d(const WkvArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 8: return launch<8, Q8>(a, s);
    case 16: return launch<16, Q8>(a, s);
    case 32: return launch<32, Q8>(a, s);
    case 64: return launch<64, Q8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a: the tensors' device pointers, shapes and dtype codes in host memory.
// dk == dv in {8, 16, 32, 64}; q8 != 0 selects the int8-state form.
// Launches on `stream`; returns a cudaError_t.
extern "C" int wkv_forward(const WkvArgs* a, int dk, int dv, int q8,
                           int device, void* stream) {
  if (a == nullptr || a->rows < 0 || a->t_len < 0 || dk != dv ||
      (a->ckpt != nullptr && (a->block_t <= 0 || a->t_len % a->block_t)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->rows == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(q8 ? launch_d<true>(*a, dk, s) : launch_d<false>(*a, dk, s));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
