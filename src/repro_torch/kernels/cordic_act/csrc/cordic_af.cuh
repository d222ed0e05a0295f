// DA-VINCI integer datapath shared by the cordic_act and cordic_softmax
// kernels: ln2 range extension, hyperbolic rotation, division and the
// output latch on raw int32 words at Q(fb) = Q(frac + guard).
//
// The same recurrences as repro/kernels/cordic_act/kernel.py (_exp_neg,
// _hyperbolic, _divide, _round_back) and as the port's plain version
// (kernels/cordic_act/ref.py), bit for bit:
//   * every constant is computed on the host with constant_raw
//     (half-to-even) at Q(fb) and passed in AfParams; past fb some of them
//     are 0 (the 2**-i division words), and the code never derives one
//     from 1 << (fb - i);
//   * adds, subtracts, negations and products wrap mod 2**32, as the
//     reference's int32 arithmetic does: they run in uint32, because
//     signed overflow is undefined in C++;
//   * >> on int32 is arithmetic (floor), and a shift count above 31 acts as
//     31, as torch.bitwise_right_shift and XLA's shift do;
//   * the hyperbolic step updates x and y together: both shifts read the
//     old x and y.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cordic_af {

constexpr int kMaxIters = 32;

enum Af : int32_t { kExp = 0, kTanh = 1, kSigmoid = 2 };

// One AF configuration, built on the host (kernels/cordic_act/kernel.py).
struct AfParams {
  int32_t af;        // Af; the softmax kernel uses only exp_neg
  int32_t guard;     // G >= 1
  int32_t fb;        // frac_bits + G <= 12
  int32_t one;       // 1 << fb
  int32_t clamp;     // constant_raw(30, fb): |a| bound before a * (1/ln2)
  int32_t cap;       // tanh input cap, min(4, max/2 - resolution) at Q(fb)
  int32_t inv_ln2;   // constant_raw(1/ln2, fb)
  int32_t ln2;       // constant_raw(ln2, fb)
  int32_t inv_gain;  // constant_raw(1/K_h(n_hyp), fb)
  int32_t n_hyp;
  int32_t n_div;
  int32_t shift[kMaxIters];    // hyperbolic shift schedule 1,2,3,4,4,5,...
  int32_t atanh_e[kMaxIters];  // constant_raw(atanh(2**-shift), fb)
  int32_t div_e[kMaxIters];    // constant_raw(2**-i, fb)
};

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t neg(int32_t a) {
  return (int32_t)(0u - (uint32_t)a);
}
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t shl(int32_t a, int s) {
  return (int32_t)((uint32_t)a << s);
}
__device__ __forceinline__ int32_t sar(int32_t a, int s) {
  return a >> (s > 31 ? 31 : s);
}
__device__ __forceinline__ int32_t abs32(int32_t a) {  // abs(INT_MIN) wraps
  return a < 0 ? neg(a) : a;
}

// e**a for a <= 0 at Q(fb): k = round(a / ln2) from the Q(2 fb) product,
// r = a - k ln2, (cosh r + sinh r) >> -k.  Callers clamp a >= -clamp.
__device__ __forceinline__ int32_t exp_neg(int32_t a, const AfParams& p) {
  const int32_t t = mul(a, p.inv_ln2);
  const int32_t k = sar(add(t, (int32_t)(1u << (2 * p.fb - 1))), 2 * p.fb);
  int32_t x = p.inv_gain, y = 0, z = sub(a, mul(k, p.ln2));
  for (int i = 0; i < p.n_hyp; ++i) {
    const int s = p.shift[i];
    const int32_t ys = sar(y, s), xs = sar(x, s);
    if (z >= 0) {
      x = add(x, ys);
      y = add(y, xs);
      z = sub(z, p.atanh_e[i]);
    } else {
      x = sub(x, ys);
      y = sub(y, xs);
      z = add(z, p.atanh_e[i]);
    }
  }
  const int32_t nk = neg(k);
  return sar(add(x, y), nk < 0 ? 0 : (nk > 31 ? 31 : nk));
}

// Linear vectoring at Q(fb): the quotient y / x (x > 0, |y / x| < 2).
__device__ __forceinline__ int32_t divide(int32_t y, int32_t x,
                                          const AfParams& p) {
  int32_t q = 0;
  for (int i = 0; i < p.n_div; ++i) {
    const int32_t xs = sar(x, i);
    if (y >= 0) {
      y = sub(y, xs);
      q = add(q, p.div_e[i]);
    } else {
      y = add(y, xs);
      q = sub(q, p.div_e[i]);
    }
  }
  return q;
}

// The output latch: round Q(frac + guard) back to Q(frac).
__device__ __forceinline__ int32_t round_back(int32_t v, int guard) {
  return sar(add(v, (int32_t)(1u << (guard - 1))), guard);
}

}  // namespace cordic_af

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
