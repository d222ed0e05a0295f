"""``exp``, ``log``, ``exp2``, ``log2``, ``tanh``, ``sin`` and ``cos`` as
the reference evaluates them.

The float-emulated fixed point of :mod:`repro_torch.core.cordic`,
:mod:`~repro_torch.core.activations` and
:mod:`~repro_torch.core.quantization` takes integer exponents and pow-2
scales from these four functions.  ``torch.exp`` and ``torch.log`` differ
from the reference's in the last bit on 1-15 % of float32 inputs, and
``jnp.log2(2.0**-15)`` is ``-14.999999`` there, so ``ceil`` of it is
``-14``: the port has to agree with the reference, not with the
mathematics.  So this module spells out the reference's evaluation, one
rounded float32 operation at a time:

* ``exp``: clamp to [-87.8, 88.8], ``n = floor(x log2(e) + 1/2)`` clamped
  to [-127, 127], a two-constant Cody-Waite reduction, a degree-5
  polynomial (Cephes ``expf``), times ``2**n`` built from its bits;
* ``log``: mantissa in [sqrt(1/2), sqrt(2)), a degree-8 polynomial
  (Cephes ``logf``), the exponent added back in two parts; 0 -> -inf,
  +inf -> +inf, negative and NaN -> NaN;
* each multiply whose product feeds one add is fused with it (one
  rounding), as the reference's compiler contracts them on an x86 CPU
  with FMA; every other step rounds to float32;
* results below the smallest normal float32 are flushed to zero, as the
  reference's CPU runtime does;
* ``exp2(x) = exp(x * ln2)`` and ``log2(x) = log(x) * (1 / ln2)``, the
  constant rounded to the input's dtype (``ln2`` is 0.69140625 in
  bfloat16), each step rounded to that dtype;
* ``tanh``: the input clamped to +-7.99881172, a rational polynomial
  (odd degree 13 over even degree 6 in x, Eigen's fast float tanh) with
  its Horner steps fused, ``x`` itself below 0.0004 and +-1 from 20 up;
* ``sin``/``cos`` (float32, the rotary embedding's): the reference's CPU
  compiler calls the C library's ``sinf``/``cosf``, which work in float64:
  below 120 a reduction by the nearest multiple of pi/2, from 120 up an
  exact reduction against 192 bits of 2/pi in integer arithmetic, then a
  degree-7 sine or degree-8 cosine polynomial of the reduced argument,
  rounded once to float32.  The library is built with FMAs: each
  multiply-add of the reduction and the polynomials rounds once in
  float64 (:func:`_fma64`).  The steps are spelled out in float64 and
  int64 torch operations.

Differentiated, ``exp`` and ``tanh`` take JAX's rules at their own
result, ``g * exp(x)`` and ``g * (1 - tanh(x)**2)``, as the reference's
``jnp.exp`` and ``jnp.tanh`` do, not the derivative of the polynomial.

:func:`fma` is the fused multiply-add itself, for the model code whose
multiply and add the reference's compiler contracts into one;
:func:`fma_exact` rounds once in every case, as a hardware ``fmaf`` does,
at about six times the torch operations.

Every step is a plain torch float32 operation, correctly rounded on the
CPU and on a CUDA card alike, so the card computes the same bits.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

_F32 = torch.float32
_FLT_MIN = 2.0 ** -126

# exp: Cephes expf
_EXP_HI = 88.80000305175781
_EXP_LO = -87.80000305175781
_LOG2E = 1.4426950216293335
_C1 = 0.693359375
_C2 = -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
          0.5)

# log: Cephes logf
_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)


# tanh: XLA's CPU expansion (Eigen's generic_fast_tanh_float, FMA build)
_TANH_CLAMP = 7.998811721801758
_TANH_TINY = 0.00039999998989515007
_TANH_BIG = 20.0
_TANH_P = (-2.7607683663038313e-16, 2.0001879384549948e-13,
           -8.604671836165423e-11, 5.122297253024044e-08,
           1.4857223504805006e-05, 0.0006372619536705315,
           0.004893524572253227)
_TANH_Q = (1.1982583600911312e-06, 0.00011853470641653985,
           0.0022684347350150347, 0.0048935250379145145)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32 is
    exact in float64, and the float64 sum rounds to the float32 nearest
    the exact result except in double-rounding ties (about 2**-29 of
    cases)."""
    return (a.to(torch.float64) * b + c).to(_F32)


def fma_exact(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, double-rounding ties included:
    the exact product in float64, the sum's rounding error from Knuth's
    two-sum, the sum rounded to odd in float64 (the neighbour with an odd
    last bit wherever the sum was inexact), then rounded to float32,
    which is then the float32 nearest the exact result (float64 carries
    more than two bits beyond float32's)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    c_part = s - p
    err = (p - (s - c_part)) + (c - c_part)
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    return torch.where(step, torch.nextafter(s, toward), s).to(_F32)


def flush(y: torch.Tensor) -> torch.Tensor:
    """Subnormal results -> zero of the same sign, as the reference's CPU
    runtime flushes them (float32 and bfloat16 alike)."""
    return torch.where(y.abs() < _FLT_MIN, y * 0.0, y)


class _AtResult(torch.autograd.Function):
    """``fn(x)`` whose gradient is ``rule(fn(x), g)``: the derivative
    rule of the exact function, evaluated at the computed result."""

    @staticmethod
    def forward(ctx, fn, rule, x):
        y = fn(x)
        ctx.rule = rule
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return None, None, ctx.rule(y, g)


def _differentiable(fn, rule):
    @functools.wraps(fn)
    def call(x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _AtResult.apply(fn, rule, x)
        return fn(x)
    return call


def _exp(x: torch.Tensor) -> torch.Tensor:
    """``e**x``, evaluated in float32 and rounded to ``x``'s dtype."""
    dt = x.dtype
    x = flush(x.to(_F32))
    x = torch.where(x < _EXP_LO, _EXP_LO, x)    # NaN passes through
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    n = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(-n, _C2, fma(-n, _C1, x))
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma(p, r, c)
    y = fma(p, r * r, r) + 1.0
    pow2n = torch.bitwise_left_shift(n.to(torch.int32) + 127, 23).view(_F32)
    return flush(y * pow2n).to(dt)


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log, evaluated in float32 and rounded to ``x``'s dtype."""
    dt = x.dtype
    x = flush(x.to(_F32))      # subnormal inputs read as zero
    xc = torch.where(x > _FLT_MIN, x, _FLT_MIN)  # NaN handled below
    bits = xc.view(torch.int32)
    e = (torch.bitwise_right_shift(bits, 23) - 127).to(_F32) + 1.0
    m = torch.bitwise_or(torch.bitwise_and(bits, 0x807FFFFF - 2 ** 32),
                         0x3F000000).view(_F32)        # in [0.5, 1)
    small = m < _SQRTHF
    e = e - small.to(_F32)
    z = (m - 1.0) + torch.where(small, m, 0.0)
    z2 = z * z
    z3 = z2 * z
    c0, c1, c2, c3, c4, c5, c6, c7, c8 = _LOG_P
    a = fma(fma(z, c0, c1), z, c2)
    b = fma(fma(z, c3, c4), z, c5)
    c = fma(fma(z, c6, c7), z, c8)
    y = fma(fma(fma(a, z3, b), z3, c), z3, e * _C2)
    out = fma(e, _C1, fma(z2, -0.5, z) + y)
    out = torch.where((x > 0) & ~torch.isinf(x), out, math.nan)
    out = torch.where(x == 0, -math.inf, out)
    return torch.where(x == math.inf, math.inf, out).to(dt)


@functools.lru_cache(maxsize=None)
def ln2_in(dtype: torch.dtype) -> float:
    """``ln2`` rounded to ``dtype``: the factor of :func:`exp2`."""
    return torch.tensor(math.log(2.0), dtype=dtype).item()


@functools.lru_cache(maxsize=None)
def _inv_ln2_in(dtype: torch.dtype) -> float:
    """float32 reciprocal of ``ln2`` rounded to ``dtype``."""
    return (torch.tensor(1.0) / torch.tensor(ln2_in(dtype))).item()


def exp2(x: torch.Tensor) -> torch.Tensor:
    """``2**x`` as ``exp(x * ln2)``, in ``x``'s dtype."""
    dt = x.dtype
    return exp((x.to(_F32) * ln2_in(dt)).to(dt))


def log2(x: torch.Tensor) -> torch.Tensor:
    """``log2(x)`` as ``log(x) * (1 / ln2)``, in ``x``'s dtype."""
    return (log(x).to(_F32) * _inv_ln2_in(x.dtype)).to(x.dtype)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """``tanh(x)`` of a float32 tensor as the reference's CPU compiler
    expands it (see the module docstring)."""
    x = x.to(_F32)
    ax = x.abs()
    xc = torch.where(x < -_TANH_CLAMP, -_TANH_CLAMP, x)   # NaN passes
    xc = torch.where(xc > _TANH_CLAMP, _TANH_CLAMP, xc)
    x2 = xc * xc
    p = fma(x2, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = fma(x2, p, c)
    q = fma(x2, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = fma(x2, q, c)
    y = torch.where(ax < _TANH_TINY, x, (xc * p) / q)
    return torch.where(ax >= _TANH_BIG, torch.copysign(torch.ones_like(x), x),
                       y)


exp = _differentiable(_exp, lambda y, g: g * y)
tanh = _differentiable(_tanh, lambda y, g: g * (1.0 - y * y))


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d tensor of ``like``'s dtype, on its device.

    The reference rounds a Python constant to the other operand's dtype,
    and divides by it: a CUDA tensor divided by a Python number is
    multiplied by its reciprocal instead, which rounds differently.  A 0-d
    tensor on the device is divided by; ``torch.full`` makes it without a
    copy from the host (which would wait for the device)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# sin/cos: the C library's sinf/cosf (float64 inside)
_HPI_INV_2P24 = float.fromhex("0x1.45F306DC9C883p+23")   # 2/pi * 2**24
_HPI = float.fromhex("0x1.921FB54442D18p0")              # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")           # pi/2 * 2**-62
_SIN_S = tuple(map(float.fromhex, ("-0x1.555545995a603p-3",
                                   "0x1.1107605230bc4p-7",
                                   "-0x1.994eb3774cf24p-13")))
_COS_C = tuple(map(float.fromhex, ("-0x1.ffffffd0c621cp-2",
                                   "0x1.55553e1068f19p-5",
                                   "-0x1.6c087e89a359dp-10",
                                   "0x1.99343027bf8c3p-16")))


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 ``a * b + c`` rounded once (up to a rounding error of the
    product's own error term, far below what reaches a float32 result):
    Dekker's exact product, Knuth's two-sum, one final add."""
    a = torch.as_tensor(a, dtype=torch.float64, device=c.device)
    b = torch.as_tensor(b, dtype=torch.float64, device=c.device)
    p = a * b

    def split(x):
        hi = x * 134217729.0                    # 2**27 + 1
        hi = hi - (hi - x)
        return hi, x - hi

    (ah, al), (bh, bl) = split(a), split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    c_part = s - p
    return s + (((p - (s - c_part)) + (c - c_part)) + err)


def _two_over_pi_words() -> Tuple[int, ...]:
    """Windows of 32 bits of the fraction of 2/pi, each 8 bits on from the
    last (the first three shorter): the table of the exact reduction.
    2/pi comes from Machin's formula in 320-bit integers."""
    bits = 320

    def arctan_inv(n: int) -> int:
        term = (1 << bits) // n
        total, k, sign = term, 1, -1
        while term:
            term //= n * n
            k += 2
            total += sign * (term // k)
            sign = -sign
        return total

    pi = 4 * (4 * arctan_inv(5) - arctan_inv(239))
    two_over_pi = (2 << (2 * bits)) // pi        # 2/pi in `bits` fraction bits
    return tuple(((two_over_pi << (8 * (i + 1))) >> bits) & 0xFFFFFFFF
                 for i in range(24))


_INV_PIO2_WORDS = _two_over_pi_words()


def _reduce_large(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r, n) with y = r + n pi/2 exactly reduced, |r| <= pi/4, r in
    float64, for |y| >= 120: a 32 x 96 -> 128 bit fixed-point product of
    y's mantissa with the right window of 2/pi, kept modulo 2**64 in int64
    (whose adds, products and left shifts wrap as unsigned ones do)."""
    words = torch.tensor(_INV_PIO2_WORDS, dtype=torch.int64, device=y.device)
    xi = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    idx = (xi >> 26) & 15
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
    res0 = (m * words[idx]) & 0xFFFFFFFF        # a 32-bit product
    res0 = ((m * words[idx + 8]) >> 32) | (res0 << 32)
    res0 = res0 + m * words[idx + 4]
    n = ((res0 + (1 << 61)) >> 62) & 3
    return (res0 - (n << 62)).to(torch.float64) * _PI63, n


def _sincos(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """``sinf(y)`` or ``cosf(y)`` of a float32 tensor, bit for bit."""
    y = y.to(_F32)
    x = y.to(torch.float64)
    ay = y.abs()
    # |y| < 120: n = nearest integer to y 2/pi, from a truncation at 2**24
    n = ((x * _HPI_INV_2P24).to(torch.int32).to(torch.int64)
         + 0x800000) >> 24
    r = _fma64(-n.to(torch.float64), _HPI, x)
    r_large, n_large = _reduce_large(y)
    large = ay >= 120.0
    r = torch.where(large, r_large, r)
    n = torch.where(large, n_large, n)
    # the sign quadrant counts y's own sign on the exact path
    quad = torch.where(large, n_large + (y.view(torch.int32) < 0).long(), n)
    small = ay < 0.78125                       # below pi/4: no reduction
    r = torch.where(small, x, r)
    n = torch.where(small, 0, n)
    quad = torch.where(small, 0, quad)
    flip = (quad & 2) != 0                     # the negated cosine table
    r_signed = torch.where(((quad + 1) & 2) != 0, -r, r)
    r2 = r * r
    r3 = r_signed * r2
    s12 = _fma64(r2, _SIN_S[2], torch.full_like(r, _SIN_S[1]))
    sin_v = _fma64(r3 * r2, s12, _fma64(r3, _SIN_S[0], r_signed))
    one = torch.where(flip, -1.0, 1.0).to(torch.float64)
    r4 = r2 * r2
    cos_v = _fma64(r4 * r2, _fma64(r2, one * _COS_C[3], one * _COS_C[2]),
                   _fma64(r4, one * _COS_C[1], _fma64(r2, one * _COS_C[0],
                                                      one)))
    odd = ((n ^ 1) if cos else n) & 1 != 0
    v = torch.where(odd, cos_v, sin_v).to(_F32)
    tiny = ay < 2.0 ** -12
    v = torch.where(tiny, torch.ones_like(y) if cos else y, v)
    return torch.where(torch.isfinite(y), v, torch.full_like(y, math.nan))


def sin(x: torch.Tensor) -> torch.Tensor:
    """``sin`` of float32 ``x`` as the reference evaluates it (no
    gradient: the model takes it of constant rotary angles)."""
    return _sincos(x, cos=False)


def cos(x: torch.Tensor) -> torch.Tensor:
    """``cos`` of float32 ``x`` as the reference evaluates it."""
    return _sincos(x, cos=True)
