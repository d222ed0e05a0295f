"""``exp``, ``log``, ``exp2``, ``log2`` and ``tanh`` as the reference
evaluates them.

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
  its Horner steps fused, ``x`` itself below 0.0004 and +-1 from 20 up.

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
def _ln2_in(dtype: torch.dtype) -> float:
    return torch.tensor(math.log(2.0), dtype=dtype).item()


@functools.lru_cache(maxsize=None)
def _inv_ln2_in(dtype: torch.dtype) -> float:
    """float32 reciprocal of ``ln2`` rounded to ``dtype``."""
    return (torch.tensor(1.0) / torch.tensor(_ln2_in(dtype))).item()


def exp2(x: torch.Tensor) -> torch.Tensor:
    """``2**x`` as ``exp(x * ln2)``, in ``x``'s dtype."""
    dt = x.dtype
    return exp((x.to(_F32) * _ln2_in(dt)).to(dt))


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
