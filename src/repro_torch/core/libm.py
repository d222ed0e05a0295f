"""``exp``, ``log``, ``exp2`` and ``log2`` as the reference evaluates them.

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
  bfloat16), each step rounded to that dtype.

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


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32 is
    exact in float64, and the float64 sum rounds to the float32 nearest
    the exact result except in double-rounding ties (about 2**-29 of
    cases)."""
    return (a.to(torch.float64) * b + c).to(_F32)


def _flush(y: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 results -> zero of the same sign."""
    return torch.where(y.abs() < _FLT_MIN, y * 0.0, y)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``e**x``, evaluated in float32 and rounded to ``x``'s dtype."""
    dt = x.dtype
    x = _flush(x.to(_F32))
    x = torch.where(x < _EXP_LO, _EXP_LO, x)    # NaN passes through
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    n = torch.floor(_fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = _fma(-n, _C2, _fma(-n, _C1, x))
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = _fma(p, r, c)
    y = _fma(p, r * r, r) + 1.0
    pow2n = torch.bitwise_left_shift(n.to(torch.int32) + 127, 23).view(_F32)
    return _flush(y * pow2n).to(dt)


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log, evaluated in float32 and rounded to ``x``'s dtype."""
    dt = x.dtype
    x = _flush(x.to(_F32))      # subnormal inputs read as zero
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
    a = _fma(_fma(z, c0, c1), z, c2)
    b = _fma(_fma(z, c3, c4), z, c5)
    c = _fma(_fma(z, c6, c7), z, c8)
    y = _fma(_fma(_fma(a, z3, b), z3, c), z3, e * _C2)
    out = _fma(e, _C1, _fma(z2, -0.5, z) + y)
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


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d tensor of ``like``'s dtype, on its device.

    The reference rounds a Python constant to the other operand's dtype,
    and divides by it: a CUDA tensor divided by a Python number is
    multiplied by its reciprocal instead, which rounds differently.  A 0-d
    tensor on the device is divided by; ``torch.full`` makes it without a
    copy from the host (which would wait for the device)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)
