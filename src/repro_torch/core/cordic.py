"""CORDIC compute modes (Table 2 of the paper), bit-accurate in torch.

The three RPE datapaths on raw int32 fixed-point words:

  * linear rotation     — shift-add multiply-accumulate (the MAC stage),
  * hyperbolic rotation — sinh/cosh (=> exp, tanh, sigmoid, GeLU, ...),
  * linear vectoring    — iterative division (softmax / sigmoid
    denominators),

plus circular rotation (sin/cos) and hyperbolic vectoring (sqrt, ln).
Every function mirrors the reference package's ``core/cordic.py`` op for
op, float range extensions included (``k = round(a / ln2)``,
``ceil(log2(.))``), with ``exp2``/``log2`` taken from
:mod:`repro_torch.core.libm` so that the integer exponents agree with the
reference bit for bit, near powers of two as well.

Iteration defaults follow the paper's Pareto conclusion: 5 pipelined
linear stages, 5 hyperbolic and 4 division micro-iterations.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple, Union

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import libm
from repro_torch.core.fixed_point import FxpFormat

Number = Union[torch.Tensor, float]

# Paper's Pareto-optimal stage counts (Section 2.2.2).
N_LINEAR_STAGES = 5
N_HYPERBOLIC_STAGES = 5
N_DIVISION_STAGES = 4

LN2 = math.log(2.0)


def _f32(a: Number) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _tensor(a: Number) -> torch.Tensor:
    """A tensor as it is; a Python number as float32."""
    return a if isinstance(a, torch.Tensor) else _f32(a)


def _delta(nonneg: torch.Tensor) -> torch.Tensor:
    """The stage's direction: +1 where ``nonneg``, else -1 (int32)."""
    return torch.where(nonneg, 1, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Iteration schedules and gain constants
# ---------------------------------------------------------------------------

def hyperbolic_sequence(n: int) -> Tuple[int, ...]:
    """Shift schedule for hyperbolic CORDIC: 1,2,3,4,4,5,... (repeat 4,13,40).

    The repeats are required for convergence of the hyperbolic recurrence
    (Walther); hardware bakes this into the stage wiring.
    """
    seq = []
    i = 1
    repeat_at = {4, 13, 40}
    while len(seq) < n:
        seq.append(i)
        if i in repeat_at and len(seq) < n:
            seq.append(i)
        i += 1
    return tuple(seq[:n])


@functools.lru_cache(maxsize=None)
def hyperbolic_gain(n: int) -> float:
    """K_h = prod sqrt(1 - 2^-2i) over the shift schedule (~0.8282)."""
    k = 1.0
    for i in hyperbolic_sequence(n):
        k *= math.sqrt(1.0 - 2.0 ** (-2 * i))
    return k


def hyperbolic_range(n: int) -> float:
    """Max |z| for which hyperbolic rotation converges (~1.1182)."""
    return sum(math.atanh(2.0 ** (-i)) for i in hyperbolic_sequence(n))


@functools.lru_cache(maxsize=None)
def circular_gain(n: int) -> float:
    k = 1.0
    for i in range(n):
        k *= math.sqrt(1.0 + 2.0 ** (-2 * i))
    return k


# ---------------------------------------------------------------------------
# Linear rotation mode: y <- y0 + x0 * z0  (the MAC datapath)
# ---------------------------------------------------------------------------

def linear_rotate_raw(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                      fmt: FxpFormat, n: int = N_LINEAR_STAGES,
                      unroll: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-int linear CORDIC rotation: ``y + x * z`` with ``z`` in ``fmt``
    (|z| < 2).  Returns ``(y_n, z_residual)``.

    ``unroll`` names the reference's two schedules, the pipelined MAC
    (one hard-wired stage per ``2^-i``) and the iterative one (a single
    stage re-used); both compute the same words, and eager torch runs
    both as the same loop.
    """
    del unroll
    x = x.to(torch.int32)
    yi = y.to(torch.int32)
    zi = z.to(torch.int32)
    # E_i = 2^-i in fmt; 0 once i > frac_bits, as the hardware constant
    for i in range(n):
        e_i = fxp.constant(2.0 ** (-i), fmt)
        delta = _delta(zi >= 0)
        yi = yi + delta * fxp.ashr(x, i)
        zi = zi - delta * e_i
    return yi, zi


def mac(x: Number, w: Number, acc: Number, fmt: FxpFormat,
        n: int = N_LINEAR_STAGES, rounding: str = "rne") -> torch.Tensor:
    """Real-valued CORDIC MAC: ``acc + x*w`` with the RPE's n-stage multiply
    (``w`` plays the CORDIC ``z`` and must satisfy |w| < 2)."""
    x_raw = fxp.quantize(x, fmt, rounding)
    w_raw = fxp.quantize(w, fmt, rounding)
    acc_raw = fxp.quantize(acc, fmt, rounding)
    y_raw, _ = linear_rotate_raw(x_raw, acc_raw, w_raw, fmt, n)
    return fxp.dequantize(y_raw, fmt)


def multiply(x: Number, w: Number, fmt: FxpFormat,
             n: int = N_LINEAR_STAGES) -> torch.Tensor:
    return mac(x, w, torch.zeros_like(_f32(x)), fmt, n)


# ---------------------------------------------------------------------------
# Hyperbolic rotation mode: (cosh z, sinh z)
# ---------------------------------------------------------------------------

def hyperbolic_rotate_raw(z: torch.Tensor, fmt: FxpFormat,
                          n: int = N_HYPERBOLIC_STAGES,
                          unroll: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-int hyperbolic rotation, |z| (in fmt) < hyperbolic_range(n).

    Seeds x0 = 1/K_h so the gain is pre-compensated.  Returns
    (cosh_raw, sinh_raw).  ``unroll`` as in :func:`linear_rotate_raw`.
    """
    del unroll
    z = z.to(torch.int32)
    x = torch.full_like(z, fxp.constant(1.0 / hyperbolic_gain(n), fmt))
    y = torch.zeros_like(z)
    for shift in hyperbolic_sequence(n):
        e_i = fxp.constant(math.atanh(2.0 ** (-shift)), fmt)
        delta = _delta(z >= 0)
        # simultaneous update: both shifts read the old x and y
        x, y, z = (x + delta * fxp.ashr(y, shift),
                   y + delta * fxp.ashr(x, shift),
                   z - delta * e_i)
    return x, y


def cosh_sinh(a: Number, fmt: FxpFormat, n: int = N_HYPERBOLIC_STAGES
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-valued cosh/sinh with the input clamped to the convergence
    range."""
    rng = hyperbolic_range(n)
    a_raw = fxp.quantize(torch.clamp(_tensor(a), -rng, rng), fmt)
    c_raw, s_raw = hyperbolic_rotate_raw(a_raw, fmt, n)
    return fxp.dequantize(c_raw, fmt), fxp.dequantize(s_raw, fmt)


def exp_fxp(a: Number, fmt: FxpFormat, n: int = N_HYPERBOLIC_STAGES,
            range_extend: bool = True) -> torch.Tensor:
    """e^a via cosh + sinh.

    ``range_extend=True`` applies a = k*ln2 + r and scales the result by
    2^k (a barrel shift in hardware); ``False`` clamps the input to the
    native convergence range (paper-faithful).
    """
    a = _f32(a)
    if not range_extend:
        c, s = cosh_sinh(a, fmt, n)
        return c + s
    k = torch.round(a / libm.const(LN2, a))
    r = a - k * LN2
    c, s = cosh_sinh(r, fmt, n)
    e_r = c + s
    return e_r * libm.exp2(k)


# ---------------------------------------------------------------------------
# Linear vectoring mode: z <- z0 + y0/x0  (the division datapath)
# ---------------------------------------------------------------------------

def divide_raw(y: torch.Tensor, x: torch.Tensor, fmt: FxpFormat,
               n: int = N_DIVISION_STAGES, extra_start: int = 0
               ) -> torch.Tensor:
    """Raw-int quotient y/x (both in a common scale), result in ``fmt``.

    Converges for |y/x| < 2^(1+extra_start); iterations run
    i = -extra_start .. n-1.  x must be > 0 (callers normalise the sign).
    """
    y = y.to(torch.int32)
    x = x.to(torch.int32)
    q = torch.zeros_like(y)
    for i in range(-extra_start, n):
        delta = _delta(y >= 0)
        e_i = fxp.constant(2.0 ** (-i), fmt)
        xs = fxp.ashr(x, i) if i >= 0 else torch.bitwise_left_shift(x, -i)
        y = y - delta * xs
        q = q + delta * e_i
    return q


def divide(num: Number, den: Number, fmt: FxpFormat,
           n: int = N_DIVISION_STAGES, extra_start: int = 0) -> torch.Tensor:
    """Real-valued CORDIC division with sign normalisation."""
    num = _f32(num)
    den = _f32(den)
    sign = torch.sign(den)
    sign = torch.where(sign == 0, 1.0, sign)
    num_raw = fxp.quantize(num * sign, fmt)
    den_raw = fxp.quantize(torch.abs(den), fmt)
    q_raw = divide_raw(num_raw, den_raw, fmt, n, extra_start)
    return fxp.dequantize(q_raw, fmt)


# ---------------------------------------------------------------------------
# Circular mode (sin/cos)
# ---------------------------------------------------------------------------

def cos_sin(a: Number, fmt: FxpFormat, n: int = N_HYPERBOLIC_STAGES
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin via circular rotation mode, |a| <= ~1.74 rad native range."""
    z = fxp.quantize(a, fmt)
    x = torch.full_like(z, fxp.constant(1.0 / circular_gain(n), fmt))
    y = torch.zeros_like(z)
    for i in range(n):
        delta = _delta(z >= 0)
        e_i = fxp.constant(math.atan(2.0 ** (-i)), fmt)
        x, y, z = (x - delta * fxp.ashr(y, i),
                   y + delta * fxp.ashr(x, i),
                   z - delta * e_i)
    return fxp.dequantize(x, fmt), fxp.dequantize(y, fmt)


# ---------------------------------------------------------------------------
# Hyperbolic vectoring mode: sqrt, ln
# ---------------------------------------------------------------------------

def _guard_format(fmt: FxpFormat) -> FxpFormat:
    """The vectoring modes' internal precision: 10 more fraction bits
    (at most 24) against per-stage truncation bias."""
    return dataclasses.replace(fmt, total_bits=min(fmt.total_bits + 12, 32),
                               frac_bits=min(fmt.frac_bits + 10, 24))


def sqrt_fxp(a: Number, fmt: FxpFormat, n: int = N_HYPERBOLIC_STAGES,
             range_extend: bool = True) -> torch.Tensor:
    """sqrt(a) via hyperbolic vectoring of (a + 1/4, a - 1/4).

    Driving y -> 0 leaves x_n = K_h * sqrt(a).  ``range_extend``
    normalises a = m * 4^e with m in [0.25, 1) and scales the root by 2^e.
    """
    a = torch.clamp(_f32(a), min=0.0)
    if range_extend:
        e2 = torch.ceil(libm.log2(torch.clamp(a, min=1e-30)) / 2.0)
        m = a / libm.exp2(2.0 * e2)
        root_m = sqrt_fxp(m, fmt, n, range_extend=False)
        return torch.where(a == 0.0, 0.0, root_m * libm.exp2(e2))
    gfmt = _guard_format(fmt)
    x = fxp.quantize(a + 0.25, gfmt)
    y = fxp.quantize(a - 0.25, gfmt)
    for shift in hyperbolic_sequence(n):
        delta = _delta(y < 0)
        x, y = (x + delta * fxp.ashr(y, shift),
                y + delta * fxp.ashr(x, shift))
    return fxp.dequantize(x, gfmt) * (1.0 / hyperbolic_gain(n))


def rsqrt_fxp(a: Number, fmt: FxpFormat, n: int = N_HYPERBOLIC_STAGES,
              n_div: int = N_DIVISION_STAGES) -> torch.Tensor:
    """1/sqrt(a): sqrt on the hyperbolic stage, then the division stage."""
    root = sqrt_fxp(a, fmt, n)
    # normalise the denominator to m in (0.5, 1] so the quotient 1/m stays
    # in the divider's [1, 2) range; undo with a barrel shift
    k = torch.ceil(libm.log2(torch.clamp(root, min=1e-30)))
    m = root * libm.exp2(-k)
    inv_m = divide(torch.ones_like(m), m, fmt, max(n_div, fmt.frac_bits))
    return inv_m * libm.exp2(-k)


def ln_fxp(a: Number, fmt: FxpFormat, n: int = N_HYPERBOLIC_STAGES,
           range_extend: bool = True) -> torch.Tensor:
    """ln(a) = 2*atanh((a-1)/(a+1)) via hyperbolic vectoring of
    (a+1, a-1).  ``range_extend`` uses a = m * 2^k, ln(a) = ln(m) + k ln2.
    """
    a = torch.clamp(_f32(a), min=1e-30)
    if range_extend:
        k = torch.round(libm.log2(a))
        m = a / libm.exp2(k)
        return ln_fxp(m, fmt, n, range_extend=False) + k * LN2
    gfmt = _guard_format(fmt)
    x = fxp.quantize(a + 1.0, gfmt)
    y = fxp.quantize(a - 1.0, gfmt)
    z = torch.zeros_like(x)
    for shift in hyperbolic_sequence(n):
        e_i = fxp.constant_raw(math.atanh(2.0 ** (-shift)), gfmt.frac_bits)
        delta = _delta(y < 0)
        x, y, z = (x + delta * fxp.ashr(y, shift),
                   y + delta * fxp.ashr(x, shift),
                   z - delta * e_i)
    return 2.0 * fxp.dequantize(z, gfmt)
