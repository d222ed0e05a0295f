"""Plain torch version of the DA-VINCI activation kernel (its oracle).

The same integer recurrences as ``csrc/cordic_act.cu``, and as the
reference package's ``kernels/cordic_act/ref.py``, composed from torch
ops on raw int32 words:

  * G guard bits: inputs are up-shifted by G, iterated at Q(frac+G) and
    rounded back at the output latch;
  * integer ln2 range extension for e^a, a <= 0:
    k = round(a / ln2), r = a - k ln2, e^a = (cosh r + sinh r) >> -k;
  * hyperbolic micro-rotations (shifts 1, 2, 3, 4, 4, ...) for cosh/sinh;
  * division micro-iterations for the tanh and sigmoid quotients.

Every constant is :func:`~repro_torch.core.fixed_point.constant_raw`
(half-to-even) at Q(frac+G); int32 products wrap as the reference's do.
The same code runs on the CPU and on a card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import cordic
from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat

LN2 = math.log(2.0)
GUARD_BITS = 4
# |a| clamp before the k-extraction multiply so Q(2*fb) products fit int32.
EXP_ARG_CLAMP = 30.0
# Internal precision cap: a * (1/ln2) is a Q(2*fb) product of |a| <= 30.
MAX_INTERNAL_FRAC = 12

_AFS = ("exp", "tanh", "sigmoid")


def check_config(af: str, fmt: FxpFormat, guard: int) -> None:
    """Refuse what the integer datapath cannot compute."""
    if af not in _AFS:
        raise ValueError(f"unsupported AF {af!r}; kernel AFs: {_AFS}")
    if guard < 1:
        raise ValueError(f"guard must be >= 1 (the output latch rounds "
                         f"half a guard LSB), got {guard}")
    if fmt.frac_bits + guard > MAX_INTERNAL_FRAC:
        raise ValueError(
            f"frac_bits + guard = {fmt.frac_bits + guard} > "
            f"{MAX_INTERNAL_FRAC}: the internal precision is capped at "
            f"Q{MAX_INTERNAL_FRAC} so the ln2-extraction product fits int32")


def _delta(nonneg: torch.Tensor) -> torch.Tensor:
    return torch.where(nonneg, 1, -1).to(torch.int32)


def _hyperbolic_ref(z: torch.Tensor, fb: int, n: int):
    """Hyperbolic rotation at Q(fb): returns (cosh_raw, sinh_raw)."""
    inv_gain = fxp.constant_raw(1.0 / cordic.hyperbolic_gain(n), fb)
    x = torch.full_like(z, inv_gain)
    y = torch.zeros_like(z)
    for shift in cordic.hyperbolic_sequence(n):
        e_i = fxp.constant_raw(math.atanh(2.0 ** (-shift)), fb)
        delta = _delta(z >= 0)
        x, y, z = (x + delta * torch.bitwise_right_shift(y, shift),
                   y + delta * torch.bitwise_right_shift(x, shift),
                   z - delta * e_i)
    return x, y


def _divide_ref(y: torch.Tensor, x: torch.Tensor, fb: int, n: int
                ) -> torch.Tensor:
    """Linear vectoring at Q(fb): quotient y/x (x > 0, |y/x| < 2)."""
    q = torch.zeros_like(y)
    for i in range(n):
        e_i = fxp.constant_raw(2.0 ** (-i), fb)
        delta = _delta(y >= 0)
        y = y - delta * torch.bitwise_right_shift(x, i)
        q = q + delta * e_i
    return q


def exp_neg_raw_ref(a: torch.Tensor, fb: int, n_hyp: int) -> torch.Tensor:
    """e^a for a <= 0 at Q(fb); callers clamp a >= -EXP_ARG_CLAMP."""
    inv_ln2 = fxp.constant_raw(1.0 / LN2, fb)
    ln2 = fxp.constant_raw(LN2, fb)
    t = a * inv_ln2                                   # Q(2*fb) product
    k = torch.bitwise_right_shift(t + (1 << (2 * fb - 1)), 2 * fb)
    r = a - k * ln2
    c, s = _hyperbolic_ref(r, fb, n_hyp)
    return torch.bitwise_right_shift(c + s, torch.clamp(-k, 0, 31))


def _round_back_ref(v: torch.Tensor, guard: int) -> torch.Tensor:
    """Round from Q(frac+guard) back to Q(frac): the output latch."""
    return torch.bitwise_right_shift(v + (1 << (guard - 1)), guard)


def cordic_act_raw_ref(x_raw: torch.Tensor, *, af: str, fmt: FxpFormat,
                       n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                       n_div: int = cordic.N_DIVISION_STAGES,
                       guard: int = GUARD_BITS) -> torch.Tensor:
    """Elementwise tanh / sigmoid / exp on raw int32 words of ``fmt``."""
    check_config(af, fmt, guard)
    fb = fmt.frac_bits + guard
    a = torch.bitwise_left_shift(x_raw.to(torch.int32), guard)
    one = 1 << fb
    clamp = fxp.constant_raw(EXP_ARG_CLAMP, fb)
    if af == "exp":
        a = torch.clamp(a, -clamp, 0)
        return _round_back_ref(exp_neg_raw_ref(a, fb, n_hyp), guard)
    if af == "tanh":
        # tanh(-|a|) = (e^{-2|a|} - 1) / (e^{-2|a|} + 1), mirrored by sign
        cap = fxp.constant_raw(
            min(4.0, fmt.max_value / 2.0 - fmt.resolution), fb)
        a_abs = torch.clamp(torch.abs(a), max=cap)
        e2a = exp_neg_raw_ref(-(a_abs + a_abs), fb, n_hyp)
        q = _divide_ref(e2a - one, e2a + one, fb, n_div)
        return _round_back_ref(torch.where(a >= 0, -q, q), guard)
    e = exp_neg_raw_ref(torch.clamp(-torch.abs(a), min=-clamp), fb, n_hyp)
    q = _divide_ref(torch.full_like(a, one), one + e, fb, n_div)
    return _round_back_ref(torch.where(a >= 0, q, one - q), guard)
