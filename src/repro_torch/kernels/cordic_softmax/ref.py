"""Plain torch version of the CORDIC softmax kernel (its oracle).

Per row, at Q(frac+G): integer max-subtraction, clamped ``exp_neg``, an
int32 row sum floored at 1 (exact and independent of the order of the
adds), the CORDIC divide of every entry by the sum, zero-skip for
exponentials that underflowed to 0, and rounding back at the output
latch — the reference package's ``kernels/cordic_softmax/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import cordic
from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels.cordic_act.ref import (EXP_ARG_CLAMP, GUARD_BITS,
                                                _divide_ref, _round_back_ref,
                                                check_config,
                                                exp_neg_raw_ref)


def cordic_softmax_raw_ref(x_raw: torch.Tensor, *, fmt: FxpFormat,
                           n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                           n_div: int = cordic.N_DIVISION_STAGES,
                           guard: int = GUARD_BITS) -> torch.Tensor:
    """Row softmax over the last axis of a 2-D raw int32 array."""
    check_config("exp", fmt, guard)
    fb = fmt.frac_bits + guard
    a = torch.bitwise_left_shift(x_raw.to(torch.int32), guard)
    clamp = fxp.constant_raw(EXP_ARG_CLAMP, fb)
    m = torch.amax(a, dim=-1, keepdim=True)
    e = exp_neg_raw_ref(torch.clamp(a - m, min=-clamp), fb, n_hyp)
    # int32 sum, wrapping as the reference's does (no wrap at real widths:
    # every term is <= 2**12)
    tot = torch.sum(e, dim=-1, keepdim=True, dtype=torch.int32)
    tot = torch.clamp(tot, min=1)
    q = _divide_ref(e, tot.expand_as(e), fb, n_div)
    q = torch.where(e == 0, 0, q)
    return _round_back_ref(q, guard)
