"""Plain torch version of the CORDIC matmul (the kernel's oracle).

Identity used: the n-stage linear-CORDIC multiply-accumulate

    y[m,n] = sum_k sum_i delta_i[k,n] * (x[m,k] >> i)

commutes (integer adds are associative), so the whole matmul is a sum of
n signed-digit matmuls ``Y = sum_i shift_i(X) @ Delta_i`` with
``Delta_i`` in {-1,+1}^{KxN} the stage-i sign plane of the weight-residual
recurrence.

torch has no int32 matmul on CUDA, so each stage's product is taken in
float64.  That is exact while every partial sum stays below 2**53: each
term is below 2**31 in magnitude, so K < 2**22 suffices.  The stage sums
are added in int64 and wrapped to int32 (mod 2**32), as the reference's
int32 accumulator wraps.  The same code runs on the CPU and on the card.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat

# K bound under which a float64 dot of int32 terms is exact (see above).
MAX_EXACT_K = 2 ** 22
# x >> i is defined for shifts below the word width; the kernel keeps one
# sign bit per stage in a 32-bit mask.
MAX_STAGES = 32


@functools.lru_cache(maxsize=128)
def stage_constants(fmt: FxpFormat, n_stages: int) -> Tuple[int, ...]:
    """E_i = 2**-i in ``fmt``: half-to-even, so FXP8's E_5 is 0."""
    if not 1 <= n_stages <= MAX_STAGES:
        raise ValueError(f"n_stages must be in [1, {MAX_STAGES}], got "
                         f"{n_stages}")
    return tuple(fxp.constant(2.0 ** (-i), fmt) for i in range(n_stages))


def weight_sign_planes(w_raw: torch.Tensor, fmt: FxpFormat, n_stages: int
                       ) -> torch.Tensor:
    """Delta_i planes, shape (n_stages, K, N), values in {-1, +1} (int32)."""
    z = w_raw.to(torch.int32)
    planes = []
    for e in stage_constants(fmt, n_stages):
        delta = torch.where(z >= 0, 1, -1).to(torch.int32)
        planes.append(delta)
        z = z - delta * e
    return torch.stack(planes)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement wrap)."""
    return (torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def cordic_matmul_raw_ref(x_raw: torch.Tensor, w_raw: torch.Tensor, *,
                          fmt: FxpFormat, n_stages: int) -> torch.Tensor:
    m, k = x_raw.shape
    k2, n = w_raw.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(x_raw.shape)} @ "
                         f"{tuple(w_raw.shape)}")
    if k >= MAX_EXACT_K:
        raise ValueError(f"K={k} >= 2**22: a float64 dot of int32 terms is "
                         f"no longer exact")
    x_raw = x_raw.to(torch.int32)
    z = w_raw.to(torch.int32)
    out = torch.zeros((m, n), dtype=torch.int64, device=x_raw.device)
    # one plane at a time: at lm_head width a float64 plane is 5 GB
    for i, e in enumerate(stage_constants(fmt, n_stages)):
        delta = torch.where(z >= 0, 1, -1).to(torch.int32)
        xs = torch.bitwise_right_shift(x_raw, i).to(torch.float64)
        out += (xs @ delta.to(torch.float64)).to(torch.int64)
        z = z - delta * e
    return _wrap_int32(out)


def cordic_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, fmt: FxpFormat,
                      n_stages: int) -> torch.Tensor:
    """Float frontend: quantize -> raw matmul -> dequantize."""
    out_raw = cordic_matmul_raw_ref(fxp.quantize(x, fmt), fxp.quantize(w, fmt),
                                    fmt=fmt, n_stages=n_stages)
    return fxp.dequantize(out_raw, fmt)
