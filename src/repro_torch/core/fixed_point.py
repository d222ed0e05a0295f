"""Fixed-point (FxP) arithmetic on raw int32 words, in torch.

A value v is stored as ``raw`` with ``v = raw * 2**-frac_bits``; raw words
are int32 (the RPE's accumulator width).  The CORDIC recurrences run on
the raw integers with arithmetic shifts, exactly as the shift-add hardware
would, so the CUDA kernels and their plain torch versions agree bit for
bit with each other and with the JAX reference package.

Rounding: ``torch.round`` and ``np.round`` are both round-half-to-even.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class FxpFormat:
    """Q-format descriptor: ``total_bits`` wide, ``frac_bits`` fractional."""

    total_bits: int
    frac_bits: int
    signed: bool = True

    def __post_init__(self):
        if self.total_bits > 32:
            raise ValueError("raw storage is int32; total_bits must be <= 32")
        if self.frac_bits >= self.total_bits:
            raise ValueError("frac_bits must leave at least one integer bit")

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def resolution(self) -> float:
        return float(2.0 ** (-self.frac_bits))

    @property
    def raw_max(self) -> int:
        return (1 << (self.total_bits - 1)) - 1 if self.signed else (1 << self.total_bits) - 1

    @property
    def raw_min(self) -> int:
        return -(1 << (self.total_bits - 1)) if self.signed else 0

    @property
    def max_value(self) -> float:
        return self.raw_max * self.resolution

    @property
    def min_value(self) -> float:
        return self.raw_min * self.resolution


# The paper's evaluated precisions.
FXP4 = FxpFormat(4, 2)
FXP8 = FxpFormat(8, 4)
FXP16 = FxpFormat(16, 8)
FXP32 = FxpFormat(32, 16)

_BY_BITS = {4: FXP4, 8: FXP8, 16: FXP16, 32: FXP32}


def format_for_bits(bits: int) -> FxpFormat:
    """The paper's format of width ``bits`` (4, 8, 16 or 32)."""
    return _BY_BITS[bits]


def quantize(x: Union[torch.Tensor, float], fmt: FxpFormat,
             rounding: str = "rne") -> torch.Tensor:
    """Real -> raw int32, saturating.  ``rounding``: 'rne' | 'trunc'."""
    # a fresh float32 product, rounded and clipped in place: at lm_head
    # width each extra temporary would be another 2.5 GB
    raw = torch.as_tensor(x, dtype=torch.float32) * fmt.scale
    if rounding == "rne":
        raw.round_()
    elif rounding == "trunc":
        raw.floor_()
    else:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    raw.clamp_(fmt.raw_min, fmt.raw_max)
    out = raw.to(torch.int32)
    if fmt.raw_max > 2 ** 24:
        # float32 holds no 2**31 - 1: the clamp leaves 2**31, whose int32
        # cast is undefined (it wraps on the CPU).  Saturate it, as the
        # reference's float->int convert does.
        out = torch.where(raw >= 2.0 ** 31, _INT32_MAX, out)
    return out


def dequantize(raw: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return raw.to(torch.float32) * fmt.resolution


def saturate(raw: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """Clamp a wide accumulator back into the format's representable range."""
    return torch.clamp(raw, fmt.raw_min, fmt.raw_max).to(torch.int32)


def ashr(raw: torch.Tensor, shift) -> torch.Tensor:
    """Arithmetic shift right — the hardware's 2**-i (toward -inf)."""
    return torch.bitwise_right_shift(raw, shift)


def constant(value: float, fmt: FxpFormat) -> int:
    """Quantized Python-level constant (half-to-even, then clipped)."""
    raw = int(np.round(value * fmt.scale))
    return int(np.clip(raw, fmt.raw_min, fmt.raw_max))


def constant_raw(value: float, frac_bits: int) -> int:
    """Unclamped constant at an arbitrary internal precision (guard bits),
    half-to-even."""
    return int(np.round(value * 2.0 ** frac_bits))


def roundtrip(x: Union[torch.Tensor, float], fmt: FxpFormat,
              rounding: str = "rne") -> torch.Tensor:
    """Quantize-dequantize: the value the hardware actually sees."""
    return dequantize(quantize(x, fmt, rounding), fmt)
