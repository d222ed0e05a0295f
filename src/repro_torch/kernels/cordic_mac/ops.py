"""Public wrapper of the CORDIC matmul: quantize -> raw kernel -> dequantize,
with a straight-through backward (the exact matmul VJP).

On a CUDA tensor the raw product is the hand-written kernel of
``csrc/cordic_mac.cu``; on a CPU tensor it is the plain torch version of
:mod:`.ref`.  The kernel takes ragged shapes as they are, so nothing is
padded to tiles.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels import common
from repro_torch.kernels.cordic_mac.kernel import cordic_matmul_raw_cuda
from repro_torch.kernels.cordic_mac.ref import cordic_matmul_raw_ref


def cordic_matmul_raw(x_raw: torch.Tensor, w_raw: torch.Tensor, *,
                      fmt: FxpFormat, n_stages: int) -> torch.Tensor:
    """Raw int32 CORDIC matmul on the inputs' device."""
    fn = common.dispatch(SPEC, x_raw, w_raw)
    return fn(x_raw, w_raw, fmt=fmt, n_stages=n_stages)


def _fwd(x: torch.Tensor, w: torch.Tensor, fmt: FxpFormat,
         n_stages: int) -> torch.Tensor:
    out_raw = cordic_matmul_raw(fxp.quantize(x, fmt), fxp.quantize(w, fmt),
                                fmt=fmt, n_stages=n_stages)
    return fxp.dequantize(out_raw, fmt)


def _exact_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def cordic_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  fmt: FxpFormat = fxp.FXP16,
                  n_stages: int = 5) -> torch.Tensor:
    """``x @ w`` through the RPE's 5-stage linear CORDIC (paper §2.2).

    Differentiable via straight-through estimation: forward is the
    bit-accurate shift-add product, backward is the exact matmul VJP.
    """
    f = common.ste(functools.partial(_fwd, fmt=fmt, n_stages=n_stages),
                   _exact_matmul)
    return f(x, w)


SPEC = common.register(common.KernelSpec(
    name="cordic_mac", kernel=cordic_matmul_raw_cuda,
    plain=cordic_matmul_raw_ref,
    replaces="src/repro/kernels/cordic_mac/kernel.py:64",
    source="src/repro_torch/kernels/cordic_mac/csrc/cordic_mac.cu"))
