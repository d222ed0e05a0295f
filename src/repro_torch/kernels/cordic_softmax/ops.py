"""Public wrapper of the CORDIC softmax kernel (float frontend): subtract
the float row max, quantize, raw kernel, dequantize, with a
straight-through backward (the exact softmax's gradient).

On a CUDA tensor the raw softmax is the hand-written kernel of
``csrc/cordic_softmax.cu``; on a CPU tensor it is the plain torch version
of :mod:`.ref`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import cordic
from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels import common
from repro_torch.kernels.cordic_act.ref import GUARD_BITS
from repro_torch.kernels.cordic_softmax.kernel import cordic_softmax_raw_cuda
from repro_torch.kernels.cordic_softmax.ref import cordic_softmax_raw_ref


def cordic_softmax_raw(x_raw: torch.Tensor, *, fmt: FxpFormat,
                       n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                       n_div: int = cordic.N_DIVISION_STAGES,
                       guard: int = GUARD_BITS) -> torch.Tensor:
    """Raw int32 row softmax on the input's device."""
    fn = common.dispatch(SPEC, x_raw)
    return fn(x_raw, fmt=fmt, n_hyp=n_hyp, n_div=n_div, guard=guard)


def _fwd(x: torch.Tensor, fmt: FxpFormat, n_hyp: int, n_div: int,
         guard: int) -> torch.Tensor:
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    # softmax(x) == softmax(x - max): only the differences are quantized,
    # and the kernel subtracts its own integer max again
    x2 = x2 - torch.amax(x2, dim=-1, keepdim=True).detach()
    out = cordic_softmax_raw(fxp.quantize(x2, fmt).contiguous(), fmt=fmt,
                             n_hyp=n_hyp, n_div=n_div, guard=guard)
    return fxp.dequantize(out, fmt).reshape(shape).to(x.dtype)


def _exact_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def cordic_softmax(x: torch.Tensor, *, fmt: FxpFormat = fxp.FXP16,
                   n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                   n_div: Optional[int] = None,
                   guard: int = GUARD_BITS) -> torch.Tensor:
    """Row softmax over the last axis through the RPE FIFO datapath, STE
    gradients."""
    if n_div is None:
        n_div = max(cordic.N_DIVISION_STAGES, fmt.frac_bits + guard)
    f = common.ste(functools.partial(_fwd, fmt=fmt, n_hyp=n_hyp,
                                     n_div=n_div, guard=guard),
                   _exact_softmax)
    return f(x)


SPEC = common.register(common.KernelSpec(
    name="cordic_softmax", kernel=cordic_softmax_raw_cuda,
    plain=cordic_softmax_raw_ref,
    replaces="src/repro/kernels/cordic_softmax/kernel.py:47",
    source="src/repro_torch/kernels/cordic_softmax/csrc/cordic_softmax.cu"))
