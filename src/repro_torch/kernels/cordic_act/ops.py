"""Public wrapper of the DA-VINCI activation kernel (float frontend):
flatten to 2-D, quantize, raw kernel, dequantize, with a straight-through
backward (the exact function's gradient).

On a CUDA tensor the raw AF is the hand-written kernel of
``csrc/cordic_act.cu``; on a CPU tensor it is the plain torch version of
:mod:`.ref`.  The model's CORDIC AFs do not come here: they are
``core/activations.py``'s float-emulated recurrences, as in the
reference (the two differ by up to 0.06).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import cordic
from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels import common
from repro_torch.kernels.cordic_act.kernel import cordic_act_raw_cuda
from repro_torch.kernels.cordic_act.ref import GUARD_BITS, cordic_act_raw_ref

_EXACT = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "exp": torch.exp}


def cordic_act_raw(x_raw: torch.Tensor, *, af: str, fmt: FxpFormat,
                   n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                   n_div: int = cordic.N_DIVISION_STAGES,
                   guard: int = GUARD_BITS) -> torch.Tensor:
    """Raw int32 AF on the input's device."""
    fn = common.dispatch(SPEC, x_raw)
    return fn(x_raw, af=af, fmt=fmt, n_hyp=n_hyp, n_div=n_div, guard=guard)


def _fwd(x: torch.Tensor, af: str, fmt: FxpFormat, n_hyp: int, n_div: int,
         guard: int) -> torch.Tensor:
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]) if x.dim() != 2 else x
    raw = fxp.quantize(x2, fmt).contiguous()
    out = cordic_act_raw(raw, af=af, fmt=fmt, n_hyp=n_hyp, n_div=n_div,
                         guard=guard)
    return fxp.dequantize(out, fmt).reshape(shape).to(x.dtype)


def cordic_act(x: torch.Tensor, af: str, *, fmt: FxpFormat = fxp.FXP16,
               n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
               n_div: Optional[int] = None,
               guard: int = GUARD_BITS) -> torch.Tensor:
    """tanh / sigmoid / exp through the DA-VINCI kernel, STE gradients."""
    if af not in _EXACT:
        raise ValueError(f"unsupported af {af!r}; kernel AFs: "
                         f"{sorted(_EXACT)} (composites like gelu live in "
                         "core/activations.py)")
    if n_div is None:
        n_div = max(cordic.N_DIVISION_STAGES, fmt.frac_bits + guard)
    f = common.ste(functools.partial(_fwd, af=af, fmt=fmt, n_hyp=n_hyp,
                                     n_div=n_div, guard=guard), _EXACT[af])
    return f(x)


SPEC = common.register(common.KernelSpec(
    name="cordic_act", kernel=cordic_act_raw_cuda, plain=cordic_act_raw_ref,
    replaces="src/repro/kernels/cordic_act/kernel.py:118",
    source="src/repro_torch/kernels/cordic_act/csrc/cordic_act.cu"))
