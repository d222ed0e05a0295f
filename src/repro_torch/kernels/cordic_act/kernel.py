"""CUDA wrapper of the DA-VINCI activation kernel (``csrc/cordic_act.cu``).

The kernel replaces the TPU kernel ``repro/kernels/cordic_act/kernel.py``
(``_act_kernel``): elementwise tanh / sigmoid / exp on raw int32 words,
bit-exact against :mod:`.ref`.  Its constants (:class:`AfParams`) are
computed here, on the host, with ``constant_raw``; the library is built
with ``nvcc`` at first use, never when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.core import cordic
from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels import common
from repro_torch.kernels.cordic_act.ref import (EXP_ARG_CLAMP, LN2,
                                                check_config)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "cordic_act.cu"
HEADER = CSRC / "cordic_af.cuh"

MAX_ITERS = 32                      # kMaxIters in cordic_af.cuh
_AF_CODES = {"exp": 0, "tanh": 1, "sigmoid": 2}


class AfParams(ctypes.Structure):
    """Mirror of ``cordic_af::AfParams`` (cordic_af.cuh), field for field."""
    _fields_ = [(f, ctypes.c_int32) for f in (
        "af", "guard", "fb", "one", "clamp", "cap", "inv_ln2", "ln2",
        "inv_gain", "n_hyp", "n_div")] + [
        (f, ctypes.c_int32 * MAX_ITERS) for f in ("shift", "atanh_e",
                                                  "div_e")]


@functools.lru_cache(maxsize=64)
def af_params(af: str, fmt: FxpFormat, n_hyp: int, n_div: int,
              guard: int) -> AfParams:
    """Every constant of one configuration, half-to-even at Q(frac+G)."""
    check_config(af, fmt, guard)
    for name, n in (("n_hyp", n_hyp), ("n_div", n_div)):
        if not 0 <= n <= MAX_ITERS:
            raise ValueError(f"{name} must be in [0, {MAX_ITERS}], got {n}")
    fb = fmt.frac_bits + guard
    shifts = cordic.hyperbolic_sequence(n_hyp)
    p = AfParams(
        af=_AF_CODES[af], guard=guard, fb=fb, one=1 << fb,
        clamp=fxp.constant_raw(EXP_ARG_CLAMP, fb),
        cap=fxp.constant_raw(min(4.0, fmt.max_value / 2.0 - fmt.resolution),
                             fb),
        inv_ln2=fxp.constant_raw(1.0 / LN2, fb),
        ln2=fxp.constant_raw(LN2, fb),
        inv_gain=fxp.constant_raw(1.0 / cordic.hyperbolic_gain(n_hyp), fb),
        n_hyp=n_hyp, n_div=n_div)
    for i, s in enumerate(shifts):
        p.shift[i] = s
        p.atanh_e[i] = fxp.constant_raw(math.atanh(2.0 ** (-s)), fb)
    for i in range(n_div):
        p.div_e[i] = fxp.constant_raw(2.0 ** (-i), fb)
    return p


SIGNATURES = {
    "cordic_act_raw": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(AfParams), ctypes.c_int, ctypes.c_void_p]),
    "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> common.BuiltLibrary:
    return common.load_library("cordic_act", [SOURCE], SIGNATURES,
                               headers=[HEADER])


def check_raw(family: str, t: torch.Tensor) -> None:
    """The kernels take contiguous 2-D int32 words on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{family}: x_raw must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{family}: x_raw must be int32 raw words, got "
                         f"{t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{family}: x_raw must be 2-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{family}: x_raw must be contiguous")


def cordic_act_raw_cuda(x_raw: torch.Tensor, *, af: str, fmt: FxpFormat,
                        n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                        n_div: int = cordic.N_DIVISION_STAGES,
                        guard: int = 4) -> torch.Tensor:
    """(R, C) raw int32 -> (R, C) int32 on the card, any R and C."""
    check_raw("cordic_act", x_raw)
    params = af_params(af, fmt, n_hyp, n_div, guard)
    lib = library().lib
    out = torch.empty_like(x_raw)
    err = lib.cordic_act_raw(common.ptr(x_raw), common.ptr(out),
                             x_raw.numel(), ctypes.byref(params),
                             x_raw.device.index,
                             common.stream_ptr(x_raw.device))
    common.check_cuda(lib, err, "cordic_act launch")
    common.get_kernel("cordic_act").launches += 1
    return out
