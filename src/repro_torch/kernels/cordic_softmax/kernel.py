"""CUDA wrapper of the CORDIC softmax kernel (``csrc/cordic_softmax.cu``).

The kernel replaces the TPU kernel
``repro/kernels/cordic_softmax/kernel.py`` (``_softmax_kernel``): a row
softmax on raw int32 words, bit-exact against :mod:`.ref`.  It shares the
integer datapath and the host-computed constants of ``cordic_act``; the
library is built with ``nvcc`` at first use, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import cordic
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels import common
from repro_torch.kernels.cordic_act.kernel import (HEADER, AfParams,
                                                   af_params, check_raw)

SOURCE = Path(__file__).resolve().parent / "csrc" / "cordic_softmax.cu"

SIGNATURES = {
    "cordic_softmax_raw": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(AfParams), ctypes.c_int, ctypes.c_void_p]),
    "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

_INT_MAX = 2 ** 31 - 1


def library() -> common.BuiltLibrary:
    return common.load_library("cordic_softmax", [SOURCE], SIGNATURES,
                               headers=[HEADER])


def cordic_softmax_raw_cuda(x_raw: torch.Tensor, *, fmt: FxpFormat,
                            n_hyp: int = cordic.N_HYPERBOLIC_STAGES,
                            n_div: int = cordic.N_DIVISION_STAGES,
                            guard: int = 4) -> torch.Tensor:
    """Row softmax of (R, C) raw int32 -> (R, C) int32 on the card."""
    check_raw("cordic_softmax", x_raw)
    rows, cols = x_raw.shape
    if rows > _INT_MAX or cols > _INT_MAX:
        raise ValueError(f"cordic_softmax: shape {tuple(x_raw.shape)} "
                         f"exceeds the int32 grid")
    params = af_params("exp", fmt, n_hyp, n_div, guard)
    lib = library().lib
    out = torch.empty_like(x_raw)
    err = lib.cordic_softmax_raw(common.ptr(x_raw), common.ptr(out), rows,
                                 cols, ctypes.byref(params),
                                 x_raw.device.index,
                                 common.stream_ptr(x_raw.device))
    common.check_cuda(lib, err, "cordic_softmax launch")
    common.get_kernel("cordic_softmax").launches += 1
    return out
