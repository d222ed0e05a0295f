"""CUDA wrapper of the output-stationary CORDIC matmul (``csrc/cordic_mac.cu``).

The kernel replaces the TPU kernel ``repro/kernels/cordic_mac/kernel.py``
(``_mac_kernel``): an int32 matmul in which every multiply is the n-stage
linear-CORDIC shift-add, bit-exact against :mod:`.ref`.  The library is
built with ``nvcc`` at first use (see :func:`repro_torch.kernels.common.
load_library`); nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.fixed_point import FxpFormat
from repro_torch.kernels import common
from repro_torch.kernels.cordic_mac.ref import stage_constants

SOURCE = Path(__file__).resolve().parent / "csrc" / "cordic_mac.cu"

SIGNATURES = {
    "cordic_mac_raw": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> common.BuiltLibrary:
    return common.load_library("cordic_mac", [SOURCE], SIGNATURES)


@functools.lru_cache(maxsize=128)
def _stage_array(fmt: FxpFormat, n_stages: int) -> ctypes.Array:
    """E_i as a host int32 array, read (never written) by the C side."""
    return (ctypes.c_int32 * n_stages)(*stage_constants(fmt, n_stages))


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"cordic_mac: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"cordic_mac: {name} must be int32 raw words, got "
                         f"{t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"cordic_mac: {name} must be 2-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"cordic_mac: {name} must be contiguous")


def cordic_matmul_raw_cuda(x_raw: torch.Tensor, w_raw: torch.Tensor, *,
                           fmt: FxpFormat, n_stages: int) -> torch.Tensor:
    """(M, K) @ (K, N) raw int32 -> (M, N) int32 on the card."""
    _check("x_raw", x_raw)
    _check("w_raw", w_raw)
    m, k = x_raw.shape
    k2, n = w_raw.shape
    if k != k2:
        raise ValueError(f"cordic_mac: inner dims differ: {tuple(x_raw.shape)}"
                         f" @ {tuple(w_raw.shape)}")
    if x_raw.device != w_raw.device:
        raise ValueError(f"cordic_mac: x_raw on {x_raw.device}, w_raw on "
                         f"{w_raw.device}")
    e_host = _stage_array(fmt, n_stages)
    lib = library().lib
    # zero-filled: blocks that split K add their partial sums into it
    out = torch.zeros((m, n), dtype=torch.int32, device=x_raw.device)
    err = lib.cordic_mac_raw(common.ptr(x_raw), common.ptr(w_raw),
                             common.ptr(out), m, n, k, e_host, n_stages,
                             x_raw.device.index,
                             common.stream_ptr(x_raw.device))
    common.check_cuda(lib, err, "cordic_mac launch")
    common.get_kernel("cordic_mac").launches += 1
    return out
