"""CUDA wrappers of the wkv kernels (``csrc/wkv.cu``).

``wkv_recurrence_cuda`` replaces the TPU kernel
``repro/kernels/wkv/kernel.py`` (``_wkv_kernel``, kernel 7), the RWKV6
recurrence from a zero state, with ``return_residuals`` also the state at
the start of every block of ``block_t`` steps; ``wkv_recurrence_bwd_cuda``
(``csrc/wkv_bwd.cu``) replaces ``repro/kernels/wkv/kernel_bwd.py``
(``_wkv_bwd_kernel``, kernel 9), the reverse-time adjoint sweep that
recomputes each block's states from those checkpoints;
``wkv_recurrence_q8_cuda`` replaces
``repro/kernels/wkv/kernel_q8.py`` (``_wkv_q8_kernel``), the same from an
int8 state with per-row float32 scales, requantized in the kernel.  All
take the raw ``(BH, T, d)`` layout and agree with :mod:`.ref` word for
word on the state.  The library is built with ``nvcc`` at first use,
never when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.wkv.ref import (wkv_q8_ref, wkv_recurrence_bwd_ref,
                                        wkv_recurrence_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
BWD_SOURCE = SOURCE.with_name("wkv_bwd.cu")
HEAD_DIMS = (8, 16, 32, 64)          # the kernel's instantiated dk == dv
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INV_127 = float(np.float32(1.0 / 127.0))


class WkvArgs(ctypes.Structure):
    """Mirror of ``WkvArgs`` (wkv.cu), field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "r", "k", "v", "w", "u", "out", "s0", "s0_scale", "s_q",
        "s_scale", "ckpt")]
        + [("t_len", ctypes.c_longlong), ("block_t", ctypes.c_longlong),
           ("rows", ctypes.c_int)]
        + [(f, ctypes.c_int) for f in ("dt_r", "dt_k", "dt_v", "dt_w",
                                       "dt_u", "dt_out")]
        + [("inv127", ctypes.c_float)])


class WkvBwdArgs(ctypes.Structure):
    """Mirror of ``WkvBwdArgs`` (wkv_bwd.cu), field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "r", "k", "v", "w", "u", "dy", "ckpt", "scratch", "dr", "dk", "dv",
        "dw", "du")]
        + [("t_len", ctypes.c_longlong), ("block_t", ctypes.c_longlong),
           ("rows", ctypes.c_int)]
        + [(f, ctypes.c_int) for f in ("dt_r", "dt_k", "dt_v", "dt_w",
                                       "dt_u", "dt_dy")])


SIGNATURES = {
    "wkv_forward": (ctypes.c_int, [
        ctypes.POINTER(WkvArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


BWD_SIGNATURES = {
    "wkv_backward": (ctypes.c_int, [
        ctypes.POINTER(WkvBwdArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def library() -> common.BuiltLibrary:
    return common.load_library("wkv", [SOURCE], SIGNATURES)


def bwd_library() -> common.BuiltLibrary:
    return common.load_library("wkv_bwd", [BWD_SOURCE], BWD_SIGNATURES)


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"wkv: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"wkv: {name} has dtype {t.dtype}; the kernel takes "
                         f"{sorted(map(str, dtypes))}")
    if tuple(t.shape) != shape:
        raise ValueError(f"wkv: {name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"wkv: {name} must be contiguous")


def _check_inputs(r, k, v, w, u) -> None:
    bh, t, dk = r.shape
    dv = v.shape[-1]
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"wkv: dk={dk}, dv={dv}; the kernel takes dk == dv "
                         f"in {HEAD_DIMS}")
    for name, x, shape in (("r", r, (bh, t, dk)), ("k", k, (bh, t, dk)),
                           ("v", v, (bh, t, dv)), ("w", w, (bh, t, dk)),
                           ("u", u, (bh, dk))):
        _check(name, x, shape, _DTYPES)
    if len({x.device for x in (r, k, v, w, u)}) != 1:
        raise ValueError("wkv: inputs lie on different devices")


def _launch(r, k, v, w, u, q8=None, block_t: int = 0
            ) -> Tuple[torch.Tensor, ...]:
    _check_inputs(r, k, v, w, u)
    bh, t, dk = r.shape
    dv = v.shape[-1]
    out = torch.empty((bh, t, dv), dtype=r.dtype, device=r.device)
    args = WkvArgs(
        r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), w=w.data_ptr(),
        u=u.data_ptr(), out=out.data_ptr(), t_len=t, rows=bh,
        dt_r=_DTYPES[r.dtype], dt_k=_DTYPES[k.dtype], dt_v=_DTYPES[v.dtype],
        dt_w=_DTYPES[w.dtype], dt_u=_DTYPES[u.dtype],
        dt_out=_DTYPES[r.dtype], inv127=_INV_127)
    results: Tuple[torch.Tensor, ...] = (out,)
    if block_t:
        ckpt = torch.empty((bh, t // block_t, dk, dv), dtype=torch.float32,
                           device=r.device)
        args.ckpt, args.block_t = ckpt.data_ptr(), block_t
        results = (out, ckpt)
    if q8 is not None:
        s0, s0_scale = q8
        _check("state", s0, (bh, dk, dv), (torch.int8,))
        _check("state_scale", s0_scale, (bh, dk), (torch.float32,))
        s_q = torch.empty_like(s0)
        s_scale = torch.empty_like(s0_scale)
        args.s0, args.s0_scale = s0.data_ptr(), s0_scale.data_ptr()
        args.s_q, args.s_scale = s_q.data_ptr(), s_scale.data_ptr()
        results = (out, s_q, s_scale)
    lib = library().lib
    err = lib.wkv_forward(ctypes.byref(args), dk, dv, int(q8 is not None),
                          r.device.index, common.stream_ptr(r.device))
    common.check_cuda(lib, err, "wkv launch")
    return results


def wkv_recurrence_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, *,
                        block_t: int = 64, return_residuals: bool = False):
    """r/k/w (BH, T, dk), v (BH, T, dv), u (BH, dk) -> (BH, T, dv) in r's
    dtype, from a zero state, on the card.  With ``return_residuals`` also
    the float32 checkpoints (BH, T / block_t, dk, dv), the state at the
    start of every block of ``block_t`` steps (``block_t`` divides T)."""
    if return_residuals:
        common.check_block(r.shape[1], block_t, "wkv checkpoints")
    res = _launch(r, k, v, w, u, block_t=block_t if return_residuals else 0)
    WKV.launches += 1
    return res if return_residuals else res[0]


def wkv_recurrence_bwd_cuda(r: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, w: torch.Tensor,
                            u: torch.Tensor, dy: torch.Tensor,
                            ckpt: torch.Tensor, *, block_t: int = 64
                            ) -> Tuple[torch.Tensor, ...]:
    """The fused backward on the card: float32 ``(dr, dk, dv, dw, du)``,
    du (BH, dk).  ``ckpt`` comes from the forward with the same
    ``block_t``."""
    _check_inputs(r, k, v, w, u)
    bh, t, dk = r.shape
    dv = v.shape[-1]
    common.check_block(t, block_t, "wkv backward")
    bt = block_t
    _check("dy", dy, (bh, t, dv), _DTYPES)
    _check("ckpt", ckpt, (bh, t // bt, dk, dv), (torch.float32,))
    f32 = dict(dtype=torch.float32, device=r.device)
    scratch = torch.empty((bh, bt, dv, dk), **f32)
    dr, dk_, dw = (torch.empty((bh, t, dk), **f32) for _ in range(3))
    dv_ = torch.empty((bh, t, dv), **f32)
    du = torch.empty((bh, dk), **f32)
    args = WkvBwdArgs(
        r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), w=w.data_ptr(),
        u=u.data_ptr(), dy=dy.data_ptr(), ckpt=ckpt.data_ptr(),
        scratch=scratch.data_ptr(), dr=dr.data_ptr(), dk=dk_.data_ptr(),
        dv=dv_.data_ptr(), dw=dw.data_ptr(), du=du.data_ptr(), t_len=t,
        block_t=bt, rows=bh, dt_r=_DTYPES[r.dtype], dt_k=_DTYPES[k.dtype],
        dt_v=_DTYPES[v.dtype], dt_w=_DTYPES[w.dtype], dt_u=_DTYPES[u.dtype],
        dt_dy=_DTYPES[dy.dtype])
    lib = bwd_library().lib
    err = lib.wkv_backward(ctypes.byref(args), dk, dv, r.device.index,
                           common.stream_ptr(r.device))
    common.check_cuda(lib, err, "wkv backward launch")
    WKV_BWD.launches += 1
    return dr, dk_, dv_, dw, du


def wkv_recurrence_q8_cuda(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           s0: torch.Tensor, s0_scale: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """As :func:`wkv_recurrence_cuda` from the int8 state ``s0`` (BH, dk,
    dv) with float32 row scales (BH, dk); returns ``(out, state int8,
    scale float32)``, the final state requantized in the kernel."""
    res = _launch(r, k, v, w, u, q8=(s0, s0_scale))
    WKV_Q8.launches += 1
    return res


WKV = common.register(common.KernelSpec(
    name="wkv", kernel=wkv_recurrence_cuda, plain=wkv_recurrence_ref,
    replaces="src/repro/kernels/wkv/kernel.py:66",
    source="src/repro_torch/kernels/wkv/csrc/wkv.cu"))

WKV_BWD = common.register(common.KernelSpec(
    name="wkv_bwd", kernel=wkv_recurrence_bwd_cuda,
    plain=wkv_recurrence_bwd_ref,
    replaces="src/repro/kernels/wkv/kernel_bwd.py:96",
    source="src/repro_torch/kernels/wkv/csrc/wkv_bwd.cu"))

WKV_Q8 = common.register(common.KernelSpec(
    name="wkv_q8", kernel=wkv_recurrence_q8_cuda, plain=wkv_q8_ref,
    replaces="src/repro/kernels/wkv/kernel_q8.py:69",
    source="src/repro_torch/kernels/wkv/csrc/wkv.cu"))
