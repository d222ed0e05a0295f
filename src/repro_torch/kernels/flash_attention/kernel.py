"""CUDA wrappers of the flash-attention kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``).

``flash_attention_nhd_cuda`` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py`` (``_flash_kernel``, kernel
4): the online-softmax forward with the per-row log-sum-exp.
``flash_attention_bwd_nhd_cuda`` replaces
``repro/kernels/flash_attention/kernel_bwd.py`` (``_dq_kernel`` and
``_dkv_kernel``, kernel 6): the recompute backward, one dQ pass and one
dK/dV pass.  Both take the raw ``(H, S, d)`` layout of the TPU kernels
(a batch folded into the head axes) and the same causal mask, aligned
top-left.  Each library is built with ``nvcc`` at first use, never when
this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

CSRC = Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "flash_common.cuh"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class FlashArgs(ctypes.Structure):
    """Mirror of ``FlashArgs`` (flash_common.cuh), field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "q", "k", "v", "dout", "out", "lse", "lse_in", "delta", "dq", "dk",
        "dv")]
        + [(f, ctypes.c_int) for f in (
            "hq", "hkv", "sq", "sk", "d", "group", "causal", "dt_q", "dt_k",
            "dt_v", "dt_do", "dt_out")]
        + [("scale", ctypes.c_float)])


def _signatures(entry: str):
    return {entry: (ctypes.c_int, [ctypes.POINTER(FlashArgs), ctypes.c_int,
                                   ctypes.c_void_p]),
            "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int])}


def fwd_library() -> common.BuiltLibrary:
    return common.load_library("flash_fwd", [CSRC / "flash_fwd.cu"],
                               _signatures("flash_forward"), [HEADER])


def bwd_library() -> common.BuiltLibrary:
    return common.load_library("flash_bwd", [CSRC / "flash_bwd.cu"],
                               _signatures("flash_backward"), [HEADER])


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} must be a CUDA tensor, "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; the "
                         f"kernel takes {sorted(map(str, dtypes))}")
    if tuple(t.shape) != shape:
        raise ValueError(f"flash_attention: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous")


def _args(q, k, v, causal: bool, group: int) -> FlashArgs:
    hq, sq, d = q.shape
    hkv, sk, _ = k.shape
    if hq != group * hkv:
        raise ValueError(f"flash_attention: hq={hq} != group={group} * "
                         f"hkv={hkv}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {d}; the kernels take "
                         f"1..{MAX_HEAD_DIM}")
    _check("q", q, (hq, sq, d), _DTYPES)
    _check("k", k, (hkv, sk, d), _DTYPES)
    _check("v", v, (hkv, sk, d), _DTYPES)
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("flash_attention: inputs lie on different devices")
    return FlashArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), hq=hq, hkv=hkv,
        sq=sq, sk=sk, d=d, group=group, causal=int(causal),
        dt_q=_DTYPES[q.dtype], dt_k=_DTYPES[k.dtype], dt_v=_DTYPES[v.dtype],
        scale=float(np.float32(1.0 / (d ** 0.5))))


def flash_attention_nhd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             group: int = 1, return_residuals: bool = False):
    """q (Hq, Sq, d), k/v (Hkv, Sk, d) -> out (Hq, Sq, d) in q's dtype;
    with ``return_residuals`` also the per-row lse (Hq, Sq) float32."""
    args = _args(q, k, v, causal, group)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if return_residuals else None)
    args.out, args.dt_out = out.data_ptr(), _DTYPES[q.dtype]
    args.lse = None if lse is None else lse.data_ptr()
    lib = fwd_library().lib
    err = lib.flash_forward(ctypes.byref(args), q.device.index,
                            common.stream_ptr(q.device))
    common.check_cuda(lib, err, "flash_attention forward launch")
    FLASH.launches += 1
    return (out, lse) if return_residuals else out


def flash_attention_bwd_nhd_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor, *,
                                 causal: bool = True, group: int = 1
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The fused backward: float32 ``(dq (Hq, Sq, d), dk, dv (Hkv, Sk,
    d))``, dk/dv summed over each kv head's group."""
    args = _args(q, k, v, causal, group)
    hq, sq, d = q.shape
    _check("do", do, tuple(q.shape), _DTYPES)
    _check("lse", lse, (hq, sq), (torch.float32,))
    _check("delta", delta, (hq, sq), (torch.float32,))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    alloc = torch.zeros if sq == 0 else torch.empty
    dk = alloc(k.shape, dtype=torch.float32, device=q.device)
    dv = alloc(k.shape, dtype=torch.float32, device=q.device)
    args.dout, args.dt_do = do.data_ptr(), _DTYPES[do.dtype]
    args.lse_in, args.delta = lse.data_ptr(), delta.data_ptr()
    args.dq, args.dk, args.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    lib = bwd_library().lib
    err = lib.flash_backward(ctypes.byref(args), q.device.index,
                             common.stream_ptr(q.device))
    common.check_cuda(lib, err, "flash_attention backward launch")
    FLASH_BWD.launches += 1
    return dq, dk, dv


def _fwd_plain(q, k, v, *, causal: bool = True, group: int = 1,
               return_residuals: bool = False):
    out, lse = flash_fwd_ref(q, k, v, causal=causal, group=group)
    return (out, lse) if return_residuals else out


FLASH = common.register(common.KernelSpec(
    name="flash_attention", kernel=flash_attention_nhd_cuda,
    plain=_fwd_plain,
    replaces="src/repro/kernels/flash_attention/kernel.py:82",
    source="src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"))

FLASH_BWD = common.register(common.KernelSpec(
    name="flash_attention_bwd", kernel=flash_attention_bwd_nhd_cuda,
    plain=flash_bwd_ref,
    replaces="src/repro/kernels/flash_attention/kernel_bwd.py:141",
    source="src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu"))

