"""CUDA wrappers of the flash-attention kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_q8.cu``).

``flash_attention_nhd_cuda`` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py`` (``_flash_kernel``, kernel
4): the online-softmax forward with the per-row log-sum-exp.
``flash_attention_bwd_nhd_cuda`` replaces
``repro/kernels/flash_attention/kernel_bwd.py`` (``_dq_kernel`` and
``_dkv_kernel``, kernel 6): the recompute backward, one dQ pass and one
dK/dV pass.  ``flash_attention_q8_nhd_cuda`` replaces
``repro/kernels/flash_attention/kernel_q8.py`` (``_flash_q8_kernel``,
kernel 5): kernel 4's forward over an int8 K/V cache with one float32
scale per (kv head, position), dequantized per tile on chip.  All take
the raw ``(H, S, d)`` layout of the TPU kernels (a batch folded into the
head axes) and the same causal mask, aligned top-left.  Each library is
built with ``nvcc`` at first use, never when this module is imported.

Kernels 5 and 6 run on the tensor cores (bf16 ``mma.sync``, float32
sums) and are planned here, where their scratch is allocated:
:func:`bwd_plan` picks kernel 6's operand planes (a float32 input split
into bf16 hi and lo) and how many parts each kv head's group of q heads
is cut into for the dK/dV pass; :func:`q8_plan` picks kernel 5's block
shape and how many chunks the key axis is cut into at decode.  Both aim
at ``BLOCKS_PER_SM`` blocks on each SM of the card.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref,
                                                     flash_q8_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "flash_common.cuh"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT8 = 3       # flash::kI8, kernel 5's K/V words


class FlashArgs(ctypes.Structure):
    """Mirror of ``FlashArgs`` (flash_common.cuh), field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "q", "k", "v", "dout", "out", "lse", "lse_in", "delta", "dq", "dk",
        "dv")]
        + [(f, ctypes.c_int) for f in (
            "hq", "hkv", "sq", "sk", "d", "group", "causal", "dt_q", "dt_k",
            "dt_v", "dt_do", "dt_out")]
        + [("scale", ctypes.c_float)])


class FlashBwdWork(ctypes.Structure):
    """Mirror of ``FlashBwdWork`` (flash_bwd.cu): kernel 6's scratch and
    plan, from :func:`bwd_plan`."""
    _fields_ = [("planes", ctypes.c_void_p), ("dk_part", ctypes.c_void_p),
                ("dv_part", ctypes.c_void_p), ("np", ctypes.c_int),
                ("ld", ctypes.c_int), ("nsplit", ctypes.c_int)]


def _signatures(entry: str, extra: list):
    return {entry: (ctypes.c_int, [ctypes.POINTER(FlashArgs), *extra,
                                   ctypes.c_int, ctypes.c_void_p]),
            "repro_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int])}


def fwd_library() -> common.BuiltLibrary:
    return common.load_library("flash_fwd", [CSRC / "flash_fwd.cu"],
                               _signatures("flash_forward", []), [HEADER])


def bwd_library() -> common.BuiltLibrary:
    return common.load_library(
        "flash_bwd", [CSRC / "flash_bwd.cu"],
        _signatures("flash_backward", [ctypes.POINTER(FlashBwdWork)]),
        [HEADER])


def q8_library() -> common.BuiltLibrary:
    extra = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    return common.load_library("flash_q8", [CSRC / "flash_q8.cu"],
                               _signatures("flash_forward_q8", extra),
                               [HEADER])


# Blocks the split plans aim for: four on each SM.
BLOCKS_PER_SM = 4
Q8_KEY_TILE = 64        # flash_q8.cu's KT


def padded_dim(d: int) -> int:
    """flash_common.cuh's padded_dim: the kernels' head-width tile."""
    return next(p for p in (32, 64, 128, 256) if d <= p)


def bwd_plan(hq: int, hkv: int, sk: int, d: int, all_bf16: bool,
             aligned: bool, sms: int) -> dict:
    """Kernel 6's plan.  ``np``: bf16 planes an operand, 1 when every
    input is bf16, else a hi and a lo plane; ``planes``: whether a first
    pass writes them, as it must unless every input is bf16 with 16-byte
    rows (``aligned``); ``ld``: the operands' row stride; ``nsplit``: the
    fewest parts of each kv head's group of q heads (a divisor of the
    group) that give the dK/dV pass ``BLOCKS_PER_SM`` blocks an SM, whose
    partial sums a last pass adds."""
    group = hq // hkv
    dp = padded_dim(d)
    rows = 64 if dp <= 128 else 32          # keys a dK/dV block
    chunks = 1 if dp <= 128 else 2          # output column chunks
    base = -(-sk // rows) * hkv * chunks
    nsplit = next((z for z in range(1, group + 1) if group % z == 0
                   and base * z >= BLOCKS_PER_SM * sms), group)
    planes = not (all_bf16 and aligned)
    return {"np": 1 if all_bf16 else 2, "planes": planes,
            "ld": -(-d // 8) * 8 if planes else d, "nsplit": nsplit}


def q8_plan(hkv: int, sq: int, sk: int, group: int, sms: int) -> dict:
    """Kernel 5's plan: ``decode`` when a kv head's Sq * group rows fit
    one m16 tile (16 rows: the decode kernel, whose 4 warps split each
    key tile), else 64 rows a block; and the key axis cut into ``nsplit``
    chunks of ``chunk`` keys (a multiple of the 64-key tile) so that the
    card has ``BLOCKS_PER_SM`` blocks an SM where the rows alone do not
    give it that many; ``grid`` is the main kernel's (row tiles, kv
    heads, nsplit)."""
    rows = sq * group
    decode = rows <= 16
    row_tiles = max(1, -(-rows // (16 if decode else 64)))
    tiles = max(1, -(-sk // Q8_KEY_TILE))
    want = -(-BLOCKS_PER_SM * sms // (row_tiles * hkv))
    nsplit = max(1, min(want, tiles))
    chunk = -(-tiles // nsplit) * Q8_KEY_TILE
    nsplit = max(1, -(-sk // chunk))
    return {"decode": decode, "nsplit": nsplit, "chunk": chunk,
            "grid": (row_tiles, hkv, nsplit)}


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _args(q, k, v, causal: bool, group: int, kv_dtypes=_DTYPES
          ) -> FlashArgs:
    hq, sq, d = q.shape
    hkv, sk, _ = k.shape
    if hq != group * hkv:
        raise ValueError(f"flash_attention: hq={hq} != group={group} * "
                         f"hkv={hkv}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {d}; the kernels take "
                         f"1..{MAX_HEAD_DIM}")
    _check("q", q, (hq, sq, d), _DTYPES)
    _check("k", k, (hkv, sk, d), kv_dtypes)
    _check("v", v, (hkv, sk, d), kv_dtypes)
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("flash_attention: inputs lie on different devices")
    return FlashArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), hq=hq, hkv=hkv,
        sq=sq, sk=sk, d=d, group=group, causal=int(causal),
        dt_q=_DTYPES[q.dtype], dt_k=_DTYPES.get(k.dtype, _INT8),
        dt_v=_DTYPES.get(v.dtype, _INT8),
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
    hkv, sk, _ = k.shape
    _check("do", do, tuple(q.shape), _DTYPES)
    _check("lse", lse, (hq, sq), (torch.float32,))
    _check("delta", delta, (hq, sq), (torch.float32,))
    dev = q.device
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    alloc = torch.zeros if sq == 0 else torch.empty
    dk = alloc(k.shape, dtype=torch.float32, device=dev)
    dv = alloc(k.shape, dtype=torch.float32, device=dev)
    inputs = (q, k, v, do)
    plan = bwd_plan(hq, hkv, sk, d,
                    all(x.dtype == torch.bfloat16 for x in inputs),
                    d % 8 == 0 and all(x.data_ptr() % 16 == 0
                                       for x in inputs), _sms(dev.index))
    work = FlashBwdWork(np=plan["np"], ld=plan["ld"], nsplit=plan["nsplit"])
    keep = []                         # scratch, alive until the launch
    if plan["planes"]:
        n = plan["np"] * plan["ld"] * 2 * (hq * sq + hkv * sk)
        keep.append(torch.empty(n, dtype=torch.bfloat16, device=dev))
        work.planes = keep[-1].data_ptr()
    if plan["nsplit"] > 1:
        keep += [torch.empty((plan["nsplit"], *k.shape), dtype=torch.float32,
                             device=dev) for _ in range(2)]
        work.dk_part, work.dv_part = (t.data_ptr() for t in keep[-2:])
    args.dout, args.dt_do = do.data_ptr(), _DTYPES[do.dtype]
    args.lse_in, args.delta = lse.data_ptr(), delta.data_ptr()
    args.dq, args.dk, args.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    lib = bwd_library().lib
    err = lib.flash_backward(ctypes.byref(args), ctypes.byref(work),
                             dev.index, common.stream_ptr(dev))
    common.check_cuda(lib, err, "flash_attention backward launch")
    FLASH_BWD.launches += 1
    return dq, dk, dv


def flash_attention_q8_nhd_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, *, causal: bool = True,
                                group: int = 1) -> torch.Tensor:
    """q (Hq, Sq, d) float; k/v (Hkv, Sk, d) int8 with float32 scales
    (Hkv, Sk), one per cached vector -> out (Hq, Sq, d) in q's dtype.
    Forward only, as the TPU kernel."""
    args = _args(q, k, v, causal, group, kv_dtypes=(torch.int8,))
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, s, tuple(k.shape[:2]), (torch.float32,))
        if s.device != q.device:
            raise ValueError(f"flash_attention_q8: {name} lies on "
                             f"{s.device}, q on {q.device}")
    out = torch.empty_like(q)
    args.out, args.dt_out = out.data_ptr(), _DTYPES[q.dtype]
    hkv, sk, d = k.shape
    plan = q8_plan(hkv, q.shape[1], sk, group, _sms(q.device.index))
    part = None
    if plan["nsplit"] > 1:            # (m, l, acc) of each key chunk
        part = torch.empty(plan["nsplit"] * hkv * q.shape[1] * group
                           * (d + 2), dtype=torch.float32, device=q.device)
    lib = q8_library().lib
    err = lib.flash_forward_q8(
        ctypes.byref(args), common.ptr(k_scale), common.ptr(v_scale),
        None if part is None else common.ptr(part), int(plan["decode"]),
        plan["chunk"], plan["nsplit"], q.device.index,
        common.stream_ptr(q.device))
    common.check_cuda(lib, err, "flash_attention_q8 launch")
    FLASH_Q8.launches += 1
    return out


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


FLASH_Q8 = common.register(common.KernelSpec(
    name="flash_attention_q8", kernel=flash_attention_q8_nhd_cuda,
    plain=flash_q8_ref,
    replaces="src/repro/kernels/flash_attention/kernel_q8.py:81",
    source="src/repro_torch/kernels/flash_attention/csrc/flash_q8.cu"))
