"""Public wrappers of the flash-attention kernels on the ``(B, S, H, d)``
GQA layout: :func:`flash_attention`, differentiable through the fused
backward, and :func:`flash_attention_q8` over an int8 K/V cache,
forward only.

On CUDA tensors the forward is kernel 4 (``csrc/flash_fwd.cu``), the
backward kernel 6 (``csrc/flash_bwd.cu``) and the int8-cache forward
kernel 5 (``csrc/flash_q8.cu``); on CPU tensors they are their plain
torch versions (:mod:`.ref`).  ``REPRO_FUSED_BWD=0`` puts the backward on
the exact VJP of the materialised float reference, as in the JAX package.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.kernel import (FLASH, FLASH_BWD,
                                                        FLASH_Q8)
from repro_torch.kernels.flash_attention.ref import attention_nhd_ref


def flash_attention_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, group: int = 1,
                        return_residuals: bool = False):
    """Kernel 4 on the raw ``(H, S, d)`` layout, on the inputs' device."""
    fn = common.dispatch(FLASH, q, k, v)
    return fn(q, k, v, causal=causal, group=group,
              return_residuals=return_residuals)


def flash_attention_bwd_nhd(q, k, v, do, lse, delta, *, causal: bool = True,
                            group: int = 1):
    """Kernel 6 on the raw layout, on the inputs' device."""
    fn = common.dispatch(FLASH_BWD, q, k, v, do, lse, delta)
    return fn(q, k, v, do, lse, delta, causal=causal, group=group)


def flash_attention_q8_nhd(q, k, v, k_scale, v_scale, *, causal: bool = True,
                           group: int = 1) -> torch.Tensor:
    """Kernel 5 on the raw layout, on the inputs' device."""
    fn = common.dispatch(FLASH_Q8, q, k, v, k_scale, v_scale)
    return fn(q, k, v, k_scale, v_scale, causal=causal, group=group)


def _to_hsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) -> (B * H, S, d), contiguous."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _to_hs(s: torch.Tensor) -> torch.Tensor:
    """Per-vector scales (B, S, H) -> (B * H, S) float32, contiguous."""
    return s.transpose(1, 2).reshape(-1, s.shape[1]).to(
        torch.float32).contiguous()


def _from_hsd(x: torch.Tensor, b: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def _fwd(q, k, v, *, causal: bool):
    b, group = q.shape[0], q.shape[2] // k.shape[2]
    out = flash_attention_nhd(_to_hsd(q), _to_hsd(k), _to_hsd(v),
                              causal=causal, group=group)
    return _from_hsd(out, b)


def _fwd_res(q, k, v, *, causal: bool):
    b, group = q.shape[0], q.shape[2] // k.shape[2]
    out, lse = flash_attention_nhd(_to_hsd(q), _to_hsd(k), _to_hsd(v),
                                   causal=causal, group=group,
                                   return_residuals=True)
    out = _from_hsd(out, b)
    return out, (q, k, v, out, lse)


def _bwd(res, do, *, causal: bool):
    """The fused backward on the public layout; cotangents in the primal
    dtypes.  ``delta = rowsum(dO ⊙ O)`` is one torch reduction here, as
    the reference's wrapper computes it in jnp."""
    q, k, v, o, lse = res
    b, group = q.shape[0], q.shape[2] // k.shape[2]
    delta = torch.einsum("bshd,bshd->bhs", do.to(torch.float32),
                         o.to(torch.float32)).reshape(lse.shape)
    dq, dk, dv = flash_attention_bwd_nhd(
        _to_hsd(q), _to_hsd(k), _to_hsd(v), _to_hsd(do.contiguous()), lse,
        delta.contiguous(), causal=causal, group=group)
    return (_from_hsd(dq, b).to(q.dtype), _from_hsd(dk, b).to(k.dtype),
            _from_hsd(dv, b).to(v.dtype))


def exact_attention(q, k, v, *, causal: bool):
    """The materialised-scores float reference on the (B, S, H, d)
    layout: the backward under ``REPRO_FUSED_BWD=0``."""
    b, group = q.shape[0], q.shape[2] // k.shape[2]
    out = attention_nhd_ref(_to_hsd(q), _to_hsd(k), _to_hsd(v),
                            causal=causal, group=group)
    return _from_hsd(out, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, d); k/v: (B, Sk, Hkv, d).  Returns (B, Sq, Hq, d).

    Differentiable: the forward also emits the per-row log-sum-exp and
    the backward is the fused recompute kernel pair, or the exact VJP of
    the materialised float reference when ``REPRO_FUSED_BWD=0``.  The
    kernels tile for themselves; the reference's ``block_q``/``block_k``
    have no counterpart here.
    """
    fn = common.fused_vjp(
        functools.partial(_fwd, causal=causal),
        functools.partial(exact_attention, causal=causal),
        functools.partial(_fwd_res, causal=causal),
        functools.partial(_bwd, causal=causal), spec=FLASH_BWD)
    return fn(q, k, v)


def flash_attention_q8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """Attention over an int8 K/V cache.  q: (B, Sq, Hq, d) float; k/v:
    (B, Sk, Hkv, d) int8 with one float32 scale per cached vector,
    (B, Sk, Hkv): the serving cache's layout as
    :func:`repro_torch.core.quant_cache.quantize_blocked` gives it, its
    block axis squeezed.  Returns (B, Sq, Hq, d) in q's dtype.

    Forward only: nothing differentiates through a serving cache.  The
    causal mask is the kernel's, aligned top-left, so a decode query
    (Sq = 1) over a cache's filled prefix is a ``causal=False`` call.
    Inputs may be strided views (of a ``DecodeState``, say): they are
    made contiguous in the raw layout here.
    """
    b, group = q.shape[0], q.shape[2] // k.shape[2]
    out = flash_attention_q8_nhd(_to_hsd(q), _to_hsd(k), _to_hsd(v),
                                 _to_hs(k_scale), _to_hs(v_scale),
                                 causal=causal, group=group)
    return _from_hsd(out, b)
