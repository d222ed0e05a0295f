"""Public wrapper of the flash-attention kernels: the ``(B, S, H, d)``
GQA frontend, differentiable through the fused backward.

On CUDA tensors the forward is kernel 4 (``csrc/flash_fwd.cu``) and the
backward kernel 6 (``csrc/flash_bwd.cu``); on CPU tensors they are their
plain torch versions (:mod:`.ref`).  ``REPRO_FUSED_BWD=0`` puts the
backward on the exact VJP of the materialised float reference, as in the
JAX package.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.kernel import FLASH, FLASH_BWD
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


def _to_hsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) -> (B * H, S, d), contiguous."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


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
