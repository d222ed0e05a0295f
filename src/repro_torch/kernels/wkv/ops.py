"""Public wrappers of the wkv kernels: the ``(B, T, H, d)`` frontends.

On CUDA tensors the recurrence is the hand-written kernel of
``csrc/wkv.cu`` and its backward that of ``csrc/wkv_bwd.cu``; on CPU
tensors they are the plain torch versions of :mod:`.ref`.  :func:`wkv` is
differentiable: under a gradient its forward also writes block
checkpoints of the state and the backward is the fused reverse-time
kernel, or, with ``REPRO_FUSED_BWD=0``, the exact VJP of the float scan.
:func:`wkv_q8` is forward only (a serving path), as in the reference.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.wkv.kernel import WKV, WKV_BWD, WKV_Q8
from repro_torch.kernels.wkv.ref import wkv_scan_exact


def wkv_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, *, block_t: int = 64,
                   return_residuals: bool = False):
    """The raw ``(BH, T, d)`` recurrence on the inputs' device; with
    ``return_residuals`` also the checkpoints of every ``block_t`` steps
    (``block_t`` divides T)."""
    return common.dispatch(WKV, r, k, v, w, u)(
        r, k, v, w, u, block_t=block_t, return_residuals=return_residuals)


def wkv_recurrence_bwd(r, k, v, w, u, dy, ckpt, *, block_t: int = 64):
    """The raw fused backward on the inputs' device: float32 ``(dr, dk,
    dv, dw, du)``; ``block_t`` is the forward's checkpoint spacing."""
    return common.dispatch(WKV_BWD, r, k, v, w, u, dy, ckpt)(
        r, k, v, w, u, dy, ckpt, block_t=block_t)


def wkv_recurrence_q8(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      s0_scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw int8-state recurrence on the inputs' device."""
    fn = common.dispatch(WKV_Q8, r, k, v, w, u, s0, s0_scale)
    return fn(r, k, v, w, u, s0, s0_scale)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, d) -> (B * H, T, d), contiguous (at B = 1 the reshape
    is a strided view, which the kernels refuse)."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _unflat(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def _bonus(u: torch.Tensor, b: int) -> torch.Tensor:
    """(H, d) -> (B * H, d): the bonus row of every (batch, head) row."""
    h, d = u.shape
    return u[None].expand(b, h, d).reshape(b * h, d)


def bwd_block_cap(d: int) -> int:
    """The training path's time block: checkpoint spacing and the
    backward's recompute block.

    The backward keeps a block's recomputed states, block_t x d x d
    float32 per (batch * head) row, in a global scratch buffer that it
    writes and reads back once per step; the budget of 2**16 floats per
    row (16 steps at d = 64) keeps rwkv6-3b's 80 rows of a batch-2 step at
    20 MB, inside the H100's 50 MB L2 cache.  The floor of 16 and the cap
    of 512 are the reference's.
    """
    return max(16, min(512, (1 << 16) // max(1, d * d)))


def _fwd(r, k, v, w, u):
    b, _, h, _ = r.shape
    out = wkv_recurrence(_flat(r), _flat(k), _flat(v), _flat(w),
                         _bonus(u, b))
    return _unflat(out, b, h)


def _fwd_res(r, k, v, w, u, *, block_t: int):
    b, _, h, _ = r.shape
    out, ckpt = wkv_recurrence(_flat(r), _flat(k), _flat(v), _flat(w),
                               _bonus(u, b), block_t=block_t,
                               return_residuals=True)
    return _unflat(out, b, h), (r, k, v, w, u, ckpt)


def _bwd(res, dy, *, block_t: int):
    """The fused backward on the public layout; cotangents in the primal
    dtypes, du summed over the batch."""
    r, k, v, w, u, ckpt = res
    b, _, h, d = r.shape
    dr, dk, dv, dw, du = wkv_recurrence_bwd(
        _flat(r), _flat(k), _flat(v), _flat(w), _bonus(u, b), _flat(dy),
        ckpt, block_t=block_t)
    return (_unflat(dr, b, h).to(r.dtype), _unflat(dk, b, h).to(k.dtype),
            _unflat(dv, b, h).to(v.dtype), _unflat(dw, b, h).to(w.dtype),
            du.reshape(b, h, d).sum(0).to(u.dtype))


def exact_wkv(r, k, v, w, u):
    """The float scan on the (B, T, H, d) layout: the backward under
    ``REPRO_FUSED_BWD=0``."""
    b, _, h, _ = r.shape
    out = wkv_scan_exact(_flat(r), _flat(k), _flat(v), _flat(w),
                         _bonus(u, b))
    return _unflat(out, b, h)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, block_t: Optional[int] = None) -> torch.Tensor:
    """r/k/v/w: (B, T, H, d); u: (H, d).  Returns (B, T, H, d) in r's dtype.

    The state starts at zero.  The forward kernel loops over all of T;
    ``block_t`` caps the training path's checkpoint spacing (default
    :func:`bwd_block_cap`), which is the largest divisor of T under it:
    the one place the forward's and the backward's spacing is chosen.
    """
    if block_t is None:
        block_t = bwd_block_cap(r.shape[3])
    bt = common.largest_divisor(r.shape[1], block_t)
    fn = common.fused_vjp(_fwd, exact_wkv,
                          functools.partial(_fwd_res, block_t=bt),
                          functools.partial(_bwd, block_t=bt), spec=WKV_BWD)
    return fn(r, k, v, w, u)


def wkv_q8(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
           state_scale: torch.Tensor, *, block_t: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantized-state wkv.  r/k/v/w: (B, T, H, d); u: (H, d); state:
    (B, H, dk, dv) int8 with per-row float32 scales (B, H, dk) — one
    layer's slot state.

    Returns ``(out (B, T, H, dv), state int8, state_scale)``: the state
    after the T steps, requantized in the kernel.  Forward only (a serving
    path); ``block_t`` as in :func:`wkv`.
    """
    b, _, h, _ = r.shape
    dk, dv = state.shape[-2:]
    out, s_q, s_scale = wkv_recurrence_q8(
        _flat(r), _flat(k), _flat(v), _flat(w), _bonus(u, b),
        state.reshape(b * h, dk, dv), state_scale.reshape(b * h, dk))
    return (_unflat(out, b, h), s_q.reshape(b, h, dk, dv),
            s_scale.reshape(b, h, dk))
