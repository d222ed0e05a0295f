"""Public wrappers of the wkv kernels: the ``(B, T, H, d)`` frontends.

On CUDA tensors the recurrence is the hand-written kernel of
``csrc/wkv.cu``; on CPU tensors it is the plain torch version of
:mod:`.ref`.  Both frontends are forward-only in this port so far: a
backward through :func:`wkv` raises, naming the training slice that ports
the reference's fused backward kernel (``wkv_recurrence_bwd``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.wkv.kernel import WKV, WKV_Q8


def wkv_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The raw ``(BH, T, d)`` recurrence on the inputs' device."""
    return common.dispatch(WKV, r, k, v, w, u)(r, k, v, w, u)


def wkv_recurrence_q8(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      s0_scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw int8-state recurrence on the inputs' device."""
    fn = common.dispatch(WKV_Q8, r, k, v, w, u, s0, s0_scale)
    return fn(r, k, v, w, u, s0, s0_scale)


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d)


def _unflat(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def _bonus(u: torch.Tensor, b: int) -> torch.Tensor:
    """(H, d) -> (B * H, d): the bonus row of every (batch, head) row."""
    h, d = u.shape
    return u[None].expand(b, h, d).reshape(b * h, d)


class _Wkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        b, _, h, _ = r.shape
        out = wkv_recurrence(_flat(r), _flat(k), _flat(v), _flat(w),
                             _bonus(u, b))
        return _unflat(out, b, h)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "wkv: no backward yet; the training slice ports the fused "
            "backward kernel wkv_recurrence_bwd (ROADMAP queue 2, kernel 9)")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, block_t: Optional[int] = None) -> torch.Tensor:
    """r/k/v/w: (B, T, H, d); u: (H, d).  Returns (B, T, H, d) in r's dtype.

    The state starts at zero.  ``block_t`` is accepted for parity with the
    reference and unused: the kernel loops over all of T.
    """
    return _Wkv.apply(r, k, v, w, u)


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
