"""Plain torch versions of the wkv kernels: the RWKV6 recurrence per
(batch * head) row, one float32 step at a time, in the reference's order
of operations (``repro/kernels/wkv/ref.py``).

Per step, with ``kv = k_t v_tᵀ`` rounded once:

    y_t = (r_t ⊙ u) · kv + r_t · S
    S  <- fma(diag(w_t), S, kv)

The reference runs this step as the body of a compiled scan, and its CPU
compiler contracts ``w * S + kv`` into one fused multiply-add: rounded
separately, the requantization scales differ from the reference's.  So
the state update is :func:`repro_torch.core.libm.fma_exact`, rounded once
as the reference's and the CUDA kernel's ``fmaf`` are, and the state, and
with it the int8 words and scales of :func:`wkv_q8_ref`, equal the
reference's (``tests/test_torch_wkv.py``) and the kernel's.  ``y`` is a
sum in another order and is held within a tolerance.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import libm
from repro_torch.core.quant_cache import quantize_blocked

_F32 = torch.float32


def _scan(r, k, v, w, u, s):
    """The recurrence from state ``s`` (BH, dk, dv): (out f32, final s)."""
    r, k, v, w = (a.to(_F32) for a in (r, k, v, w))
    u = u.to(_F32)
    out = torch.empty(v.shape, dtype=_F32, device=v.device)
    for t in range(r.shape[1]):
        rt = r[:, t]
        kv = k[:, t, :, None] * v[:, t, None, :]                # (BH, dk, dv)
        ru = rt * u
        out[:, t] = (torch.bmm(ru[:, None, :], kv)
                     + torch.bmm(rt[:, None, :], s))[:, 0]
        s = libm.fma_exact(w[:, t, :, None], s, kv)
    return out, s


def wkv_recurrence_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/w (BH, T, dk); v (BH, T, dv); u (BH, dk) -> (BH, T, dv) in
    ``r``'s dtype, float32 math, state starting at zero."""
    s0 = torch.zeros((r.shape[0], r.shape[2], v.shape[2]), dtype=_F32,
                     device=r.device)
    return _scan(r, k, v, w, u, s0)[0].to(r.dtype)


def wkv_q8_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               s0_scale: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence from an int8 state (BH, dk, dv) with one float32
    scale per dk row (BH, dk): dequantize, run, requantize the final state
    as ``quant_cache.quantize_blocked`` does.  Returns ``(out in r's dtype,
    state int8 (BH, dk, dv), scale float32 (BH, dk))``."""
    s = s0.to(_F32) * s0_scale.to(_F32)[..., None]
    out, s = _scan(r, k, v, w, u, s)
    q, sc = quantize_blocked(s)
    return out.to(r.dtype), q, sc[..., 0]
