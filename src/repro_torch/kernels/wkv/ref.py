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

The backward has two plain forms: :func:`wkv_recurrence_bwd_ref`, the
kernel's adjoint sweep (states recomputed block by block from the
forward's checkpoints, then time reversed), and :func:`wkv_bwd_ref`, the
exact VJP by autograd of a differentiable float32 scan (the oracle, as
the reference's ``wkv_bwd_ref`` is ``jax.vjp`` of its scan).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import libm
from repro_torch.core.quant_cache import quantize_blocked
from repro_torch.kernels.common import check_block

_F32 = torch.float32


def _scan(r, k, v, w, u, s, bt: int = 0):
    """The recurrence from state ``s`` (BH, dk, dv): (out f32, final s,
    checkpoints): with ``bt`` the state at the start of every block of
    ``bt`` steps, (BH, T / bt, dk, dv), else None."""
    r, k, v, w = (a.to(_F32) for a in (r, k, v, w))
    u = u.to(_F32)
    out = torch.empty(v.shape, dtype=_F32, device=v.device)
    ckpts = []
    for t in range(r.shape[1]):
        if bt and t % bt == 0:
            ckpts.append(s)
        rt = r[:, t]
        kv = k[:, t, :, None] * v[:, t, None, :]                # (BH, dk, dv)
        ru = rt * u
        out[:, t] = (torch.bmm(ru[:, None, :], kv)
                     + torch.bmm(rt[:, None, :], s))[:, 0]
        s = libm.fma_exact(w[:, t, :, None], s, kv)
    if not bt:
        return out, s, None
    ckpt = (torch.stack(ckpts, dim=1) if ckpts else
            s.new_zeros((s.shape[0], 0) + s.shape[1:]))
    return out, s, ckpt


def wkv_recurrence_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, *,
                       block_t: int = 64, return_residuals: bool = False):
    """r/k/w (BH, T, dk); v (BH, T, dv); u (BH, dk) -> (BH, T, dv) in
    ``r``'s dtype, float32 math, state starting at zero.  With
    ``return_residuals`` also the float32 checkpoints (BH, T / block_t,
    dk, dv); ``block_t`` must divide T."""
    s0 = torch.zeros((r.shape[0], r.shape[2], v.shape[2]), dtype=_F32,
                     device=r.device)
    bt = 0
    if return_residuals:
        check_block(r.shape[1], block_t, "wkv checkpoints")
        bt = block_t
    out, _, ckpt = _scan(r, k, v, w, u, s0, bt)
    out = out.to(r.dtype)
    return (out, ckpt) if return_residuals else out


def wkv_recurrence_bwd_ref(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           dy: torch.Tensor, ckpt: torch.Tensor, *,
                           block_t: int = 64) -> Tuple[torch.Tensor, ...]:
    """Plain version of the fused backward (kernel 9): float32 ``(dr, dk,
    dv, dw, du)``, du (BH, dk).  Each block's states are recomputed from
    ``ckpt`` with the forward's single-rounding update, then the block is
    swept in reverse carrying the state adjoint A = dL/dS:

        dr_t = S_t dy_t + u ⊙ k_t (v_t·dy_t)
        dk_t = r_t ⊙ u (v_t·dy_t) + A v_t
        dv_t = (Σ r ⊙ u ⊙ k_t) dy_t + Aᵀ k_t
        dw_t = rowsum(A ⊙ S_t)
        du  += r_t ⊙ k_t (v_t·dy_t)
        A   <- diag(w_t) A + r_t dy_tᵀ
    """
    r, k, v, w, dy = (a.to(_F32) for a in (r, k, v, w, dy))
    u = u.to(_F32)
    bh, t, dk = r.shape
    check_block(t, block_t, "wkv backward")
    bt = block_t
    dr, dk_, dw = (torch.empty_like(r) for _ in range(3))
    dv_ = torch.empty_like(v)
    du = torch.zeros_like(u)
    a = torch.zeros_like(ckpt[:, 0]) if t else None
    for blk in reversed(range(t // bt)):
        t0 = blk * bt
        states = [ckpt[:, blk]]
        for tt in range(bt - 1):
            kv = k[:, t0 + tt, :, None] * v[:, t0 + tt, None, :]
            states.append(libm.fma_exact(w[:, t0 + tt, :, None], states[-1],
                                         kv))
        for tt in reversed(range(bt)):
            i = t0 + tt
            s_i = states[tt]
            r_i, k_i, w_i, v_i, dy_i = r[:, i], k[:, i], w[:, i], v[:, i], dy[:, i]
            vdy = (v_i * dy_i).sum(-1, keepdim=True)
            dr[:, i] = (torch.bmm(s_i, dy_i[..., None])[..., 0]
                        + u * k_i * vdy)
            du = du + r_i * k_i * vdy
            dk_[:, i] = r_i * u * vdy + torch.bmm(a, v_i[..., None])[..., 0]
            dv_[:, i] = ((r_i * u * k_i).sum(-1, keepdim=True) * dy_i
                         + torch.bmm(k_i[:, None, :], a)[:, 0])
            dw[:, i] = (a * s_i).sum(-1)
            a = w_i[..., None] * a + r_i[..., None] * dy_i[:, None, :]
    return dr, dk_, dv_, dw, du


def wkv_scan_exact(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A differentiable float32 scan of the same recurrence (each op
    rounded on its own), in ``r``'s dtype: what autograd differentiates
    for the exact VJP."""
    r, k, v, w = (a.to(_F32) for a in (r, k, v, w))
    u = u.to(_F32)
    s = torch.zeros((r.shape[0], r.shape[2], v.shape[2]), dtype=_F32,
                    device=r.device)
    outs = []
    for t in range(r.shape[1]):
        rt = r[:, t]
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append((torch.bmm((rt * u)[:, None, :], kv)
                     + torch.bmm(rt[:, None, :], s))[:, 0])
        s = w[:, t, :, None] * s + kv
    out = torch.stack(outs, 1) if outs else torch.zeros_like(v, dtype=_F32)
    return out.to(r.dtype)


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Exact ``(dr, dk, dv, dw, du)`` by autograd of
    :func:`wkv_scan_exact`, in the inputs' dtypes — the oracle for the
    fused backward."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_(True) for a in (r, k, v, w, u)]
        return torch.autograd.grad(wkv_scan_exact(*args), args, dy)


def wkv_q8_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               s0_scale: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence from an int8 state (BH, dk, dv) with one float32
    scale per dk row (BH, dk): dequantize, run, requantize the final state
    as ``quant_cache.quantize_blocked`` does.  Returns ``(out in r's dtype,
    state int8 (BH, dk, dv), scale float32 (BH, dk))``."""
    s = s0.to(_F32) * s0_scale.to(_F32)[..., None]
    out, s, _ = _scan(r, k, v, w, u, s)
    q, sc = quantize_blocked(s)
    return out.to(r.dtype), q, sc[..., 0]
