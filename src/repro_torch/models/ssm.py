"""Attention-free sequence mixer: RWKV6 (Finch) time-mix and channel-mix.

The recurrence is the reference's own per-step loop (``repro/models/
ssm.py``, a scan over chunks of up to 64 steps there), one float32 step
at a time in the same order of operations, for any T; the model does not
call the wkv kernels (neither does the reference's).
Where the reference's compiled layer loop contracts a float32 multiply
and add into one fused multiply-add — the token-shift mix, ``S + u * kv``,
the state update ``w * S + kv`` and the channel-mix residual — the port
spells it as :func:`repro_torch.core.libm.fma`; the decay's ``exp`` and ``tanh`` are
``libm``'s, the reference's evaluation.  The Mamba mixer (hymba) is not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ExecutionPolicy
from repro_torch.core import libm
from repro_torch.models import layers as L

Tensor = torch.Tensor
_F32 = torch.float32


class Rwkv6Params(NamedTuple):
    mu: Tensor        # (5, D) token-shift lerp factors for r,k,v,w,g
    w0: Tensor        # (D,) decay base
    w_lora_a: Tensor  # (D, 64) data-dependent decay LoRA
    w_lora_b: Tensor  # (64, D)
    bonus: Tensor     # (H, dk) the "u" current-token bonus
    wr: Tensor        # (D, D)
    wk: Tensor        # (D, D)
    wv: Tensor        # (D, D)
    wg: Tensor        # (D, D)
    wo: Tensor        # (D, D)
    ln_w: Tensor      # (D,) per-head group-norm gain


class Rwkv6ChannelParams(NamedTuple):
    mu_k: Tensor   # (D,)
    mu_r: Tensor   # (D,)
    wk: Tensor     # (D, F)
    wv: Tensor     # (F, D)
    wr: Tensor     # (D, D)


def _token_shift(x: Tensor, x_prev: Tensor) -> Tensor:
    """shifted[t] = x[t-1]; position 0 sees the carried boundary token."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _muladd(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c``: in float32 the multiply and add fused, as the
    reference's compiler contracts them; in bfloat16 each op rounds to
    bfloat16, as the reference's does."""
    if a.dtype == _F32:
        return libm.fma(a, b, c)
    return c + a * b


def _mix(x: Tensor, xs: Tensor, mu: Tensor) -> Tensor:
    """The token-shift lerp ``x + (xs - x) * mu``."""
    return _muladd(xs - x, mu.to(x.dtype), x)


def _mix_f32(x: Tensor, xs: Tensor, mu: Tensor) -> Tensor:
    """The lerp converted to float32, as the reference's compiled program
    evaluates ``(x + (xs - x) * mu).astype(float32)``: in bfloat16 the
    subtract and the multiply round to bfloat16 and the add, whose result
    is converted next, is kept in float32 unrounded."""
    if x.dtype == _F32:
        return _mix(x, xs, mu)
    return x.to(_F32) + ((xs - x) * mu.to(x.dtype)).to(_F32)


def _last_valid(x: Tensor, lengths: Optional[Tensor]) -> Tensor:
    """x[:, n-1, :] per row — the boundary token carried into decode.

    With ``lengths=None`` (unpadded sequences) this is ``x[:, -1]``; for a
    right-padded serving prefill it takes each row's last *real* position.
    """
    if lengths is None:
        return x[:, -1, :]
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, lengths.to(x.device).long() - 1, :]


def wkv_steps(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
              S: Tensor) -> Tuple[Tensor, Tensor]:
    """The recurrence over T steps from state ``S`` (B, H, dk, dv) float32.

    r/k/v/w: (B, T, H, d); u: (H, dk) float32.  Per step, as the
    reference's scanned step:
        out_t = einsum(r_t, S + u * kv),  S <- w_t * S + kv
    Returns (out (B, T, H, dv) float32, S).
    """
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (a[:, t].to(_F32) for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]           # (B,H,dk,dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                 libm.fma(u[..., None], kv, S)))
        S = libm.fma(w_t[..., None], S, kv)
    return torch.stack(outs, dim=1), S


def rwkv6_timemix(x: Tensor, p: Rwkv6Params, cfg: ArchConfig,
                  pol: ExecutionPolicy, state: Tuple[Tensor, Tensor],
                  mask: Optional[Tensor] = None,
                  lengths: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """x: (B, T, D).  state = (x_boundary (B, D), S (B, H, dk, dv)).

    Returns (out (B, T, D), new state).  ``mask`` (B, T) marks real tokens
    of a right-padded batch: pad steps carry S through unchanged (decay
    forced to 1, k to 0, exact); ``lengths`` picks each row's last real
    token for the token-shift boundary.
    """
    b, t, d = x.shape
    h = cfg.n_heads
    dk = d // h
    x_prev, s0 = state
    xs = _token_shift(x, x_prev)
    xr, xk, xv, xg = (_mix(x, xs, p.mu[i]) for i in (0, 1, 2, 4))
    xw = _mix_f32(x, xs, p.mu[3])
    r = L.dense(xr, p.wr, pol).reshape(b, t, h, dk)
    k = L.dense(xk, p.wk, pol).reshape(b, t, h, dk)
    v = L.dense(xv, p.wv, pol).reshape(b, t, h, dk)
    g = L.dense(xg, p.wg, pol)
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw)))
    dd = libm.tanh(xw.to(_F32) @ p.w_lora_a.to(_F32)) @ p.w_lora_b.to(_F32)
    logw = -libm.exp(torch.clamp(p.w0.to(_F32) + dd, -8.0, 2.0))
    w = libm.exp(logw).reshape(b, t, h, dk)                   # in (0, 1)
    u = p.bonus.to(_F32)                                     # (H, dk)
    if mask is not None:
        m = mask.to(x.device)[:, :, None, None]
        w = torch.where(m, w, torch.ones((), dtype=w.dtype, device=w.device))
        k = torch.where(m, k, torch.zeros((), dtype=k.dtype, device=k.device))
    out, S = wkv_steps(r, k, v, w, u, s0.to(_F32))
    return _timemix_out(out, x, g, p, pol, lengths, S)


def _timemix_out(out: Tensor, x: Tensor, g: Tensor, p: Rwkv6Params,
                 pol: ExecutionPolicy, lengths, S: Tensor
                 ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Timemix epilogue: per-head group norm, gate, out projection."""
    b, t, d = x.shape
    mean = out.mean(-1, keepdim=True)
    c = out - mean
    var = (c * c).mean(-1, keepdim=True)
    out = c * torch.rsqrt(var + 64e-5)
    out = out.reshape(b, t, d) * p.ln_w.to(_F32)
    out = out.to(x.dtype) * L.af(g, "silu", pol)
    out = L.dense(out, p.wo, pol)
    return out, (_last_valid(x, lengths), S)


def rwkv6_channelmix(x: Tensor, p: Rwkv6ChannelParams, cfg: ArchConfig,
                     pol: ExecutionPolicy, x_prev: Tensor,
                     lengths: Optional[Tensor] = None,
                     residual: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """Returns (out (B, T, D), x's boundary token).  With ``residual``,
    ``out`` is ``residual + r * kv`` with the multiply and add fused as the
    reference's compiled block fuses them; else ``r * kv``."""
    xs = _token_shift(x, x_prev)
    xk = _mix(x, xs, p.mu_k)
    xr = _mix(x, xs, p.mu_r)
    k = L.af(L.dense(xk, p.wk, pol), "relu", pol)
    k = k * k                                        # squared ReLU
    kv = L.dense(k, p.wv, pol)
    r = L.af(L.dense(xr, p.wr, pol), "sigmoid", pol)
    out = r * kv if residual is None else _muladd(r, kv, residual)
    return out, _last_valid(x, lengths)
