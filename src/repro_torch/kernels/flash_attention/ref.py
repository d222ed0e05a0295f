"""Plain torch versions of the flash-attention kernels.

Two kinds, as in the JAX package:

* the oracles, ``attention_nhd_ref`` (materialised scores, the causal
  mask aligned bottom-right, ``tril(k=Sk-Sq)``), ``attention_q8_nhd_ref``
  (the same over a dequantized int8 K/V) and ``attention_bwd_ref``
  (autograd of the first) — ``repro/kernels/flash_attention/ref.py``;
* the plain versions of the three kernels, with the kernels' signatures:
  :func:`flash_fwd_ref` returns ``(out, lse)``, :func:`flash_bwd_ref`
  takes ``(q, k, v, do, lse, delta)`` and :func:`flash_q8_ref` takes
  ``(q, k, v, k_scale, v_scale)``.  They follow the TPU kernels' causal
  mask, ``qpos >= kpos`` aligned top-left (``kernel.py:57-60``,
  ``kernel_bwd.py:64-67``, ``kernel_q8.py:57-60``).  The two alignments
  agree when Sq == Sk and differ when causal with Sk > Sq (ROADMAP queue
  3); the kernels follow the TPU kernels, not the oracle.

Layout: q (Hq, Sq, d), k/v (Hkv, Sk, d) with Hq = group * Hkv; q head h
reads kv head ``h // group``.  A batch folds into the head axis: (B * Hq)
query rows against (B * Hkv) kv rows keep the same ``h // group`` map.
Float32 math throughout.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
_F32 = torch.float32


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def attention_nhd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, group: int = 1) -> torch.Tensor:
    """Materialised-scores reference in q's dtype; the causal mask aligned
    bottom-right, as the JAX package's oracle aligns it."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    kk = k.repeat_interleave(group, dim=0).to(_F32)
    vv = v.repeat_interleave(group, dim=0).to(_F32)
    s = torch.einsum("hqd,hkd->hqk", q.to(_F32), kk) / (d ** 0.5)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask[None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vv).to(q.dtype)


def _dequantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (H, S, d) times one float32 scale per (head, position)."""
    return x.to(_F32) * scale.to(_F32)[..., None]


def attention_q8_nhd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                         causal: bool = True, group: int = 1
                         ) -> torch.Tensor:
    """Oracle of the quantized-cache kernel: dequantize (k/v (Hkv, Sk, d)
    int8, scales (Hkv, Sk)), then :func:`attention_nhd_ref`."""
    return attention_nhd_ref(q, _dequantize(k, k_scale),
                             _dequantize(v, v_scale), causal=causal,
                             group=group)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      group: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (dq, dk, dv) by autograd of :func:`attention_nhd_ref`."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_(True) for a in (q, k, v)]
        out = attention_nhd_ref(*args, causal=causal, group=group)
        return torch.autograd.grad(out, args, do)


def _scores(q, k, causal: bool, group: int) -> torch.Tensor:
    """Scaled float32 scores (Hq, Sq, Sk), the kernels' top-left causal
    mask applied as NEG_INF."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    kk = k.repeat_interleave(group, dim=0).to(_F32)
    s = torch.einsum("hqd,hkd->hqk", q.to(_F32), kk) * _scale(d)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None], s,
                        torch.full((), NEG_INF, device=q.device))
    return s


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, group: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 4: ``(out in q's dtype, lse (Hq, Sq)
    float32)``, with the kernel's ``denom = max(l, 1e-30)`` and
    ``lse = m + log(denom)``."""
    s = _scores(q, k, causal, group)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    vv = v.repeat_interleave(group, dim=0).to(_F32)
    out = torch.einsum("hqk,hkd->hqd", p, vv) / denom
    return out.to(q.dtype), (m + torch.log(denom))[..., 0]


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  *, causal: bool = True, group: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 6: the probabilities recomputed from the
    forward's ``lse`` as ``p = exp(s - lse)``, ``ds = p (dO Vᵀ - delta)
    scale``; float32 ``(dq (Hq, Sq, d), dk, dv (Hkv, Sk, d))`` with dk/dv
    summed over each kv head's group of q heads."""
    hkv, sk, d = k.shape
    s = _scores(q, k, causal, group)
    p = torch.exp(s - lse[..., None])
    kk = k.repeat_interleave(group, dim=0).to(_F32)
    vv = v.repeat_interleave(group, dim=0).to(_F32)
    do32, q32 = do.to(_F32), q.to(_F32)
    dp = torch.einsum("hqd,hkd->hqk", do32, vv)
    ds = p * (dp - delta[..., None]) * _scale(d)
    dq = torch.einsum("hqk,hkd->hqd", ds, kk)
    dk = torch.einsum("hqk,hqd->hkd", ds, q32).reshape(hkv, group, sk, d)
    dv = torch.einsum("hqk,hqd->hkd", p, do32).reshape(hkv, group, sk, d)
    return dq, dk.sum(1), dv.sum(1)


def flash_q8_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                 causal: bool = True, group: int = 1) -> torch.Tensor:
    """Plain version of kernel 5: kernel 4's forward (top-left causal
    mask, ``denom = max(l, 1e-30)``) over K/V dequantized in float32, one
    scale per (kv head, position); out in q's dtype."""
    return flash_fwd_ref(q, _dequantize(k, k_scale), _dequantize(v, v_scale),
                         causal=causal, group=group)[0]
