"""GQA attention: naive, chunked (online softmax) and single-token decode.

Layouts follow the JAX reference: activations (B, S, H, dh), caches
(B, S_max, Hkv, dh).  The decode cache is stored in the model's dtype,
as int8 with one float32 scale per (position, kv head) vector (the
per-block format of :mod:`repro_torch.core.quant_cache`), or as int8 at
the legacy fixed Q3.4 scale (:data:`KV_Q_SCALE`, the paper's FxP8 cache
study).  Paged caches come with ROADMAP queue 1, item 13.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ExecutionPolicy
from repro_torch.core.quant_cache import dequantize_blocked, quantize_blocked
from repro_torch.models import layers as L

NEG_INF = -1e30
FULL_WINDOW = 2 ** 30
# FxP8 (Q3.4) K/V-cache quantization: the paper's 8-bit format applied to
# the decode cache (``ArchConfig.kv_cache_bits == 8``).
KV_Q_SCALE = 16.0


def quantize_kv(x: torch.Tensor) -> torch.Tensor:
    """The legacy fixed-scale format: ``round(x * 16)`` clipped to
    [-127, 127], as int8."""
    return torch.clamp(torch.round(x.to(torch.float32) * KV_Q_SCALE),
                       -127, 127).to(torch.int8)


def dequantize_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`; a float cache is only cast."""
    if x.dtype != torch.int8:
        return x.to(dtype)
    return (x.to(torch.float32) * (1.0 / KV_Q_SCALE)).to(dtype)


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window
                        ) -> torch.Tensor:
    """True = attend.  q_pos (Sq,), k_pos (Sk,)."""
    d = q_pos[:, None] - k_pos[None, :]
    return (d >= 0) & (d < window)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


class AttnParams(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


def qkv(x: torch.Tensor, p: AttnParams, cfg: ArchConfig, pol: ExecutionPolicy,
        rope: Tuple[torch.Tensor, torch.Tensor]
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projections of a decoder block (``wide_scale``), heads split; q
    and k rotated by ``rope``, the (sin, cos) of
    :func:`layers.rope_sincos` at the tokens' positions."""
    q, k, v = (L.dense(x, w, pol, b, wide_scale=True)
               for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
    q = _split_heads(q, cfg.n_heads)
    k = _split_heads(k, cfg.n_kv_heads)
    v = _split_heads(v, cfg.n_kv_heads)
    if cfg.family != "ssm":
        q = L.apply_rope(q, rope)
        k = L.apply_rope(k, rope)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _inv_root(dh: int, dtype: torch.dtype) -> float:
    """The float32 reciprocal of ``sqrt(dh)`` rounded to ``dtype``."""
    root = torch.tensor(math.sqrt(dh), dtype=dtype).to(torch.float32)
    return (1.0 / root).item()


def _scaled(scores: torch.Tensor, dh: int) -> torch.Tensor:
    """float32 ``scores / sqrt(dh)`` as the reference's compiled block
    takes it: the product in the inputs' dtype times the float32
    reciprocal of ``sqrt(dh)`` rounded to that dtype, not rounded again
    (its compiler folds the division into that product and drops the
    rounding to bfloat16 before the float32 mask)."""
    return scores.to(torch.float32) * _inv_root(dh, scores.dtype)


def naive_attention(q, k, v, cfg: ArchConfig, pol: ExecutionPolicy, q_pos,
                    k_pos, window) -> torch.Tensor:
    """Materialised-scores attention (small seq / reference)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = _scaled(torch.einsum("bskgd,btkd->bkgst", qg, k), dh)
    mask = _causal_window_mask(q_pos, k_pos, window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = L.softmax(scores, pol).to(q.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return ctx.reshape(b, sq, hq, dh)


def chunked_attention(q, k, v, cfg: ArchConfig, pol: ExecutionPolicy, q_pos,
                      k_pos, window, chunk: int) -> torch.Tensor:
    """Online-softmax over KV chunks; O(S*chunk) live memory."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    chunk = min(chunk, sk)
    if sk % chunk:
        raise ValueError(f"key length {sk} is not a multiple of the "
                         f"attention chunk {chunk}")
    qg = q.reshape(b, sq, hkv, g, dh)
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        k_i, v_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, k_i).to(torch.float32) * scale
        mask = _causal_window_mask(q_pos, k_pos[c0:c0 + chunk], window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_i = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_i[..., None])
        alpha = torch.exp(m - m_i)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q.dtype), v_i).to(torch.float32)
        m = m_i
    o = o / torch.clamp(l[..., None], min=1e-30)
    ctx = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return ctx.to(q.dtype)


def attention(q, k, v, cfg: ArchConfig, pol: ExecutionPolicy, q_pos, k_pos,
              window=None) -> torch.Tensor:
    window = FULL_WINDOW if window is None else window
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if k.shape[1] > 2048 else "naive"
    if impl == "chunked":
        return chunked_attention(q, k, v, cfg, pol, q_pos, k_pos, window,
                                 cfg.attn_chunk)
    return naive_attention(q, k, v, cfg, pol, q_pos, k_pos, window)


# ---------------------------------------------------------------------------
# Decode (single-token) with a preallocated cache
# ---------------------------------------------------------------------------

def _attend_decode(q, keys, vals, pos: torch.Tensor, pol: ExecutionPolicy,
                   window) -> torch.Tensor:
    """Single-token attend over a (B, S, Hkv, dh) key/value view.

    The cache is a ring: slot t holds the newest write whose position is
    t mod S; the valid entries are the last min(pos + 1, S) writes.
    ``pos`` is a scalar (every row at one position) or (B,) per row.
    """
    b, _, hq, dh = q.shape
    s_max = keys.shape[1]
    hkv = keys.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, dh)
    scores = _scaled(torch.einsum("bskgd,btkd->bkgst", qg, keys), dh)
    per_row = pos.dim() == 1
    t = torch.arange(s_max, device=q.device)
    p = pos[:, None] if per_row else pos
    age = torch.remainder(p - t, s_max)                  # 0 = newest
    valid = age < torch.clamp(p + 1, max=s_max)
    mask = valid & (age < window)
    mask = mask[:, None, None, None, :] if per_row else mask[None, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = L.softmax(scores, pol).to(q.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, vals)
    return ctx.reshape(b, 1, hq, dh)


def decode_attention(q, k_new, v_new, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ArchConfig, pol: ExecutionPolicy, window,
                     scale_k: Optional[torch.Tensor] = None,
                     scale_v: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q/k_new/v_new: (B, 1, H*, dh); cache: (B, S, Hkv, dh).

    Writes the new K/V into the caches **in place** at ``pos mod S`` (the
    JAX reference returns new arrays; the port updates its own state's
    caches instead of copying them every step), then attends.  ``pos`` is
    the tokens-seen counter: a scalar, or (B,) per serving slot.

    With ``scale_k``/``scale_v`` (B, S, Hkv, 1) the cache is the per-block
    int8 format: each new K/V vector is quantized on write, its scale
    lands at the same ring slot, and the whole cache is dequantized into
    ``q.dtype`` on read.  Without them an int8 cache is the legacy
    fixed-scale format (:func:`quantize_kv`).
    """
    slot = torch.remainder(pos, cache_k.shape[1])
    blocked = scale_k is not None
    if blocked:
        (k_w, k_s), (v_w, v_s) = quantize_blocked(k_new), quantize_blocked(v_new)
    elif cache_k.dtype == torch.int8:
        k_w, v_w = quantize_kv(k_new), quantize_kv(v_new)
    else:
        k_w, v_w = k_new.to(cache_k.dtype), v_new.to(cache_v.dtype)
    writes = [(cache_k, k_w), (cache_v, v_w)]
    if blocked:
        writes += [(scale_k, k_s), (scale_v, v_s)]
    if pos.dim() == 1:
        rows = torch.arange(q.shape[0], device=q.device)
        for cache, new in writes:
            cache[rows, slot] = new[:, 0]
    else:
        for cache, new in writes:
            cache[:, slot] = new[:, 0]
    if blocked:
        keys = dequantize_blocked(cache_k, scale_k, q.dtype)
        vals = dequantize_blocked(cache_v, scale_v, q.dtype)
    else:
        keys = dequantize_kv(cache_k, q.dtype)
        vals = dequantize_kv(cache_v, q.dtype)
    return _attend_decode(q, keys, vals, pos, pol, window)
