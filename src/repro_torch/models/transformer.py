"""The decoder LM, dense and ssm families: forward, prefill and
single-token decode.

Parameters are a nested dict of tensors with the JAX reference's layout:
every per-layer leaf is stacked along a leading ``layers`` axis, and the
layers run as a plain Python loop over it.  The dense family mixes with
GQA attention over a K/V cache; the ssm family (rwkv6) with the RWKV6
time-mix and channel-mix over an O(1) recurrent state.  Under the int8
cache (``CacheSpec(dtype="int8")``) the K/V cache is int8 with one
float32 scale per (position, kv head) vector, and the recurrent state
int8 with one float32 scale per state row; the legacy ``"fxp8"`` format
stores the K/V cache as int8 at a fixed Q3.4 scale.  The other families
(moe, hybrid, audio, vlm) and paged caches are refused here; ROADMAP
queue 1 items 8, 10 and 13 port them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ExecutionPolicy
from repro_torch.core.quant_cache import dequantize_blocked, quantize_blocked
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.spec import P

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what this port does not run yet, naming the ROADMAP item."""
    if (cfg.family not in ("dense", "ssm") or cfg.input_kind != "tokens"
            or cfg.n_codebooks):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"runs the dense and ssm families (ROADMAP queue 1, items 8 and "
            f"10 port hybrid and the remaining families)")
    spec = cfg.cache_spec()
    if spec.paged:
        raise NotImplementedError(
            f"{cfg.name}: cache {spec} is not ported yet; the port serves "
            f"unpaged caches (ROADMAP queue 1, item 13)")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def params_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """Declaration tree for the whole model (stacked layers)."""
    check_supported(cfg)
    Lr, D, dh = cfg.n_layers, cfg.d_model, cfg.head_dim_
    Hq, Hkv, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = dtype_of(cfg)

    def ly(*shape, axes, **kw):
        return P((Lr,) + shape, ("layers",) + axes, dtype=dt, **kw)

    tree = {
        "embed": P((cfg.vocab_size, D), ("vocab", "embed"), dtype=dt),
        "ln_f": P((D,), ("embed",), init="ones"),
        "lm_head": P((D, cfg.vocab_size), ("embed", "vocab"), dtype=dt,
                     init="scaled"),
    }
    if cfg.family == "ssm":
        H = cfg.n_heads
        tree["blocks"] = {
            "ln1": ly(D, axes=("embed",), init="ones"),
            "tm": {
                "mu": ly(5, D, axes=(None, "embed"), init="zeros"),
                "w0": ly(D, axes=("embed",), init="zeros"),
                "w_lora_a": ly(D, 64, axes=("embed", None), init="scaled"),
                "w_lora_b": ly(64, D, axes=(None, "embed"), init="scaled"),
                "bonus": ly(H, dh, axes=("heads", None), init="zeros"),
                "wr": ly(D, D, axes=("embed", "heads"), init="scaled"),
                "wk": ly(D, D, axes=("embed", "heads"), init="scaled"),
                "wv": ly(D, D, axes=("embed", "heads"), init="scaled"),
                "wg": ly(D, D, axes=("embed", "heads"), init="scaled"),
                "wo": ly(D, D, axes=("heads", "embed"), init="scaled"),
                "ln_w": ly(D, axes=("embed",), init="ones"),
            },
            "cm": {
                "mu_k": ly(D, axes=("embed",), init="zeros"),
                "mu_r": ly(D, axes=("embed",), init="zeros"),
                "wk": ly(D, F, axes=("embed", "mlp"), init="scaled"),
                "wv": ly(F, D, axes=("mlp", "embed"), init="scaled"),
                "wr": ly(D, D, axes=("embed", "qkv"), init="scaled"),
            },
            "ln2": ly(D, axes=("embed",), init="ones"),
        }
        return tree

    attn = {
        "wq": ly(D, Hq * dh, axes=("embed", "heads"), init="scaled"),
        "wk": ly(D, Hkv * dh, axes=("embed", "kv_heads"), init="scaled"),
        "wv": ly(D, Hkv * dh, axes=("embed", "kv_heads"), init="scaled"),
        "wo": ly(Hq * dh, D, axes=("heads", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        attn["bq"] = ly(Hq * dh, axes=("heads",), init="zeros")
        attn["bk"] = ly(Hkv * dh, axes=("kv_heads",), init="zeros")
        attn["bv"] = ly(Hkv * dh, axes=("kv_heads",), init="zeros")
    tree["blocks"] = {
        "ln1": ly(D, axes=("embed",), init="ones"),
        "ln2": ly(D, axes=("embed",), init="ones"),
        "attn": attn,
        "ffn": {
            "w_gate": ly(D, F, axes=("embed", "mlp"), init="scaled"),
            "w_up": ly(D, F, axes=("embed", "mlp"), init="scaled"),
            "w_down": ly(F, D, axes=("mlp", "embed"), init="scaled"),
        },
    }
    return tree


def layer_windows(cfg: ArchConfig, seq_len: int) -> np.ndarray:
    """Per-layer attention window."""
    full = A.FULL_WINDOW
    if cfg.sliding_window <= 0:
        return np.full((cfg.n_layers,), full, np.int32)
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    if cfg.global_attn_every > 0 and seq_len <= 65536:
        w[::cfg.global_attn_every] = full
        w[-1] = full
    return w


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def _attn_params(bp: Dict[str, Any]) -> A.AttnParams:
    a = bp["attn"]
    return A.AttnParams(a["wq"], a["wk"], a["wv"], a["wo"], a.get("bq"),
                        a.get("bk"), a.get("bv"))


def _ffn(x: Tensor, attn_out: Tensor, bp: Dict[str, Any], cfg: ArchConfig,
         pol: ExecutionPolicy) -> Tensor:
    """The attention residual ``x + attn_out``, then the FFN sub-block."""
    x, h = L.residual_norm(x, attn_out, bp["ln2"], cfg.norm_eps)
    f = bp["ffn"]
    return x + L.swiglu(h, f["w_gate"], f["w_up"], f["w_down"], pol,
                        cfg.activation)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _rope(positions: Tensor, cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    """The rotary (sin, cos) at ``positions``, once per model call."""
    return L.rope_sincos(positions, cfg.head_dim_, cfg.rope_theta)


def block_forward(x: Tensor, bp: Dict[str, Any], cfg: ArchConfig,
                  pol: ExecutionPolicy, positions: Tensor, window,
                  rope: Tuple[Tensor, Tensor]
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """One dense decoder block over a full sequence; ``rope`` is
    :func:`_rope` of ``positions``.  Returns (x, k, v)."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = A.qkv(h, _attn_params(bp), cfg, pol, rope)
    ctx = A.attention(q, k, v, cfg, pol, positions, positions, window)
    attn_out = L.dense(ctx.reshape(*x.shape[:2], -1), bp["attn"]["wo"], pol,
                       wide_scale=True)
    return _ffn(x, attn_out, bp, cfg, pol), k, v


def ssm_block(x: Tensor, bp: Dict[str, Any], cfg: ArchConfig,
              pol: ExecutionPolicy, x_prev: Tensor, wkv: Tensor,
              cm_prev: Tensor, mask: Optional[Tensor] = None,
              lengths: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One rwkv6 block from state (x_prev, wkv float32, cm_prev).

    Returns (x, x_prev, cm_prev, wkv): the block's output and its new
    token-shift boundaries and recurrent state."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    tm_out, (xp, wkv) = S.rwkv6_timemix(
        h, S.Rwkv6Params(**bp["tm"]), cfg, pol, (x_prev, wkv), mask=mask,
        lengths=lengths)
    x, h = L.residual_norm(x, tm_out, bp["ln2"], cfg.norm_eps)
    x, cp = S.rwkv6_channelmix(h, S.Rwkv6ChannelParams(**bp["cm"]), cfg, pol,
                               cm_prev, lengths=lengths, residual=x)
    return x, xp, cp, wkv


def _zero_rec(cfg: ArchConfig, b: int, like: Tensor
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """A prefill's starting recurrent state: (x_prev, wkv, cm_prev)."""
    d, dk = cfg.d_model, cfg.d_model // cfg.n_heads
    zeros = torch.zeros((b, d), dtype=like.dtype, device=like.device)
    return (zeros, torch.zeros((b, cfg.n_heads, dk, dk), dtype=torch.float32,
                               device=like.device), zeros)


def _blocks(x: Tensor, params: Dict[str, Any], cfg: ArchConfig,
            pol: ExecutionPolicy) -> Tensor:
    """Every decoder block over the full sequence.  With ``cfg.remat``
    and a gradient to take, each block is a ``torch.utils.checkpoint``
    segment: its activations are recomputed in the backward, as the
    reference's ``jax.checkpoint`` of the scanned block body does."""
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, s)
    rope = _rope(positions, cfg) if cfg.family != "ssm" else None

    def block(x, bp, window):
        if cfg.family == "ssm":
            return ssm_block(x, bp, cfg, pol,
                             *_zero_rec(cfg, x.shape[0], x))[0]
        return block_forward(x, bp, cfg, pol, positions, window, rope)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(block, x, bp, int(windows[i]), use_reentrant=False)
        else:
            x = block(x, bp, int(windows[i]))
    return x


def forward(params: Dict[str, Any], batch: Dict[str, Tensor],
            cfg: ArchConfig, pol: Optional[ExecutionPolicy] = None) -> Tensor:
    """Full-sequence forward -> logits (B, S, V).  batch: {"tokens": (B,S)}."""
    pol = pol or cfg.exec_policy
    x = L.embedding_lookup(batch["tokens"], params["embed"])
    x = L.rms_norm(_blocks(x, params, cfg, pol), params["ln_f"], cfg.norm_eps)
    return L.dense(x, params["lm_head"], pol)


def loss_fn(params: Dict[str, Any], batch: Dict[str, Tensor],
            cfg: ArchConfig, pol: Optional[ExecutionPolicy] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"
    (B, S), optional "mask"}) plus the reference's auxiliary term, which
    is zero for the dense and ssm families.  Returns (loss, {"ce", "aux"}).
    """
    logits = forward(params, batch, cfg, pol)
    ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux / max(cfg.n_layers, 1), {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked per-layer state
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Stacked (n_layers leading dim) decode state.

    The dense family fills the K/V caches, the ssm family the recurrent
    fields; the others stay ``None``.  The ``*scale*`` fields carry the
    per-block float32 scales of the int8 cache (``CacheSpec(dtype=
    "int8")`` only).
    """
    cache_k: Optional[Tensor] = None    # (L, B, S, Hkv, dh)
    cache_v: Optional[Tensor] = None
    pos: Optional[Tensor] = None        # () tokens seen, or (B,) per slot
    x_prev: Optional[Tensor] = None     # (L, B, D) time-mix boundary token
    cm_prev: Optional[Tensor] = None    # (L, B, D) channel-mix boundary
    wkv: Optional[Tensor] = None        # (L, B, H, dk, dk) rwkv state
    scale_k: Optional[Tensor] = None    # (L, B, S, Hkv, 1) int8 mode only
    scale_v: Optional[Tensor] = None    # (L, B, S, Hkv, 1) int8 mode only
    wkv_scale: Optional[Tensor] = None  # (L, B, H, dk, 1) int8 mode only


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device) -> DecodeState:
    check_supported(cfg)
    dt = dtype_of(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    spec = cfg.cache_spec()
    qc = spec.quantized
    if cfg.family == "ssm":
        lr, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim_
        shape = (lr, batch, cfg.n_heads, dh, dh)
        return DecodeState(
            pos=pos,
            x_prev=torch.zeros((lr, batch, d), dtype=dt, device=device),
            cm_prev=torch.zeros((lr, batch, d), dtype=dt, device=device),
            wkv=torch.zeros(shape, device=device,
                            dtype=torch.int8 if qc else torch.float32),
            wkv_scale=(torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device) if qc else None))
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    kv_dt = torch.int8 if spec.dtype in ("int8", "fxp8") else dt

    def scales():
        return (torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                            device=device) if qc else None)

    return DecodeState(
        cache_k=torch.zeros(shape, dtype=kv_dt, device=device),
        cache_v=torch.zeros(shape, dtype=kv_dt, device=device),
        scale_k=scales(), scale_v=scales(), pos=pos)


def _store_rec(state: DecodeState, i: int, xp: Tensor, cp: Tensor,
               wkv: Tensor) -> None:
    """Write layer ``i``'s new recurrent state into ``state``, in place;
    the int8 mode quantizes the float32 wkv state once here."""
    state.x_prev[i] = xp
    state.cm_prev[i] = cp
    if state.wkv_scale is None:
        state.wkv[i] = wkv
    else:
        state.wkv[i], state.wkv_scale[i] = quantize_blocked(wkv)


def _layer_wkv(state: DecodeState, i: int) -> Tensor:
    """Layer ``i``'s wkv state as float32 (dequantized in the int8 mode)."""
    if state.wkv_scale is None:
        return state.wkv[i]
    return dequantize_blocked(state.wkv[i], state.wkv_scale[i])


def _layer_scales(state: DecodeState, i: int) -> Tuple[Tensor, ...]:
    """Layer ``i``'s K/V scale views (empty without per-block scales)."""
    if state.scale_k is None:
        return ()
    return state.scale_k[i], state.scale_v[i]


def _store_kv(state: DecodeState, i: int, k: Tensor, v: Tensor) -> None:
    """Write a prefill's layer-``i`` K/V (B, s, Hkv, dh) into positions
    [0, s) of ``state``'s caches, quantized as the cache format asks: per
    vector with its scale (int8), or at the fixed Q3.4 scale (fxp8)."""
    s = k.shape[1]
    for cache, scale, x in ((state.cache_k, state.scale_k, k),
                            (state.cache_v, state.scale_v, v)):
        if scale is not None:
            cache[i, :, :s], scale[i, :, :s] = quantize_blocked(x)
        elif cache.dtype == torch.int8:
            cache[i, :, :s] = A.quantize_kv(x)
        else:
            cache[i, :, :s] = x


def decode_step(params: Dict[str, Any], state: DecodeState,
                batch: Dict[str, Tensor], cfg: ArchConfig,
                pol: Optional[ExecutionPolicy] = None
                ) -> Tuple[Tensor, DecodeState]:
    """One new token for every sequence.  batch: {"tokens": (B, 1)}.

    Returns (logits (B, 1, V), state).  The new K/V (dense) or the new
    recurrent state (ssm; requantized per token in the int8 mode) land in
    ``state``'s tensors in place; the returned state shares them and
    advances ``pos``.
    """
    pol = pol or cfg.exec_policy
    x = L.embedding_lookup(batch["tokens"], params["embed"])
    b = x.shape[0]
    pos = state.pos
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, xp, cp, wkv = ssm_block(
                x, _layer(params["blocks"], i), cfg, pol, state.x_prev[i],
                _layer_wkv(state, i), state.cm_prev[i])
            _store_rec(state, i, xp, cp, wkv)
    else:
        cache_len = state.cache_k.shape[2]
        if cfg.sliding_window and cache_len <= cfg.sliding_window:
            # ring cache: every layer is windowed
            windows = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
        else:
            windows = layer_windows(cfg, cache_len)
        positions = (pos[:, None].to(torch.int32) if pos.dim() == 1
                     else pos.reshape(1).to(torch.int32))
        rope = _rope(positions, cfg)
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = A.qkv(h, _attn_params(bp), cfg, pol, rope)
            ctx = A.decode_attention(
                q, k, v, state.cache_k[i], state.cache_v[i], pos, cfg, pol,
                int(windows[i]), *_layer_scales(state, i))
            attn_out = L.dense(ctx.reshape(b, 1, -1), bp["attn"]["wo"], pol,
                               wide_scale=True)
            x = _ffn(x, attn_out, bp, cfg, pol)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.dense(x, params["lm_head"], pol)
    return logits, state._replace(pos=pos + 1)


def prefill(params: Dict[str, Any], batch: Dict[str, Tensor],
            cfg: ArchConfig, pol: Optional[ExecutionPolicy] = None,
            headroom: int = 64, lengths: Optional[Tensor] = None
            ) -> Tuple[Tensor, DecodeState]:
    """Full-sequence forward that also populates the decode state.

    Dense: the per-layer K/V land in a cache of length ``S + headroom``
    (quantized there under the int8 and fxp8 formats; the headroom
    positions and their scales stay 0).
    Ssm: the sequence folds into the O(1) recurrent state (quantized once
    at the end of each layer in the int8 mode).  ``lengths`` (B,) marks
    each row's true prompt length in a batch whose prompts are
    right-padded to a common bucket: causal attention already ignores the
    trailing pads for the real positions, pad steps are exact no-ops of
    the recurrent state, the returned logits are each row's last real
    position, and ``state.pos`` comes back per row.  Returns (logits
    (B, 1, V), state).
    """
    pol = pol or cfg.exec_policy
    x = L.embedding_lookup(batch["tokens"], params["embed"])
    b, s = x.shape[:2]
    state = init_decode_state(cfg, b, s + headroom, x.device)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device)
    if cfg.family == "ssm":
        mask = (None if lengths is None else
                torch.arange(s, device=x.device)[None, :] < lengths[:, None])
        for i in range(cfg.n_layers):
            x, xp, cp, wkv = ssm_block(
                x, _layer(params["blocks"], i), cfg, pol,
                *_zero_rec(cfg, b, x), mask=mask, lengths=lengths)
            _store_rec(state, i, xp, cp, wkv)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        windows = layer_windows(cfg, s)
        rope = _rope(positions, cfg)
        for i in range(cfg.n_layers):
            x, k, v = block_forward(x, _layer(params["blocks"], i), cfg, pol,
                                    positions, int(windows[i]), rope)
            _store_kv(state, i, k, v)
    if lengths is None:
        x_last = x[:, -1:, :]
        pos = torch.tensor(s, dtype=torch.int32, device=x.device)
    else:
        x_last = x[torch.arange(b, device=x.device), lengths.long() - 1][:, None]
        pos = lengths.to(torch.int32)
    x_last = L.rms_norm(x_last, params["ln_f"], cfg.norm_eps)
    logits = L.dense(x_last, params["lm_head"], pol)
    return logits, state._replace(pos=pos)


# ---------------------------------------------------------------------------
# Serving slots: per-slot state insertion (the continuous-batching seam)
# ---------------------------------------------------------------------------

def init_slot_state(cfg: ArchConfig, max_batch: int, max_seq: int,
                    device) -> DecodeState:
    """Decode state for ``max_batch`` persistent slots: ``pos`` per slot."""
    st = init_decode_state(cfg, max_batch, max_seq, device)
    return st._replace(pos=torch.zeros((max_batch,), dtype=torch.int32,
                                       device=device))


def slot_update(state: DecodeState, sub: DecodeState, slots) -> DecodeState:
    """Scatter ``sub``'s per-request state into ``state`` at slot indices,
    in place.

    ``sub`` is a prefill over a (bucket-padded) batch; ``slots`` (B_sub,)
    maps each ``sub`` row to a target slot.  Indices >= max_batch are
    dropped (the engine pads admission groups with a sentinel).  A prefill
    cache (and its scales) shorter than the slot cache is zero-padded
    along the sequence; the recurrent leaves (token-shift boundaries, wkv
    state and its scales) scatter along their batch axis.  Leaves move
    word for word: both states come from one model, so a leaf's dtype
    matches, and a float leaf never lands in an int8 one by a cast.
    """
    slots = torch.as_tensor(slots, dtype=torch.long)
    keep = (slots >= 0) & (slots < state.pos.shape[0])
    rows = torch.nonzero(keep).flatten()
    dst = slots[keep].to(state.pos.device)
    rows_dev = rows.to(state.pos.device)
    if state.cache_k is not None:
        s_src, s_tgt = sub.cache_k.shape[2], state.cache_k.shape[2]
        if s_src > s_tgt:
            raise ValueError(f"prefill cache ({s_src}) exceeds slot cache "
                             f"({s_tgt}); raise the engine's max_seq")
    for name in ("cache_k", "cache_v", "scale_k", "scale_v", "x_prev",
                 "cm_prev", "wkv", "wkv_scale"):
        tgt, src = getattr(state, name), getattr(sub, name)
        if tgt is None or src is None:
            continue
        if tgt.dtype != src.dtype:
            raise ValueError(f"slot_update: {name} is {src.dtype} in the "
                             f"prefill state and {tgt.dtype} in the slot "
                             f"state; both must come from one cache format")
        if name.startswith(("cache_", "scale_")):
            tgt[:, dst] = 0
            tgt[:, dst, :s_src] = src[:, rows_dev]
        else:
            tgt[:, dst] = src[:, rows_dev]
    pos = sub.pos.expand(slots.shape) if sub.pos.dim() == 0 else sub.pos
    state.pos[dst] = pos[rows_dev].to(state.pos.dtype)
    return state
