"""The decoder LM, dense family: forward, prefill and single-token decode.

Parameters are a nested dict of tensors with the JAX reference's layout:
every per-layer leaf is stacked along a leading ``layers`` axis, and the
layers run as a plain Python loop over it.  The other families (moe,
ssm, hybrid, audio, vlm) are refused here; ROADMAP queue 1 items 8 and 10
port them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ExecutionPolicy
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.spec import P

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what this port does not run yet, naming the ROADMAP item."""
    if cfg.family != "dense" or cfg.input_kind != "tokens" or cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"runs the dense family (ROADMAP queue 1, items 8 and 10 port "
            f"the recurrent and remaining families)")
    spec = cfg.cache_spec()
    if spec.dtype != "native" or spec.paged:
        raise NotImplementedError(
            f"{cfg.name}: cache {spec} is not ported yet; the port serves "
            f"the native unpaged cache (ROADMAP queue 1, items 11 and 13)")
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
    return {
        "embed": P((cfg.vocab_size, D), ("vocab", "embed"), dtype=dt),
        "ln_f": P((D,), ("embed",), init="ones"),
        "lm_head": P((D, cfg.vocab_size), ("embed", "vocab"), dtype=dt,
                     init="scaled"),
        "blocks": {
            "ln1": ly(D, axes=("embed",), init="ones"),
            "ln2": ly(D, axes=("embed",), init="ones"),
            "attn": attn,
            "ffn": {
                "w_gate": ly(D, F, axes=("embed", "mlp"), init="scaled"),
                "w_up": ly(D, F, axes=("embed", "mlp"), init="scaled"),
                "w_down": ly(F, D, axes=("mlp", "embed"), init="scaled"),
            },
        },
    }


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


def _ffn(x: Tensor, bp: Dict[str, Any], cfg: ArchConfig,
         pol: ExecutionPolicy) -> Tensor:
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    f = bp["ffn"]
    return x + L.swiglu(h, f["w_gate"], f["w_up"], f["w_down"], pol,
                        cfg.activation)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def block_forward(x: Tensor, bp: Dict[str, Any], cfg: ArchConfig,
                  pol: ExecutionPolicy, positions: Tensor, window
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """One decoder block over a full sequence.  Returns (x, k, v)."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = A.qkv(h, _attn_params(bp), cfg, pol, positions)
    ctx = A.attention(q, k, v, cfg, pol, positions, positions, window)
    x = x + L.dense(ctx.reshape(*x.shape[:2], -1), bp["attn"]["wo"], pol)
    return _ffn(x, bp, cfg, pol), k, v


def forward(params: Dict[str, Any], batch: Dict[str, Tensor],
            cfg: ArchConfig, pol: Optional[ExecutionPolicy] = None) -> Tensor:
    """Full-sequence forward -> logits (B, S, V).  batch: {"tokens": (B,S)}."""
    pol = pol or cfg.exec_policy
    x = L.embedding_lookup(batch["tokens"], params["embed"])
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, s)
    for i in range(cfg.n_layers):
        x, _, _ = block_forward(x, _layer(params["blocks"], i), cfg, pol,
                                positions, int(windows[i]))
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.dense(x, params["lm_head"], pol)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked per-layer caches
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Stacked (n_layers leading dim) decode state of the dense family."""
    cache_k: Tensor                     # (L, B, S, Hkv, dh)
    cache_v: Tensor
    pos: Tensor                         # () tokens seen, or (B,) per slot


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device) -> DecodeState:
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    dt = dtype_of(cfg)
    return DecodeState(
        cache_k=torch.zeros(shape, dtype=dt, device=device),
        cache_v=torch.zeros(shape, dtype=dt, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params: Dict[str, Any], state: DecodeState,
                batch: Dict[str, Tensor], cfg: ArchConfig,
                pol: Optional[ExecutionPolicy] = None
                ) -> Tuple[Tensor, DecodeState]:
    """One new token for every sequence.  batch: {"tokens": (B, 1)}.

    Returns (logits (B, 1, V), state).  The new K/V land in ``state``'s
    caches in place; the returned state shares them and advances ``pos``.
    """
    pol = pol or cfg.exec_policy
    x = L.embedding_lookup(batch["tokens"], params["embed"])
    b = x.shape[0]
    pos = state.pos
    cache_len = state.cache_k.shape[2]
    if cfg.sliding_window and cache_len <= cfg.sliding_window:
        # ring cache: every layer is windowed
        windows = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    else:
        windows = layer_windows(cfg, cache_len)
    positions = (pos[:, None].to(torch.int32) if pos.dim() == 1
                 else pos.reshape(1).to(torch.int32))
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = A.qkv(h, _attn_params(bp), cfg, pol, positions)
        ctx = A.decode_attention(q, k, v, state.cache_k[i], state.cache_v[i],
                                 pos, cfg, pol, int(windows[i]))
        x = x + L.dense(ctx.reshape(b, 1, -1), bp["attn"]["wo"], pol)
        x = _ffn(x, bp, cfg, pol)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.dense(x, params["lm_head"], pol)
    return logits, state._replace(pos=pos + 1)


def prefill(params: Dict[str, Any], batch: Dict[str, Tensor],
            cfg: ArchConfig, pol: Optional[ExecutionPolicy] = None,
            headroom: int = 64, lengths: Optional[Tensor] = None
            ) -> Tuple[Tensor, DecodeState]:
    """Full-sequence forward that also populates the decode state.

    The per-layer K/V land in a cache of length ``S + headroom``.
    ``lengths`` (B,) marks each row's true prompt length in a batch whose
    prompts are right-padded to a common bucket: causal attention already
    ignores the trailing pads for the real positions, the returned logits
    are each row's last real position, and ``state.pos`` comes back per
    row.  Returns (logits (B, 1, V), state).
    """
    pol = pol or cfg.exec_policy
    x = L.embedding_lookup(batch["tokens"], params["embed"])
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    windows = layer_windows(cfg, s)
    state = init_decode_state(cfg, b, s + headroom, x.device)
    for i in range(cfg.n_layers):
        x, k, v = block_forward(x, _layer(params["blocks"], i), cfg, pol,
                                positions, int(windows[i]))
        state.cache_k[i, :, :s] = k
        state.cache_v[i, :, :s] = v
    if lengths is None:
        x_last = x[:, -1:, :]
        pos = torch.tensor(s, dtype=torch.int32, device=x.device)
    else:
        lengths = torch.as_tensor(lengths, device=x.device)
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
    cache shorter than the slot cache is zero-padded along the sequence.
    """
    slots = torch.as_tensor(slots, dtype=torch.long)
    keep = (slots >= 0) & (slots < state.pos.shape[0])
    rows = torch.nonzero(keep).flatten()
    dst = slots[keep].to(state.pos.device)
    rows_dev = rows.to(state.pos.device)
    s_src, s_tgt = sub.cache_k.shape[2], state.cache_k.shape[2]
    if s_src > s_tgt:
        raise ValueError(f"prefill cache ({s_src}) exceeds slot cache "
                         f"({s_tgt}); raise the engine's max_seq")
    for name in ("cache_k", "cache_v"):
        tgt, src = getattr(state, name), getattr(sub, name)
        tgt[:, dst] = 0
        tgt[:, dst, :s_src] = src[:, rows_dev].to(tgt.dtype)
    pos = sub.pos.expand(slots.shape) if sub.pos.dim() == 0 else sub.pos
    state.pos[dst] = pos[rows_dev].to(state.pos.dtype)
    return state
