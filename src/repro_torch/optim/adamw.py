"""AdamW with optionally int8-quantized moments, as the reference's
``repro/optim/adamw.py``.

Moments are stored per parameter as float32, or as int8 with one float32
absmax scale per slice of the last axis, dequantized inside the update and
requantized after it (error-compensated).  The second moment is stored in
sqrt space with a half-step floor on dequantization, so ``1/sqrt(v)``
stays bounded.  Also: decoupled weight decay on matrices, bias-corrected
betas, global-norm clipping, linear warmup then cosine decay, and
pruning masks that keep pruned weights exactly zero.

The reference's update is traced and compiled under ``jit``; its
compiler rewrites a division by a constant, ``x / 127.0``, as a
multiplication by the float32 reciprocal, and so does this module
(:func:`_div_const`).

Unlike the reference's pure function, :func:`update` writes the new
parameters and moments into the given tensors, in place: at rwkv6-3b's
3.07 B parameters a second copy of each would not fit beside the first.
Leaves of at least ``BLOCK_SCAN_MIN`` elements with three or more axes
are updated one leading slice at a time, which bounds the float32
temporaries to that slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

BLOCK_SCAN_MIN = 1 << 28        # elements
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"      # float32 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class QMoment(NamedTuple):
    """int8 moment + per-row float32 scale (second moments in sqrt
    space; which moment is which is positional, m vs v)."""
    q: torch.Tensor
    scale: torch.Tensor


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any
    v: Any


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, as the reference's compiled update
    evaluates it: times the float32 reciprocal of ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def _quantize_moment(m: torch.Tensor, sqrt_space: bool = False) -> QMoment:
    v = torch.sqrt(torch.clamp(m, min=0.0)) if sqrt_space else m
    amax = v.abs() if v.dim() == 0 else v.abs().amax(-1, keepdim=True)
    scale = torch.clamp(_div_const(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return QMoment(q, scale.to(_F32))


def _dequantize_moment(qm: QMoment, sqrt_space: bool = False
                       ) -> torch.Tensor:
    v = qm.q.to(_F32)
    if sqrt_space:
        # half-step floor: a stored zero means "below scale/2", not 0
        v = torch.clamp(v.abs(), min=0.5) * qm.scale
        return v * v
    return v * qm.scale


def _map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``, float32."""
    step = step.to(_F32)
    warm = _div_const(step, max(cfg.warmup_steps, 1))
    t = _div_const(step - cfg.warmup_steps,
                   max(cfg.total_steps - cfg.warmup_steps, 1))
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments beside ``params`` (float32, or int8 + scales)."""
    def zero_like(sqrt_space):
        def f(p):
            z = torch.zeros(p.shape, dtype=_F32, device=p.device)
            return _quantize_moment(z, sqrt_space) if \
                cfg.moment_dtype == "int8" else z
        return f
    leaf = next(_leaves(params))
    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      _map(zero_like(False), params),
                      _map(zero_like(True), params))


def global_norm(tree) -> torch.Tensor:
    total = None
    for g in _leaves(tree):
        sq = torch.sum(torch.square(g.to(_F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update_block(cfg, p, g, m, v, mask, *, gscale, lr, c1, c2) -> None:
    """One AdamW step of one tensor, written into p, m and v."""
    b1, b2 = cfg.beta1, cfg.beta2
    quant = cfg.moment_dtype == "int8"
    g = g.to(_F32) * gscale
    m_f = _dequantize_moment(m, False) if quant else m
    v_f = _dequantize_moment(v, True) if quant else v
    m_f = b1 * m_f + (1 - b1) * g
    v_f = b2 * v_f + (1 - b2) * g * g
    delta = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
    p32 = p.to(_F32)
    if p.dim() >= 2:            # decoupled decay on matrices only
        delta = delta + cfg.weight_decay * p32
    new_p = p32 - lr * delta
    if mask is not None:
        new_p = new_p * mask
    p.copy_(new_p)
    for old, new, sqrt_space in ((m, m_f, False), (v, v_f, True)):
        if quant:
            qm = _quantize_moment(new, sqrt_space)
            old.q.copy_(qm.q)
            old.scale.copy_(qm.scale)
        else:
            old.copy_(new)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params, masks=None
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, {"grad_norm",
    "lr"}): the same parameter tensors and moments, updated, and the
    state's new step."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        gscale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                             / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        gscale = torch.ones((), dtype=_F32, device=gnorm.device)
    lr = lr_at(cfg, step)
    stepf = step.to(_F32)
    c1 = 1.0 - torch.pow(torch.full_like(stepf, cfg.beta1), stepf)
    c2 = 1.0 - torch.pow(torch.full_like(stepf, cfg.beta2), stepf)
    kw = dict(gscale=gscale, lr=lr, c1=c1, c2=c2)
    if masks is None:
        masks = _map(lambda _: None, params)

    def upd(p, g, m, v, mask):
        if p.dim() >= 3 and p.numel() >= BLOCK_SCAN_MIN and mask is None:
            slices = zip(p, g, *((m.q, m.scale) if isinstance(m, QMoment)
                                 else (m,)),
                         *((v.q, v.scale) if isinstance(v, QMoment)
                           else (v,)))
            for sl in slices:
                if isinstance(m, QMoment):
                    pi, gi, mq, ms, vq, vs = sl
                    mi, vi = QMoment(mq, ms), QMoment(vq, vs)
                else:
                    pi, gi, mi, vi = sl
                _update_block(cfg, pi, gi, mi, vi, None, **kw)
        else:
            _update_block(cfg, p, g, m, v, mask, **kw)

    _map_leaves(upd, params, grads, state.m, state.v, masks)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                         "lr": lr}


def _map_leaves(fn, p, g, m, v, mask) -> None:
    """``fn`` over the leaves of ``p`` with the matching entries of the
    other trees (a QMoment or a None mask is one entry)."""
    if isinstance(p, dict):
        for k in p:
            _map_leaves(fn, p[k], g[k], m[k], v[k], mask[k])
    else:
        fn(p, g, m, v, mask)
