"""Pruning / sparsity co-design (CAESAR's quantization + pruning).

The paper reports a 40 % magnitude-pruning rate with no per-layer
accuracy loss (§4.2) and cites "commercial 4:9" structured pruning (§4.3).
Both, as in the reference (``repro/core/pruning.py``):

* unstructured magnitude pruning of one tensor at a target rate,
* N:M structured pruning (keep the N largest of every M contiguous
  weights along an axis),

plus the masks for prune-then-fine-tune training (``Trainer(masks=...)``:
pruned weights stay exactly zero) and sparsity bookkeeping.  Parameter
trees are nested dicts of tensors; a leaf that is not pruned has the
mask ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PruningPolicy:
    """Sparsity configuration consumed by CAESAR.

    ``rate`` — unstructured magnitude-pruning fraction (paper: 0.40).
    ``n``/``m`` — optional N:M structured pattern (paper cites 4:9).
    """

    rate: float = 0.40
    n: Optional[int] = None
    m: Optional[int] = None

    @property
    def structured(self) -> bool:
        return self.n is not None and self.m is not None

    @property
    def effective_density(self) -> float:
        if self.structured:
            return self.n / self.m
        return 1.0 - self.rate


def magnitude_mask(w: torch.Tensor, rate: float) -> torch.Tensor:
    """Boolean keep-mask pruning the smallest-|w| ``rate`` fraction: the
    threshold is the k-th smallest magnitude, k = round(size * rate), and
    every weight at or below it is pruned (ties included)."""
    if rate <= 0.0:
        return torch.ones_like(w, dtype=torch.bool)
    k = int(round(w.numel() * rate))
    if k >= w.numel():
        return torch.zeros_like(w, dtype=torch.bool)
    mag = w.abs()
    if k == 0:
        return torch.ones_like(w, dtype=torch.bool)
    thresh = torch.sort(mag.reshape(-1)).values[k - 1]
    return mag > thresh


def nm_mask(w: torch.Tensor, n: int, m: int, axis: int = -1) -> torch.Tensor:
    """N:M structured keep-mask along ``axis``: every group of ``m``
    consecutive weights (the last one zero-padded) keeps its ``n`` largest
    magnitudes; among equal magnitudes the later weight ranks higher, as
    the reference's stable ascending argsort ranks them."""
    axis = axis % w.dim()
    w_moved = torch.movedim(w, axis, -1)
    lead = w_moved.shape[:-1]
    size = w_moved.shape[-1]
    pad = (-size) % m
    w_pad = torch.nn.functional.pad(w_moved, (0, pad))
    groups = w_pad.reshape(*lead, -1, m)
    order = torch.argsort(groups.abs(), dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    keep = (ranks >= (m - n)).reshape(*lead, -1)[..., :size]
    return torch.movedim(keep, -1, axis)


def apply_policy(w: torch.Tensor, policy: PruningPolicy, axis: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (pruned weights, keep mask)."""
    if policy.structured:
        mask = nm_mask(w, policy.n, policy.m, axis)
    else:
        mask = magnitude_mask(w, policy.rate)
    return w * mask, mask


def _map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def prune_tree(params: Dict[str, Any], policy: PruningPolicy,
               min_size: int = 1024, axis: int = -1):
    """Prune every weight matrix of a parameter tree (leaves with >= 2
    dims and >= ``min_size`` elements; embeddings of fewer elements, norms
    and biases stay dense).  Returns (pruned params, masks), masks ``None``
    for unpruned leaves."""
    pruned = _map(lambda w: (apply_policy(w, policy, axis)
                             if w.dim() >= 2 and w.numel() >= min_size
                             else (w, None)), params)
    return _map(lambda pm: pm[0], pruned), _map(lambda pm: pm[1], pruned)


def mask_grads(grads: Dict[str, Any], masks: Dict[str, Any]):
    """Zero the gradients of pruned weights, so fine-tuning keeps the
    sparsity."""
    return _map(lambda g, m: g if m is None else g * m, grads, masks)


def sparsity_stats(params: Dict[str, Any], masks: Dict[str, Any]
                   ) -> Dict[str, float]:
    total = kept = 0

    def count(w, m):
        nonlocal total, kept
        if m is not None:
            total += w.numel()
            kept += int(m.sum())

    _map(count, params, masks)
    return {"prunable_params": total, "kept_params": kept,
            "sparsity": 0.0 if total == 0 else 1.0 - kept / total}
