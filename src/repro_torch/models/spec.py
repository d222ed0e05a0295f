"""Parameter declarations and their initialisation.

Models declare parameters as :class:`P` leaves (shape, dtype, logical
axes, init rule) in a nested dict; :func:`materialize` turns that tree
into tensors on a device, leaf by leaf, from one seeded
``torch.Generator``.  The draws are torch's own: a model that must equal
the JAX reference takes the reference's parameters through
:func:`repro_torch.convert.params_from_numpy` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter."""

    shape: Tuple[int, ...]
    axes: Axes
    dtype: torch.dtype = torch.float32
    init: str = "normal"         # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def tree_map_specs(fn: Callable[[P], Any], tree):
    if isinstance(tree, P):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def n_params(tree) -> int:
    total = 0

    def count(p: P):
        nonlocal total
        total += math.prod(p.shape)

    tree_map_specs(count, tree)
    return total


def _init_one(p: P, gen: torch.Generator, device: torch.device
              ) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "scaled":  # fan-in scaled normal
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = 1.0 / math.sqrt(fan_in)
    elif p.init == "normal":
        std = p.scale
    else:
        raise ValueError(f"unknown init {p.init!r}")
    out = torch.empty(p.shape, dtype=p.dtype, device=device)
    # draw in float32 one leading slice at a time, so a stacked
    # (layers, ...) leaf never holds a float32 copy of itself
    for view in (out if out.dim() >= 3 else [out]):
        view.copy_(torch.randn(view.shape, generator=gen, device=device)
                   * std)
    return out


def to_device(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The same nested dict of tensors, moved to ``device``."""
    return {k: (to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def materialize(tree, seed: int, device) -> Dict[str, Any]:
    """Initialise real tensors on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map_specs(lambda p: _init_one(p, gen, device), tree)
