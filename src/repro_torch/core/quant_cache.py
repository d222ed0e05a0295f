"""Per-block int8 quantization for serving caches (here: the recurrent state).

The serving stack's quantized cache mode stores a cache leaf as int8
values plus one float32 scale per trailing block:

    scale = max(|x_block|) * (1/127)    (0 for an all-zero block)
    q     = clip(round(x / scale), -127, 127)
    x̂     = q * scale

with the block along the tensor's trailing channel axis (for the rwkv
wkv state: the value channel, one scale per dk row).  The default block
spans the whole trailing axis.  Bit-exact with the reference's
``core/quant_cache.py``: the divisor, not the stored scale, is clamped
at 1e-30, so an all-zero block keeps scale 0 and dequantizes to exact
zeros; the division is a true division by a tensor; rounding is half to
even.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Guard for all-zero blocks (see the module docstring).
_TINY = 1e-30
_INV_127 = 1.0 / 127.0


def quantize_blocked(x: torch.Tensor, block: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the trailing axis in blocks of ``block`` channels.

    Returns ``(values int8, scales float32)`` with ``values.shape ==
    x.shape`` and ``scales.shape == x.shape[:-1] + (d // block,)``.
    ``block=None`` uses the whole trailing axis (one scale per vector).
    """
    d = x.shape[-1]
    block = d if block is None else int(block)
    if block < 1 or d % block != 0:
        raise ValueError(f"block {block} must divide the trailing axis {d}")
    xb = x.to(torch.float32).reshape(*x.shape[:-1], d // block, block)
    scale = xb.abs().amax(dim=-1) * _INV_127     # float32(1/127)
    div = torch.clamp(scale, min=_TINY)[..., None]
    q = torch.clamp(torch.round(xb / div), -127.0, 127.0)
    return q.to(torch.int8).reshape(x.shape), scale


def dequantize_blocked(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blocked`: ``q * scale`` per block.

    ``q`` int8 (..., d); ``scale`` float32 (..., d // block).  The block
    width is recovered from the shapes.
    """
    d = q.shape[-1]
    nb = scale.shape[-1]
    if nb < 1 or d % nb != 0:
        raise ValueError(f"scale blocks {nb} must divide trailing axis {d}")
    xb = (q.to(torch.float32).reshape(*q.shape[:-1], nb, d // nb)
          * scale[..., None].to(torch.float32))
    return xb.reshape(q.shape).to(dtype)
