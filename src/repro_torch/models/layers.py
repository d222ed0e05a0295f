"""Common model layers, routed through the ExecutionPolicy so the paper's
CORDIC datapath (FxP8 MAC + DA-VINCI AFs) is an execution mode of every
architecture."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ExecutionPolicy
from repro_torch.core import libm
from repro_torch.core.activations import activate
from repro_torch.core.quantization import QuantPolicy, quantized_dense
from repro_torch.kernels.cordic_mac.ops import cordic_matmul


def dense(x: torch.Tensor, w: torch.Tensor, policy: ExecutionPolicy,
          bias: Optional[torch.Tensor] = None, *,
          wide_scale: bool = False) -> torch.Tensor:
    """Matmul through the policy-selected datapath.  ``wide_scale``: the
    W8A8 product is rescaled as the reference's compiled decoder block
    rescales it (:mod:`repro_torch.core.quantization`); the projections
    of a block pass it, the head after the blocks does not (the reference
    runs it op by op)."""
    if policy.matmul == "bf16":
        out = x @ w.to(x.dtype)
    elif policy.matmul == "cordic_kernel":
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        out = cordic_matmul(x2, w.to(torch.float32))
        out = out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)
    elif policy.matmul == "fxp8":
        out = quantized_dense(x, w, policy.quant, wide_scale=wide_scale)
    elif policy.matmul == "fxp8_weight":
        out = quantized_dense(x, w, QuantPolicy(act_bits=None))
    else:
        raise ValueError(f"unknown matmul mode {policy.matmul!r}")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def af(x: torch.Tensor, name: str, policy: ExecutionPolicy, axis: int = -1
       ) -> torch.Tensor:
    """Activation through DA-VINCI when the policy enables CORDIC AFs.

    The CORDIC path computes in float32 (dequantized fixed point); the
    result is cast back so residual-stream dtypes are stable under any
    policy."""
    return activate(x, name, policy.af, axis=axis).to(x.dtype)


def softmax(x: torch.Tensor, policy: ExecutionPolicy, axis: int = -1
            ) -> torch.Tensor:
    if policy.softmax_cordic and policy.af is not None:
        return activate(x, "softmax", policy.af, axis=axis).to(x.dtype)
    return torch.softmax(x, dim=axis)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMS norm in float32, the result in ``dtype`` (default ``x``'s)."""
    dtype = dtype or x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dtype) * gamma.to(dtype)


def residual_norm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x + y`` and the RMS norm of it: ``(x + y, rms_norm(x + y))``.

    The reference's compiled block feeds the norm the sum's float32 value,
    not rounded to ``x``'s dtype first (its compiler drops a round trip
    through bfloat16 that is converted back to float32 next), while the
    residual stream carries the rounded sum.  In float32 the two are the
    same."""
    s32 = x.to(torch.float32) + y.to(torch.float32)
    return s32.to(x.dtype), rms_norm(s32, gamma, eps, dtype=x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """(..., head_dim/2) rotary angles for integer positions.

    The inverse frequencies ``1 / theta**(2i / head_dim)`` are constants
    of the reference's compiled model, which folds them in float64 and
    rounds once to float32; so does this."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64,
                                             device=positions.device),
                                exponent.to(torch.float64))).to(torch.float32)
    return positions.to(torch.float32)[..., None] * inv_freq


def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of :func:`rope_angles`, float32 (..., S, head_dim/2):
    the reference's ``sinf``/``cosf`` (:mod:`repro_torch.core.libm`).  A
    model call computes them once and every layer's :func:`apply_rope`
    reads them."""
    angles = rope_angles(positions, head_dim, theta)
    return libm.sin(angles), libm.cos(angles)


def apply_rope(x: torch.Tensor, sincos: Tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """x: (..., S, H, D); ``sincos`` from :func:`rope_sincos`, (..., S,
    D/2) each, broadcast over heads.  In float32 the rotation's first
    product of each sum is fused with the add, as the reference's
    compiler contracts them."""
    sin = sincos[0][..., None, :].to(x.dtype)
    cos = sincos[1][..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if x.dtype == torch.float32:
        return torch.cat([libm.fma(x1, cos, -(x2 * sin)),
                          libm.fma(x1, sin, x2 * cos)], dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, policy: ExecutionPolicy,
           act: str = "silu") -> torch.Tensor:
    """The gated FFN of a decoder block (its projections ``wide_scale``)."""
    g = dense(x, w_gate, policy, wide_scale=True)
    u = dense(x, w_up, policy, wide_scale=True)
    return dense(af(g, act, policy) * u, w_down, policy, wide_scale=True)


def embedding_lookup(tokens: torch.Tensor, table: torch.Tensor
                     ) -> torch.Tensor:
    return table[tokens]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over the valid positions, in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
