"""Quantized (FxP8) matmul path: the CORDIC MAC at production scale.

The paper's linear-mode CORDIC MAC resolves about 5 fractional bits in 5
stages; its production mapping is a symmetric int8 matmul with power-of-two
scales (a barrel shift on the RPE), as in the reference's
``core/quantization.py``: W8A8 with per-output-channel weight scales and
one dynamic scale per activation tensor, or W8A16 (weights only).  The
product of two int8 tensors is exact in int32 (127**2 * 13696 < 2**31 at
glm4-9b's widest K), so it may run as a library int8 GEMM
(``torch._int_mm``) without changing a bit.

Scales stay in the activations' dtype, as the reference's do: under
bfloat16, ``amax / 127``, ``log2``, ``ceil``, ``exp2`` and ``x / scale``
each round to bfloat16, and ``exp2`` of an integer is not always a power
of two there (it is 127 at 7); only the returned scale is float32.
``log2`` and ``exp2`` come from :mod:`repro_torch.core.libm`.  The
reference's compiled decoder block (its ``jax.lax.scan`` body) keeps one
rounding fewer: its compiler drops the round trip of the activation
scale through bfloat16 that ``scale.astype(float32)`` makes, so the int32
products are rescaled by ``exp2``'s float32 value while ``x`` is divided
by the rounded scale.  ``wide_scale=True`` reproduces that (in float32
the two are the same).

The activation scale spans every row of ``x``: a request's tokens depend
on its batch-mates, pads and idle serving slots included, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import libm
from repro_torch.core.ste import ste


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-layer quantization policy scheduled by CAESAR."""

    bits: int = 8
    per_channel: bool = True        # per-output-channel weight scales
    pow2_scale: bool = True         # power-of-two scales (a barrel shift)
    act_bits: Optional[int] = 8     # None => activations stay float (W8A16)

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def act_qmax(self) -> int:
        if self.act_bits is None:
            raise ValueError("act_bits is None: activations are not "
                             "quantized (W8A16)")
        return (1 << (self.act_bits - 1)) - 1


def _pow2_scale(scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exp2(ceil(log2(max(scale, 1e-12))))`` in ``scale``'s dtype, and
    the float32 value of its ``exp`` before that rounding."""
    dt = scale.dtype
    c = torch.ceil(libm.log2(torch.maximum(scale, libm.const(1e-12, scale))))
    wide = libm.exp((c.to(torch.float32) * libm.ln2_in(dt)).to(dt)
                    .to(torch.float32))
    return wide.to(dt), wide


def quantize_weight(w: torch.Tensor, policy: QuantPolicy, axis: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric weight quantization -> (int8 raw, float32 scale).

    ``axis`` is the output-channel axis kept un-reduced by the matmul.  The
    int8 words are laid out with that axis outermost (column-major for a
    (K, N) weight): the int8 GEMM reads B so, and the cast writes it so at
    no extra cost.
    """
    keep = axis % w.dim()
    if policy.per_channel:
        dims = tuple(i for i in range(w.dim()) if i != keep)
        amax = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    else:
        amax = torch.amax(torch.abs(w))
    scale = amax / libm.const(policy.qmax, amax)
    if policy.pow2_scale:
        scale = _pow2_scale(scale)[0]
    scale = torch.maximum(scale, libm.const(1e-12, scale))
    q = torch.clamp(torch.round(w / scale), -policy.qmax, policy.qmax)
    out = torch.empty(q.movedim(keep, 0).shape, dtype=torch.int8,
                      device=q.device).movedim(0, keep)
    return out.copy_(q), scale.to(torch.float32)


def quantize_act(x: torch.Tensor, policy: QuantPolicy, *,
                 wide_scale: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric activation quantization.  With
    ``wide_scale`` the returned pow-2 scale is the float32 value before
    its rounding to ``x``'s dtype, as the reference's compiled block
    rescales by it (module docstring)."""
    amax = torch.amax(torch.abs(x))
    scale = torch.maximum(amax / libm.const(policy.act_qmax, amax),
                          libm.const(1e-12, amax))
    wide = None
    if policy.pow2_scale:
        scale, wide = _pow2_scale(scale)
    q = torch.clamp(torch.round(x / scale), -policy.act_qmax,
                    policy.act_qmax)
    return q.to(torch.int8), (wide if wide_scale and wide is not None
                              else scale.to(torch.float32))


def _fake_quant_fwd(x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    q, s = quantize_act(x, policy)
    return q.to(torch.float32) * s


def fake_quant(x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """STE quantize-dequantize (QAT view of the tensor)."""
    return ste(functools.partial(_fake_quant_fwd, policy=policy),
               lambda v: v)(x)


# torch._int_mm on a card takes more than 16 rows and K, N in multiples of
# 8; zero rows and columns add nothing to an exact integer product.  Its
# cuBLASLt call also refuses a row-major B when K <= 96 and M < 32 (H100,
# torch 2.11, CUDA 12.8), and takes a column-major B at every shape, so B
# is handed over column-major (as quantize_weight lays it out).
_MIN_ROWS = 17
_MULTIPLE = 8


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact."""
    m, k = a.shape
    n = b.shape[1]
    pad_m = max(_MIN_ROWS - m, 0)
    pad_k = -k % _MULTIPLE
    pad_n = -n % _MULTIPLE
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    if b.stride(0) != 1:
        b = b.t().contiguous().t()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n]


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 -> rescale: ``acc * x_scale * w_scale``, in
    that order, in float32."""
    lead = x_q.shape[:-1]
    acc = _int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(*lead, w_q.shape[-1])
    return acc.to(torch.float32) * x_scale * torch.squeeze(w_scale)


def _quantized_forward(x: torch.Tensor, w: torch.Tensor,
                       policy: QuantPolicy, wide_scale: bool = False
                       ) -> torch.Tensor:
    w_q, w_s = quantize_weight(w, policy, axis=-1)
    if policy.act_bits is None:
        return x @ (w_q.to(x.dtype) * w_s.to(x.dtype))
    x_q, x_s = quantize_act(x, policy, wide_scale=wide_scale)
    return int8_matmul(x_q, w_q, x_s, w_s).to(x.dtype)


def quantized_dense(x: torch.Tensor, w: torch.Tensor,
                    policy: Optional[QuantPolicy], *,
                    wide_scale: bool = False) -> torch.Tensor:
    """Dense layer on the CORDIC-FxP8 execution path, STE backward.

    policy None   -> plain matmul (baseline);
    act_bits None -> weight-only quantization (W8A16);
    else          -> W8A8 int8 matmul, rescaled by the activation scale
                     :func:`quantize_act` gives with ``wide_scale``.
    """
    if policy is None:
        return x @ w
    return ste(functools.partial(_quantized_forward, policy=policy,
                                 wide_scale=wide_scale),
               torch.matmul)(x, w)
