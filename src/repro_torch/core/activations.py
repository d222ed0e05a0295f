"""DA-VINCI: Dynamically-configurable Activation functions via CORDIC.

One shared CORDIC datapath (hyperbolic rotation + linear vectoring +
linear rotation) realises every AF the paper lists — tanh, sigmoid,
SoftMax, ReLU, GeLU, SeLU, Swish — selected at run time by ``name`` under
a :class:`CordicPolicy`.  These are the model's CORDIC AFs: float-emulated
fixed point through :mod:`repro_torch.core.cordic`, op for op as the
reference's ``core/activations.py``.  (The ``cordic_act`` and
``cordic_softmax`` kernels run integer Q(frac+4) recurrences instead and
differ from these by up to 0.06; the model path does not call them.)

Gradients: every CORDIC forward is exposed through a straight-through
estimator, the exact function's gradient.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import cordic
from repro_torch.core import fixed_point as fxp
from repro_torch.core import libm
from repro_torch.core.fixed_point import FxpFormat
from repro_torch.core.ste import ste

SUPPORTED_AFS = ("relu", "tanh", "sigmoid", "softmax", "gelu", "selu",
                 "swish", "silu", "exp", "identity")

_SELU_ALPHA = 1.6732632423543772
_SELU_LAMBDA = 1.0507009873554805
_GELU_C = math.sqrt(2.0 / math.pi)


@dataclasses.dataclass(frozen=True)
class CordicPolicy:
    """Runtime-reconfigurable RPE datapath configuration (the ``sel_*`` pins).

    ``n_linear/n_hyperbolic/n_division`` mirror the paper's 5+2
    architecture defaults; ``bits`` selects FxP4/8/16/32; ``range_extend``
    is the barrel-shift exponent scaling that lets the AFs take LLM-scale
    inputs.
    """

    bits: int = 16
    n_linear: int = cordic.N_LINEAR_STAGES
    n_hyperbolic: int = cordic.N_HYPERBOLIC_STAGES
    n_division: int = cordic.N_DIVISION_STAGES
    range_extend: bool = True
    rounding: str = "rne"

    @property
    def fmt(self) -> FxpFormat:
        return fxp.format_for_bits(self.bits)


DEFAULT_POLICY = CordicPolicy()
PAPER_FAITHFUL_POLICY = CordicPolicy(bits=8, range_extend=False)


# ---------------------------------------------------------------------------
# Raw (non-differentiable) CORDIC forwards
# ---------------------------------------------------------------------------

def _tanh_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    # tanh(a) = sinh(a)/cosh(a); beyond the hyperbolic range use
    # tanh(a) = (e^{2a}-1)/(e^{2a}+1) with the range-extended exp, on the
    # always-negative branch a = -|x| so e^{2a} stays in (0, 1].
    fmt = p.fmt
    if p.range_extend:
        e2a = cordic.exp_fxp(-2.0 * torch.abs(x), fmt, p.n_hyperbolic, True)
        t_neg = cordic.divide(e2a - 1.0, e2a + 1.0, fmt,
                              max(p.n_division, fmt.frac_bits))
        return torch.where(x >= 0, -t_neg, t_neg)
    c, s = cordic.cosh_sinh(x, fmt, p.n_hyperbolic)
    return cordic.divide(s, c, fmt, max(p.n_division, fmt.frac_bits))


def _sigmoid_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    # Paper eq (1c): sigmoid = 1/(1+e^-x), hyperbolic stage then division
    # stage; e^{-|x|} <= 1 keeps every intermediate in range, and the
    # positive branch uses sigmoid(x) = 1 - sigmoid(-x).
    fmt = p.fmt
    e = cordic.exp_fxp(-torch.abs(x), fmt, p.n_hyperbolic, p.range_extend)
    s = cordic.divide(torch.ones_like(e), 1.0 + e, fmt,
                      max(p.n_division, fmt.frac_bits))
    return torch.where(x >= 0, s, 1.0 - s)


def _exp_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    return cordic.exp_fxp(x, p.fmt, p.n_hyperbolic, p.range_extend)


def _softmax_fwd(x: torch.Tensor, p: CordicPolicy, axis: int = -1
                 ) -> torch.Tensor:
    # RPE flow: exponentials stream through the hyperbolic stage into the
    # FIFO while the running sum accumulates, then the division stage
    # normalises each entry (Section 2.3).  Max-subtraction keeps e^a in
    # (0, 1]; the divider runs at guarded precision, with zero-skip for
    # underflowed exponentials.
    fmt = p.fmt
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    e = cordic.exp_fxp(x - m, fmt, p.n_hyperbolic, p.range_extend)
    e = fxp.roundtrip(e, fmt)            # the FIFO stores fmt-width words
    tot = torch.sum(e, dim=axis, keepdim=True)
    gfmt = dataclasses.replace(fmt, total_bits=min(fmt.total_bits + 8, 32),
                               frac_bits=min(fmt.frac_bits + 4, 20))
    # Normalise the denominator into [1, 2) with a barrel shift so the
    # divider converges: q = (e >> k) / (tot >> k).
    k = torch.ceil(libm.log2(torch.clamp(tot, min=1e-30)))
    scale = libm.exp2(k)
    q = cordic.divide(e / scale, tot / scale, gfmt,
                      max(p.n_division, gfmt.frac_bits))
    return torch.where(e == 0.0, 0.0, q)


def _gelu_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    # tanh-form GeLU; the two extra multiplies run on the linear stage.
    x_q = fxp.roundtrip(x, p.fmt, p.rounding)
    inner = _GELU_C * (x_q + 0.044715 * x_q * x_q * x_q)
    t = _tanh_fwd(inner, p)
    return 0.5 * x_q * (1.0 + t)


def _selu_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    e = cordic.exp_fxp(torch.clamp(x, max=0.0), p.fmt, p.n_hyperbolic,
                       p.range_extend)
    neg = _SELU_ALPHA * (e - 1.0)
    return _SELU_LAMBDA * torch.where(x > 0, fxp.roundtrip(x, p.fmt), neg)


def _swish_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    return fxp.roundtrip(x, p.fmt) * _sigmoid_fwd(x, p)


def _relu_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    # Single-cycle bypass (FSM case 3): the sign mux and the quantizer.
    return torch.clamp(fxp.roundtrip(x, p.fmt, p.rounding), min=0.0)


def _identity_fwd(x: torch.Tensor, p: CordicPolicy) -> torch.Tensor:
    return fxp.roundtrip(x, p.fmt, p.rounding)


_FWD = {
    "relu": _relu_fwd, "tanh": _tanh_fwd, "sigmoid": _sigmoid_fwd,
    "softmax": _softmax_fwd, "gelu": _gelu_fwd, "selu": _selu_fwd,
    "swish": _swish_fwd, "silu": _swish_fwd, "exp": _exp_fwd,
    "identity": _identity_fwd,
}


# ---------------------------------------------------------------------------
# Exact functions and the straight-through wrapper
# ---------------------------------------------------------------------------

def _logistic(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` one rounded op at a time in ``x``'s dtype,
    ``exp`` as :mod:`~repro_torch.core.libm`'s and subnormal results
    flushed: the reference's sigmoid, bit for bit in float32 and bfloat16
    (``torch.sigmoid`` rounds differently)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return libm.flush(one / (one + libm.exp(-x)))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as the reference rounds and flushes it."""
    return libm.flush(x * _logistic(x))


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` as the reference evaluates it (:func:`libm.tanh`, in
    float32, rounded to ``x``'s dtype): ``torch.tanh`` differs in the
    last bits of most float32 inputs."""
    return libm.tanh(x).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, one rounded op at a time in
    ``x``'s dtype, its tanh the reference's (:func:`_tanh`)."""
    c = libm.const(math.sqrt(2 / math.pi), x)
    inner = c * (x + libm.const(0.044715, x) * (x * (x * x)))
    return x * (0.5 * (1.0 + _tanh(inner)))


def _exact(name: str, axis: int = -1) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """The exact float AF: torch's, except tanh, gelu, sigmoid and silu,
    whose forward is the reference's evaluation (gradients stay
    torch's)."""
    return {
        "relu": torch.relu,
        "tanh": _tanh,
        "sigmoid": ste(_logistic, torch.sigmoid),
        "softmax": functools.partial(torch.softmax, dim=axis),
        "gelu": ste(_gelu_tanh, functools.partial(F.gelu,
                                                  approximate="tanh")),
        "selu": F.selu,
        "swish": ste(_silu, F.silu),
        "silu": ste(_silu, F.silu),
        "exp": torch.exp,
        "identity": lambda x: x,
    }[name]


def activate(x: torch.Tensor, name: str,
             policy: Optional[CordicPolicy] = None, axis: int = -1
             ) -> torch.Tensor:
    """Apply activation ``name``.

    ``policy=None`` selects the exact float function; otherwise the
    bit-accurate CORDIC forward with the exact function's gradient (STE).
    The CORDIC forward returns float32, as the reference's does.
    """
    if name not in SUPPORTED_AFS:
        raise ValueError(f"unsupported AF {name!r}; choose from "
                         f"{SUPPORTED_AFS}")
    if policy is None:
        return _exact(name, axis)(x)
    fwd = _FWD[name]
    if name == "softmax":
        fwd = functools.partial(fwd, axis=axis)
    return ste(functools.partial(fwd, p=policy), _exact(name, axis))(x)


def reuse_report() -> dict:
    """Which RPE stage each AF exercises (the paper's reuse-factor table)."""
    hyp = {"tanh", "sigmoid", "softmax", "gelu", "selu", "swish", "silu",
           "exp"}
    div = {"tanh", "sigmoid", "softmax", "gelu", "swish", "silu"}
    afs = [a for a in SUPPORTED_AFS if a not in ("identity",)]
    return {
        "hyperbolic_reuse": len(hyp & set(afs)) / len(afs),
        "division_reuse": len(div & set(afs)) / len(afs),
        "afs": afs,
    }
