"""Straight-through gradients: a quantized forward, an exact float backward.

Every quantized or CORDIC forward of the port (the AFs, the W8A8 matmul,
the DA-VINCI kernels' float frontends) takes its gradient from the exact
float function through :func:`ste`.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch


class _Ste(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fwd, grad, *args):
        ctx.grad = grad
        ctx.save_for_backward(*args)
        return fwd(*args)

    @staticmethod
    def backward(ctx, g):
        args = [a.detach().requires_grad_(need)
                for a, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = ctx.grad(*args)
        needs = [a for a in args if a.requires_grad]
        got = iter(torch.autograd.grad(out, needs, g) if needs else ())
        return (None, None,
                *(next(got) if a.requires_grad else None for a in args))


def ste(fwd: Callable[..., torch.Tensor],
        grad: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """Quantized forward, exact float backward (straight-through).

    ``fwd`` runs the (non-differentiable) forward; the backward pass is
    the exact VJP of ``grad`` at the primal inputs.  Static configuration
    must already be bound into both callables; the result takes tensors
    only.
    """
    return functools.partial(_Ste.apply, fwd, grad)
