"""The port's wkv backward — kernel 7's checkpoints, the plain adjoint
sweep of kernel 9 and the differentiable frontend — against the JAX
reference, on the CPU.

The same numpy inputs go through ``repro``'s interpret-mode Pallas
kernels (``wkv_recurrence(..., return_residuals=True)``,
``wkv_recurrence_bwd``), its oracle ``wkv_bwd_ref`` and ``jax.vjp`` of
``repro.kernels.wkv``, and through the port's counterparts.  Bars:

* checkpoints: equal, word for word — the states are the single-rounding
  update the reference's compiler makes of ``w * S + kv`` (the same as
  ``tests/test_torch_wkv.py`` holds the int8 state to);
* gradients: atol = rtol = 2e-4, the reference's own band for its fused
  backward (``tests/test_kernel_grads.py``), sums in another order.

The CUDA kernels are held to these plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import ops as jops
from repro.kernels.wkv.kernel import wkv_recurrence as j_wkv
from repro.kernels.wkv.kernel_bwd import wkv_recurrence_bwd as j_wkv_bwd
from repro.kernels.wkv.ref import wkv_bwd_ref as j_bwd_ref
from repro_torch import kernels as K
from repro_torch.kernels import common
from repro_torch.kernels.wkv import ops
from repro_torch.kernels.wkv.ref import (wkv_bwd_ref, wkv_recurrence_bwd_ref,
                                         wkv_recurrence_ref)

torch.set_num_threads(2)

TOL = 2e-4
# (b, t, h, d): the reference's gradient test shapes (T = 24 and 40 do not
# tile by 64), plus a block that divides T into several
SHAPES = [(2, 32, 2, 8), (1, 64, 4, 16), (1, 24, 2, 4), (2, 40, 1, 8)]


def _inputs(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.1, 0.9, (b, t, h, d)).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    g = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return r, k, v, w, u, g


def _flat(x):
    b, t, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))


def _raw(r, k, v, w, u, g):
    b = r.shape[0]
    uu = np.ascontiguousarray(np.tile(u[None], (b, 1, 1)).reshape(
        -1, u.shape[-1]))
    return _flat(r), _flat(k), _flat(v), _flat(w), uu, _flat(g)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("block_t", [8, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_checkpoints_equal_reference(shape, block_t):
    """The reference's raw kernel clamps ``block_t`` to a divisor of T
    itself; the port's raw functions take the divisor, as ``ops.wkv``
    picks it."""
    r, k, v, w, u, _ = _raw(*_inputs(*shape))
    bt = common.largest_divisor(shape[1], block_t)
    out, ckpt = wkv_recurrence_ref(*_t(r, k, v, w, u), block_t=bt,
                                   return_residuals=True)
    j_out, j_ckpt = j_wkv(*map(jnp.asarray, (r, k, v, w, u)),
                          block_t=block_t, interpret=True,
                          return_residuals=True)
    assert ckpt.shape == j_ckpt.shape
    np.testing.assert_array_equal(ckpt.numpy(), np.asarray(j_ckpt))
    _close(out, j_out, 5e-5)


@pytest.mark.parametrize("block_t", [8, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_adjoint_sweep_matches_reference(shape, block_t):
    """The plain kernel 9 against the interpret-mode Pallas backward (same
    checkpoints), against ``repro``'s ``wkv_bwd_ref`` and against the
    port's own autograd oracle."""
    r, k, v, w, u, g = _raw(*_inputs(*shape, seed=1))
    bt = common.largest_divisor(shape[1], block_t)
    _, ckpt = wkv_recurrence_ref(*_t(r, k, v, w, u), block_t=bt,
                                 return_residuals=True)
    got = wkv_recurrence_bwd_ref(*_t(r, k, v, w, u, g), ckpt, block_t=bt)
    jr = list(map(jnp.asarray, (r, k, v, w, u, g)))
    _, j_ckpt = j_wkv(*jr[:5], block_t=block_t, interpret=True,
                      return_residuals=True)
    want = j_wkv_bwd(*jr, j_ckpt, block_t=block_t, interpret=True)
    exact = j_bwd_ref(*jr)
    mine = wkv_bwd_ref(*_t(r, k, v, w, u, g))
    for name, a, b_, c, d_ in zip("dr dk dv dw du".split(), got, want,
                                  exact, mine):
        assert a.dtype == torch.float32, name
        _close(a, b_)
        _close(a, c)
        _close(d_, c)


@pytest.mark.parametrize("shape", SHAPES)
def test_ops_gradient_matches_reference_vjp(shape):
    """``repro_torch.kernels.wkv`` forward and gradient against
    ``jax.vjp`` of ``repro.kernels.wkv`` (the fused path on both sides)."""
    r, k, v, w, u, g = _inputs(*shape, seed=2)
    out_j, vjp = jax.vjp(lambda *a: jops.wkv(*a),
                         *map(jnp.asarray, (r, k, v, w, u)))
    want = vjp(jnp.asarray(g))
    args = [a.requires_grad_(True) for a in _t(r, k, v, w, u)]
    common.reset_counts()
    out = K.wkv(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    assert common.get_kernel("wkv").plain_calls == 1
    assert common.get_kernel("wkv_bwd").plain_calls == 1
    _close(out.detach(), out_j, 5e-5)
    for a, b_ in zip(got, want):
        _close(a, b_)


def test_exact_backward_switch(monkeypatch):
    """``REPRO_FUSED_BWD=0``: the exact VJP of the float scan, kernel 9
    not called — the reference's ``_exact_wkv`` gradient."""
    r, k, v, w, u, g = _inputs(2, 16, 2, 8, seed=3)
    monkeypatch.setenv("REPRO_FUSED_BWD", "0")
    args = [a.requires_grad_(True) for a in _t(r, k, v, w, u)]
    common.reset_counts()
    got = torch.autograd.grad(K.wkv(*args), args, torch.from_numpy(g))
    assert common.get_kernel("wkv_bwd").plain_calls == 0
    _, vjp = jax.vjp(jops._exact_wkv, *map(jnp.asarray, (r, k, v, w, u)))
    for a, b_ in zip(got, vjp(jnp.asarray(g))):
        _close(a, b_)


def test_bwd_block_cap_and_spec():
    """The Hopper budget: 2**16 floats of recomputed state per row, with
    the reference's floor and cap."""
    assert ops.bwd_block_cap(64) == 16
    assert ops.bwd_block_cap(32) == 64
    assert ops.bwd_block_cap(8) == 512
    assert ops.bwd_block_cap(256) == 16
    spec = common.get_kernel("wkv_bwd")
    assert spec.replaces == "src/repro/kernels/wkv/kernel_bwd.py:96"
    assert spec.source == "src/repro_torch/kernels/wkv/csrc/wkv_bwd.cu"
