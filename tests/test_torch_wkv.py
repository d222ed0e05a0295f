"""The port's wkv kernels' plain versions and frontends against the JAX
reference, on the CPU.

The same numpy inputs go through ``repro``'s plain versions, its Pallas
kernels in interpret mode, its ``(B, T, H, d)`` frontends, and the port's
counterparts (a CPU tensor takes the plain version).  Bars:

* the recurrence's output ``y``: within atol = rtol = 5e-5, the band of
  the reference's own kernel tests (a sum in another order);
* the int8 state's words and its float32 scales: equal, word for word —
  the state update is the fused multiply-add the reference's compiler
  makes of ``w * S + kv``, and the requantization is
  ``quantize_blocked``'s (true division, half-to-even rounding).

The reference has no test of ``wkv_recurrence_q8``; these are its first.
The kernels themselves are held to these plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant_cache as jqc
from repro.kernels.wkv import ops as jops
from repro.kernels.wkv.kernel import wkv_recurrence as j_wkv_kernel
from repro.kernels.wkv.kernel_q8 import wkv_recurrence_q8 as j_q8_kernel
from repro.kernels.wkv.ref import wkv_q8_ref as j_q8_ref
from repro.kernels.wkv.ref import wkv_recurrence_ref as j_wkv_ref
from repro_torch import kernels as K
from repro_torch.core import libm
from repro_torch.core import quant_cache as qc
from repro_torch.kernels import common
from repro_torch.kernels.wkv.ops import wkv_recurrence, wkv_recurrence_q8
from repro_torch.kernels.wkv.ref import wkv_q8_ref, wkv_recurrence_ref

torch.set_num_threads(2)

TOL = 5e-5
# (B, T, H, d): the reference's kernel test shapes
SHAPES = [(4, 64, 16, 16), (2, 128, 32, 32), (8, 32, 8, 8)]


def _inputs(b, t, h, d, seed=0, dtype=np.float32):
    """r, k, v, w (B, T, H, d) with w in (0.5, 1) and u (H, d)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)).astype(dtype) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (b, t, h, d)).astype(dtype)
    u = rng.normal(size=(h, d)).astype(dtype)
    return r, k, v, w, u


def _state(b, h, d, seed=1):
    rng = np.random.default_rng(seed)
    s0 = rng.integers(-127, 128, (b, h, d, d)).astype(np.int8)
    sc = rng.uniform(0.0, 0.1, (b, h, d)).astype(np.float32)
    return s0, sc


def _flat(x):
    b, t, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))


def _raw(r, k, v, w, u):
    """The raw (BH, T, d) layout, u tiled to (BH, d)."""
    b = r.shape[0]
    return (*map(_flat, (r, k, v, w)),
            np.ascontiguousarray(np.tile(u[None], (b, 1, 1)).reshape(
                -1, u.shape[-1])))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference_ref_and_kernel(shape):
    raw = _raw(*_inputs(*shape))
    got = wkv_recurrence_ref(*_t(*raw)).numpy()
    j = [jnp.asarray(a) for a in raw]
    _close(got, j_wkv_ref(*j))
    _close(got, j_wkv_kernel(*j, interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
def test_q8_plain_version_matches_reference_ref_and_kernel(shape):
    b, t, h, d = shape
    raw = _raw(*_inputs(*shape, seed=2))
    s0, sc = _state(b, h, d)
    s0, sc = s0.reshape(b * h, d, d), sc.reshape(b * h, d)
    out, q, scale = wkv_q8_ref(*_t(*raw, s0, sc))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    for ref in (j_q8_ref(*[jnp.asarray(a) for a in (*raw, s0, sc)]),
                j_q8_kernel(*[jnp.asarray(a) for a in (*raw, s0, sc)],
                            interpret=True)):
        _close(out, ref[0])
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(ref[2]))


def test_plain_versions_take_bfloat16_inputs():
    """bf16 r, k, v, w and float32 u, as the served model makes them; the
    output in r's dtype."""
    r, k, v, w, u = _raw(*_inputs(2, 24, 4, 16, seed=3))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v, w)]
    got = wkv_recurrence_ref(*bf, torch.from_numpy(u))
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in bf]
    want = j_wkv_ref(*j, jnp.asarray(u))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_frontends_match_reference(shape):
    """The (B, T, H, d) entry points ``repro_torch.kernels.wkv`` and
    ``wkv_q8`` against ``repro.kernels.wkv.ops``; on CPU tensors each call
    takes the plain version once."""
    b, t, h, d = shape
    r, k, v, w, u = _inputs(*shape, seed=4)
    s0, sc = _state(b, h, d, seed=5)
    common.reset_counts()
    got = K.wkv(*_t(r, k, v, w, u))
    assert got.shape == (b, t, h, d)
    _close(got, jops.wkv(*map(jnp.asarray, (r, k, v, w, u))))
    out, q, scale = K.wkv_q8(*_t(r, k, v, w, u, s0, sc), block_t=16)
    want = jops.wkv_q8(*map(jnp.asarray, (r, k, v, w, u, s0, sc)))
    _close(out, want[0])
    assert q.shape == (b, h, d, d) and scale.shape == (b, h, d)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want[2]))
    for name in ("wkv", "wkv_q8"):
        spec = common.get_kernel(name)
        assert (spec.launches, spec.plain_calls) == (0, 1)


def test_q8_zero_state_and_saturated_rows():
    """A zero state (scale 0), rows whose state stays zero (k = 0: scale 0,
    words 0), and rows of +-127 words with large scales: words and scales
    equal to the reference's."""
    b, t, h, d = 2, 7, 4, 16
    r, k, v, w, u = _inputs(b, t, h, d, seed=6)
    k[:, :, 1] = 0.0                   # head 1 never writes its state
    raw = _raw(r, k, v, w, u)
    zero = np.zeros((b * h, d, d), np.int8)
    zsc = np.zeros((b * h, d), np.float32)
    sat = np.where(np.random.default_rng(7).random((b * h, d, d)) < 0.5,
                   127, -127).astype(np.int8)
    ssc = np.full((b * h, d), 3.0, np.float32)
    for s0, sc in ((zero, zsc), (sat, ssc)):
        out, q, scale = wkv_q8_ref(*_t(*raw, s0, sc))
        want = j_q8_ref(*[jnp.asarray(a) for a in (*raw, s0, sc)])
        _close(out, want[0])
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want[2]))
        assert np.abs(q.numpy()).max() == 127
    # rows of head 1 (rows 1 and 5) kept the zero state: scale 0, words 0
    out, q, scale = wkv_q8_ref(*_t(*raw, zero, zsc))
    assert torch.all(scale[[1, 5]] == 0) and torch.all(q[[1, 5]] == 0)


def _fma_nearest(a, b, c):
    """The float32 nearest the exact a * b + c (ties to even), in
    rational arithmetic."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(np.array(x).view(np.int32)) & 1))


def test_fma_exact_rounds_once():
    """The plain wkv state update, ``libm.fma_exact``, is the float32
    nearest the exact ``a * b + c`` (the kernel's ``fmaf``, the reference's
    contracted FMA), including a double-rounding tie where the float64
    emulation ``libm.fma`` rounds twice."""
    rng = np.random.default_rng(7)
    n = 4000
    a, b, c = (rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n)
               for _ in range(3))
    a, b = a.astype(np.float32), b.astype(np.float32)
    c = np.where(rng.random(n) < 0.5, -(a.astype(np.float64) * b), c)
    c = (c * (1 + rng.normal(size=n) * 2.0 ** -20)).astype(np.float32)
    # 1 + 2**-24 + 2**-60: float64 rounds it to the float32 midpoint
    # 1 + 2**-24, which then rounds to even (1.0); the nearest is 1 + 2**-23
    tie = np.array([2.0 ** -24 * (1 + 2.0 ** -12), 1 - 2.0 ** -12 + 2.0 ** -24,
                    1.0], np.float32)
    a, b, c = (np.concatenate([x, [tie[i], -tie[i] if i != 1 else tie[i]]])
               .astype(np.float32) for i, x in enumerate((a, b, c)))
    got = libm.fma_exact(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_fma_nearest(*x) for x in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-2] == np.float32(1 + 2.0 ** -23) == -got[-1]
    emulated = libm.fma(*(torch.from_numpy(x[-2:]) for x in (a, b, c)))
    assert emulated.tolist() == [1.0, -1.0]


@pytest.mark.parametrize("block", [None, 4])
def test_quantize_blocked_bit_equal(block):
    """Per-vector and divisor blocks, all-zero blocks included (scale 0,
    exact zeros back); the round trip too."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(3, 5, 16)) * rng.uniform(0, 4, (3, 5, 1))).astype(
        np.float32)
    x[1, 2] = 0.0
    x[2, :, :4] = 0.0
    q, s = qc.quantize_blocked(torch.from_numpy(x), block)
    jq, js = jqc.quantize_blocked(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.all(s[1, 2] == 0)
    back = qc.dequantize_blocked(q, s)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jqc.dequantize_blocked(jq, js)))
    assert torch.all(back[1, 2] == 0)
    with pytest.raises(ValueError, match="divide"):
        qc.quantize_blocked(torch.from_numpy(x), 5)


def test_backward_raises_naming_the_training_slice():
    """Named for the slice before training, when the backward raised: the
    fused backward is now ported, so a backward through ``wkv`` runs, and
    its gradient of every input equals ``jax.vjp`` of ``repro``'s
    ``wkv`` within the reference's 2e-4 band
    (``tests/test_torch_wkv_bwd.py`` holds each piece on its own)."""
    arrays = _inputs(1, 4, 2, 8, seed=9)
    _, vjp = jax.vjp(lambda *a: jops.wkv(*a), *map(jnp.asarray, arrays))
    g = np.ones((1, 4, 2, 8), np.float32)
    args = [a.requires_grad_(True) for a in _t(*arrays)]
    K.wkv(*args).sum().backward()
    for a, want in zip(args, vjp(jnp.asarray(g))):
        torch.testing.assert_close(a.grad, torch.from_numpy(
            np.array(want)), atol=2e-4, rtol=2e-4)


def test_specs_and_dispatch():
    """The registry names each kernel's TPU original and CUDA source; mixed
    devices raise (a CUDA tensor never takes the plain version)."""
    for name, line in (("wkv", "src/repro/kernels/wkv/kernel.py:66"),
                       ("wkv_q8", "src/repro/kernels/wkv/kernel_q8.py:69")):
        spec = common.get_kernel(name)
        assert spec.replaces == line
        assert spec.source == "src/repro_torch/kernels/wkv/csrc/wkv.cu"
    r, k, v, w, u = _t(*_raw(*_inputs(1, 3, 2, 8)))
    torch.testing.assert_close(wkv_recurrence(r, k, v, w, u),
                               wkv_recurrence_ref(r, k, v, w, u), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        wkv_recurrence_q8(r, k, v, w, u, torch.zeros((2, 8, 8), dtype=torch.int8,
                                                     device="meta"),
                          torch.zeros((2, 8)))
