"""The port's W8A8 path (``core/quantization.py``) against the JAX
reference, on the CPU.

Bit-exact, float32 and bfloat16 alike: ``quantize_weight`` and
``quantize_act`` (int8 words and scales, per channel and per tensor, pow-2
scales on and off, with amax / 127 planted at powers of two and one ulp
either side, where ``ceil(log2(.))`` decides the scale), ``int8_matmul``,
``fake_quant`` and ``quantized_dense`` W8A8.  W8A16 is a float matmul, so
it is held to 1e-6 in float32.  Gradients are straight-through: the float
matmul's, within an ``atol`` of 1e-5 (float32 sums in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as tq

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]


def _np(a):
    """float32/int8 numpy view of a jax array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
    return np.asarray(a)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = got.reshape(-1).view(np.uint8) != want.reshape(-1).view(np.uint8)
    assert not bad.any(), f"{int(bad.sum())} bytes differ"


def _pair(x, dtype):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _weights(rng, k=64, n=96):
    """Normal weights whose column amax / 127 sits at a power of two, or
    one ulp above or below it."""
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    amax = (127 * np.float32(2.0) ** (np.arange(n) % 12 - 14)).astype(
        np.float32)
    amax[::3] = np.nextafter(amax[::3], np.float32(np.inf))
    amax[1::3] = np.nextafter(amax[1::3], np.float32(0))
    w[0] = amax
    return w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("pow2", [True, False])
def test_quantize_weight_matches_reference(dtype, per_channel, pow2, rng):
    jw, tw = _pair(_weights(rng), dtype)
    jp = jq.QuantPolicy(per_channel=per_channel, pow2_scale=pow2)
    tp = tq.QuantPolicy(per_channel=per_channel, pow2_scale=pow2)
    for axis in (-1, 0):
        (jq_, js), (tq_, ts) = (jq.quantize_weight(jw, jp, axis),
                                tq.quantize_weight(tw, tp, axis))
        assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
        _same(tq_, jq_)
        _same(ts, js)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pow2", [True, False])
def test_quantize_act_matches_reference(dtype, pow2, rng):
    jp = jq.QuantPolicy(pow2_scale=pow2)
    tp = tq.QuantPolicy(pow2_scale=pow2)
    for k in range(-12, 6):
        amax = np.float32(127 * 2.0 ** k)
        x = rng.normal(size=(5, 64)).astype(np.float32)
        x *= amax / np.abs(x).max()
        for edge in (amax, np.nextafter(amax, np.float32(np.inf)),
                     np.nextafter(amax, np.float32(0))):
            x[0, 0] = edge
            jx, tx = _pair(x, dtype)
            (jq_, js), (tq_, ts) = (jq.quantize_act(jx, jp),
                                    tq.quantize_act(tx, tp))
            _same(tq_, jq_)
            _same(ts, js)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_act_wide_scale_matches_compiled_reference(dtype, rng):
    """``wide_scale=True``: the words and the float32 scale of the
    reference's ``quantize_act`` compiled by ``jax.jit``, which rescales by
    ``exp2``'s float32 value where op by op it rounds it to bfloat16
    first (in float32 the two agree)."""
    jp, tp = jq.QuantPolicy(), tq.QuantPolicy()
    compiled = jax.jit(functools.partial(jq.quantize_act, policy=jp))
    wider = 0
    for k in range(-12, 6):
        for j in range(4):
            x = (rng.normal(size=(4, 32)) * 2.0 ** k * (1 + j / 4)).astype(
                np.float32)
            jx, tx = _pair(x, dtype)
            (jq_, js), (tq_, ts) = (compiled(jx),
                                    tq.quantize_act(tx, tp, wide_scale=True))
            _same(tq_, jq_)
            _same(ts, js)
            wider += ts.item() != tq.quantize_act(tx, tp)[1].item()
    assert wider == 0 if dtype == "float32" else wider > 0


def test_int8_matmul_matches_reference(rng):
    x_q = rng.integers(-127, 128, (3, 5, 136)).astype(np.int8)
    w_q = rng.integers(-127, 128, (136, 40)).astype(np.int8)
    x_s = np.float32(2.0 ** -7)
    w_s = (2.0 ** rng.integers(-12, -3, (1, 40))).astype(np.float32)
    want = jq.int8_matmul(jnp.asarray(x_q), jnp.asarray(w_q),
                          jnp.asarray(x_s), jnp.asarray(w_s))
    got = tq.int8_matmul(torch.from_numpy(x_q), torch.from_numpy(w_q),
                         torch.tensor(x_s), torch.from_numpy(w_s))
    _same(got, want)
    # the int32 accumulator is exact at glm4-9b's widest K
    big = torch.full((2, 13696), 127, dtype=torch.int8)
    acc = tq.int8_matmul(big, big.T.contiguous(), torch.tensor(1.0),
                         torch.ones(1, 2))
    assert acc[0, 0].item() == 127 * 127 * 13696
    # odd K and N: zero padding adds nothing
    a = rng.integers(-127, 128, (4, 13)).astype(np.int8)
    b = rng.integers(-127, 128, (13, 5)).astype(np.int8)
    np.testing.assert_array_equal(
        tq._int_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_dense_matches_reference(dtype, rng):
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(_weights(rng), dtype)
    want = jq.quantized_dense(jx, jw, jq.QuantPolicy())
    got = tq.quantized_dense(tx, tw, tq.QuantPolicy())
    assert got.dtype == tx.dtype and got.shape == (2, 7, 96)
    _same(got, want)
    want = jq.quantized_dense(jx, jw, jq.QuantPolicy(act_bits=None))
    got = tq.quantized_dense(tx, tw, tq.QuantPolicy(act_bits=None))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    _same(tq.quantized_dense(tx, tw, None), jx @ jw)


def test_fake_quant_and_ste_gradients(rng):
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 24)) * 0.1).astype(np.float32)
    pol, jpol = tq.QuantPolicy(), jq.QuantPolicy()
    tx = torch.from_numpy(x).requires_grad_(True)
    _same(tq.fake_quant(tx, pol).detach(),
          jq.fake_quant(jnp.asarray(x), jpol))
    g, = torch.autograd.grad(tq.fake_quant(tx, pol).sum(), tx)
    assert torch.equal(g, torch.ones_like(g))
    for p, jp in ((pol, jpol), (tq.QuantPolicy(act_bits=None),
                                jq.QuantPolicy(act_bits=None))):
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        gx, gw = torch.autograd.grad(
            (tq.quantized_dense(tx, tw, p) ** 2).sum(), (tx, tw))
        # straight-through: the float matmul's VJP at the quantized output
        out = tq.quantized_dense(tx, tw, p).detach()
        torch.testing.assert_close(gx, 2 * out @ tw.detach().T, rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(gw, tx.detach().T @ (2 * out), rtol=0,
                                   atol=1e-5)
        jgx, jgw = jax.grad(lambda a, b: (jq.quantized_dense(a, b, jp) ** 2
                                          ).sum(), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=0,
                                   atol=1e-5)


def test_policy_fields_match_reference():
    assert dataclasses.asdict(tq.QuantPolicy()) == \
        dataclasses.asdict(jq.QuantPolicy())
    assert tq.QuantPolicy().qmax == 127 == tq.QuantPolicy().act_qmax
    with pytest.raises(ValueError):
        tq.QuantPolicy(act_bits=None).act_qmax
