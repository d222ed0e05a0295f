"""The port's CORDIC core against the JAX reference, bit for bit, on the CPU.

The same numpy inputs go through ``repro.core`` and ``repro_torch.core``
(``cordic``, the ``fixed_point`` additions and the DA-VINCI ``activate``);
every output must be equal bit for bit (float32 words, int32 words, and
the Python constants of the schedules).  STE gradients are the exact
functions', within 1e-6.  The float range extensions take
their exponents from ``exp2``/``log2``, so ``core/libm.py`` is held to the
reference's ``jnp.exp``/``jnp.log``/``jnp.exp2``/``jnp.log2`` too, on
wide inputs and at powers of two and one ulp either side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activations as ja
from repro.core import cordic as jc
from repro.core import fixed_point as jfxp
from repro_torch.core import activations as ta
from repro_torch.core import cordic as tc
from repro_torch.core import fixed_point as fxp
from repro_torch.core import libm

torch.set_num_threads(2)

FMTS = {"FXP8": fxp.FXP8, "FXP16": fxp.FXP16, "FXP32": fxp.FXP32}
JFMTS = {"FXP8": jfxp.FXP8, "FXP16": jfxp.FXP16, "FXP32": jfxp.FXP32}


def _same(got, want):
    """Bit-equal float32 (or int32) words; a NaN equals any NaN (payloads
    differ between the libraries and mean nothing)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    both_nan = np.zeros(got.shape, bool)
    if got.dtype == np.float32:
        both_nan = np.isnan(got) & np.isnan(want)
        got, want = got.view(np.int32), want.view(np.int32)
    bad = (got != want) & ~both_nan
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} words differ; "
                           f"first at {np.argwhere(bad)[0]}")


def _both(fn_j, fn_t, *arrays):
    """Run a reference function and its port on the same numpy inputs."""
    return (fn_j(*[jnp.asarray(a) for a in arrays]),
            fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays]))


def _pow2_edges(lo: int, hi: int) -> np.ndarray:
    """Powers of two in [2**lo, 2**hi) and one float32 ulp either side."""
    p = np.float32(2.0) ** np.arange(lo, hi).astype(np.float32)
    return np.concatenate([p, np.nextafter(p, np.float32(np.inf)),
                           np.nextafter(p, np.float32(0))]).astype(np.float32)


# ---------------------------------------------------------------------------
# libm: the reference's float32 exp/log/tanh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["exp", "log", "exp2", "log2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_libm_matches_reference(name, dtype, rng):
    if name.startswith("exp"):
        x = np.concatenate([rng.uniform(-100, 100, 20000),
                            rng.uniform(-2, 2, 20000), np.arange(-160, 140),
                            [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40]])
    else:
        x = np.concatenate([rng.uniform(1e-6, 1e4, 20000),
                            np.exp(rng.uniform(-87, 88, 20000)),
                            _pow2_edges(-126, 127),
                            [0.0, -0.0, -1.0, np.inf, np.nan, 1e-40]])
    x = x.astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(getattr(jnp, name)(jx).astype(jnp.float32))
    got = getattr(libm, name)(tx)
    assert got.dtype == tx.dtype
    _same(got.to(torch.float32), want)


def test_libm_tanh_matches_reference(rng):
    """XLA's CPU tanh (the decay of rwkv6's time-mix): bit-equal on 40 k
    normal inputs, a wide uniform range, the clamp at +-7.99881172 and
    its neighbours, the small-x and saturated branches, signed zeros,
    infinities and NaN; eager and jitted ``jnp.tanh`` alike."""
    clamp = np.float32(7.998811721801758)
    x = np.concatenate([
        rng.normal(0.0, 2.0, 40000), rng.uniform(-25, 25, 10000),
        rng.normal(0.0, 1e-3, 2000),
        [clamp, np.nextafter(clamp, np.float32(0)),
         np.nextafter(clamp, np.float32(9)), -clamp, 0.0004, -0.0004,
         np.float32(0.0004) * np.float32(0.999), 20.0, -20.0, 19.999998,
         0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40]]).astype(np.float32)
    got = libm.tanh(torch.from_numpy(x))
    _same(got, jnp.tanh(jnp.asarray(x)))
    _same(got, jax.jit(jnp.tanh)(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_sigmoid_and_silu_match_reference(dtype, rng):
    """The exact (policy-free) sigmoid and silu/swish are the reference's
    ``1 / (1 + exp(-x))`` rounded op by op in the input's dtype: bit-equal
    to ``repro``'s on 40 k inputs; gradients stay torch's."""
    x = np.concatenate([rng.normal(0.0, 3.0, 40000),
                        [0.0, -0.0, 88.0, -88.0, 1e-30, np.inf,
                         -np.inf]]).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for name in ("sigmoid", "silu", "swish"):
        got = ta.activate(tx, name)
        assert got.dtype == tx.dtype
        _same(got.to(torch.float32),
              np.asarray(ja.activate(jx, name).astype(jnp.float32)))
    tx = torch.from_numpy(x[:64]).requires_grad_(True)
    g, = torch.autograd.grad(ta.activate(tx, "sigmoid").sum(), tx)
    s = torch.sigmoid(tx.detach())
    torch.testing.assert_close(g, s * (1 - s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_tanh_and_gelu_match_reference(dtype, rng):
    """The exact (policy-free) tanh and gelu are the reference's
    ``jnp.tanh`` (:func:`libm.tanh`) and ``jax.nn.gelu(approximate=True)``
    spelled out op by op: bit-equal on 40 k inputs and the edges, where
    ``torch.tanh`` and ``F.gelu`` differ in the last bits; gradients stay
    torch's."""
    x = np.concatenate([rng.normal(0.0, 3.0, 40000), rng.uniform(-9, 9, 4000),
                        [0.0, -0.0, 7.998811721801758, -20.0, 1e-30, np.inf,
                         -np.inf, np.nan]]).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for name in ("tanh", "gelu"):
        got = ta.activate(tx, name)
        assert got.dtype == tx.dtype
        _same(got.to(torch.float32),
              np.asarray(ja.activate(jx, name).astype(jnp.float32)))
    tx = torch.from_numpy(x[:64]).requires_grad_(True)
    g, = torch.autograd.grad(ta.activate(tx, "gelu").sum(), tx)
    tx2 = tx.detach().requires_grad_(True)
    want, = torch.autograd.grad(
        torch.nn.functional.gelu(tx2, approximate="tanh").sum(), tx2)
    torch.testing.assert_close(g, want)


def test_libm_sin_cos_match_reference(rng):
    """The rotary embedding's ``jnp.sin``/``jnp.cos`` (the C library's
    ``sinf``/``cosf``): bit-equal on both reductions (below and from 120),
    the thresholds, huge arguments, signed zeros, infinities and NaN;
    eager and jitted alike."""
    x = np.concatenate([
        rng.uniform(-1, 1, 20000), rng.uniform(-130, 130, 40000),
        rng.uniform(-5000, 5000, 20000),
        np.exp(rng.uniform(-30, 88, 10000)) * rng.choice([-1, 1], 10000),
        np.arange(-300, 300), [0.0, -0.0, 2.0 ** -12, 2.0 ** -13, 120.0,
                               -120.0, 119.99999, 0.78125, 0.7853982, 3e38,
                               np.inf, -np.inf, np.nan]]).astype(np.float32)
    for name in ("sin", "cos"):
        got = getattr(libm, name)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        _same(got, getattr(jnp, name)(jnp.asarray(x)))
        _same(got, jax.jit(getattr(jnp, name))(jnp.asarray(x)))


def test_libm_log2_is_not_exact_at_powers_of_two():
    """The reference's log2(2**-15) is -14.999999, so ceil gives -14; the
    port must give the same, not the exact exponent."""
    x = torch.tensor([2.0 ** -15], dtype=torch.float32)
    got = libm.log2(x)
    assert got.item() != -15.0 and torch.ceil(got).item() == -14.0
    _same(got, jnp.log2(jnp.float32(2.0 ** -15)).reshape(1))


# ---------------------------------------------------------------------------
# fixed_point additions
# ---------------------------------------------------------------------------

def test_fixed_point_helpers_match_reference(rng):
    for v in (0.5, 2.5, -1.5, 1 / 3, 1.4426950408889634, 30.0, 1e-3):
        for fb in (0, 4, 8, 12, 24):
            assert fxp.constant_raw(v, fb) == jfxp.constant_raw(v, fb)
    for bits in (4, 8, 16, 32):
        assert dataclasses.asdict(fxp.format_for_bits(bits)) == \
            dataclasses.asdict(jfxp.format_for_bits(bits))
    with pytest.raises(KeyError):
        fxp.format_for_bits(12)
    for name in FMTS:
        fmt, jfmt = FMTS[name], JFMTS[name]
        x = rng.uniform(fmt.min_value * 1.5, fmt.max_value * 1.5,
                        4096).astype(np.float32)
        _same(*_both(lambda a: jfxp.roundtrip(a, jfmt),
                     lambda a: fxp.roundtrip(a, fmt), x)[::-1])
        _same(*_both(lambda a: jfxp.roundtrip(a, jfmt, "trunc"),
                     lambda a: fxp.roundtrip(a, fmt, "trunc"), x)[::-1])
        wide = rng.integers(-2 ** 31, 2 ** 31 - 1, 4096).astype(np.int32)
        _same(*_both(lambda a: jfxp.saturate(a, jfmt),
                     lambda a: fxp.saturate(a, fmt), wide)[::-1])


# ---------------------------------------------------------------------------
# Schedules and constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 4, 5, 12, 14, 45])
def test_schedules_and_gains_match_reference(n):
    assert tc.hyperbolic_sequence(n) == jc.hyperbolic_sequence(n)
    assert tc.hyperbolic_gain(n) == jc.hyperbolic_gain(n)
    assert tc.hyperbolic_range(n) == jc.hyperbolic_range(n)
    assert tc.circular_gain(n) == jc.circular_gain(n)
    if n == 5:
        assert tc.hyperbolic_sequence(5) == (1, 2, 3, 4, 4)


# ---------------------------------------------------------------------------
# Linear rotation (MAC)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("n", [3, 5, 9])
def test_linear_modes_match_reference(fmt, n, rng):
    f, jf = FMTS[fmt], JFMTS[fmt]
    x = rng.uniform(-2, 2, 2048).astype(np.float32)
    w = rng.uniform(-1.99, 1.99, 2048).astype(np.float32)
    b = rng.uniform(-1, 1, 2048).astype(np.float32)
    xr, wr, br = (jfxp.quantize(jnp.asarray(v), jf) for v in (x, w, b))
    for unroll in (True, False):
        jy, jz = jc.linear_rotate_raw(xr, br, wr, jf, n, unroll=unroll)
        ty, tz = tc.linear_rotate_raw(*(torch.from_numpy(np.asarray(v))
                                        for v in (xr, br, wr)), f, n,
                                      unroll=unroll)
        _same(ty, jy)
        _same(tz, jz)
    want, got = _both(lambda *a: jc.mac(*a, jf, n),
                      lambda *a: tc.mac(*a, f, n), x, w, b)
    _same(got, want)
    want, got = _both(lambda *a: jc.multiply(*a, jf, n),
                      lambda *a: tc.multiply(*a, f, n), x, w)
    _same(got, want)


# ---------------------------------------------------------------------------
# Hyperbolic rotation and exp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("n", [3, 5, 12])
def test_hyperbolic_modes_match_reference(fmt, n, rng):
    f, jf = FMTS[fmt], JFMTS[fmt]
    a = rng.uniform(-1.2, 1.2, 2048).astype(np.float32)
    ar = jfxp.quantize(jnp.asarray(a), jf)
    for unroll in (True, False):
        jcs = jc.hyperbolic_rotate_raw(ar, jf, n, unroll=unroll)
        tcs = tc.hyperbolic_rotate_raw(torch.from_numpy(np.asarray(ar)), f,
                                       n, unroll=unroll)
        for got, want in zip(tcs, jcs):
            _same(got, want)
    for got, want in zip(tc.cosh_sinh(torch.from_numpy(a), f, n),
                         jc.cosh_sinh(jnp.asarray(a), jf, n)):
        _same(got, want)


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("range_extend", [True, False])
def test_exp_fxp_matches_reference(fmt, range_extend, rng):
    f, jf = FMTS[fmt], JFMTS[fmt]
    ln2 = np.log(2.0)
    a = np.concatenate([
        rng.uniform(-12, 3, 4096), rng.uniform(-120, 60, 1024),
        # k = round(a / ln2) at its half-way points, and a ulp either side
        (np.arange(-40, 20) + 0.5) * ln2,
        np.nextafter(((np.arange(-40, 20) + 0.5) * ln2).astype(np.float32),
                     np.float32(np.inf)),
        [0.0, -0.0, 88.0, -88.0, -200.0]]).astype(np.float32)
    want, got = _both(lambda v: jc.exp_fxp(v, jf, 5, range_extend),
                      lambda v: tc.exp_fxp(v, f, 5, range_extend), a)
    _same(got, want)


# ---------------------------------------------------------------------------
# Division
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("n,extra_start", [(4, 0), (8, 0), (12, 1), (16, 2)])
def test_division_matches_reference(fmt, n, extra_start, rng):
    f, jf = FMTS[fmt], JFMTS[fmt]
    num = rng.uniform(-3, 3, 2048).astype(np.float32)
    den = np.concatenate([rng.uniform(-4, 4, 2040),
                          [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, 1e-4, -1e-4]]
                         ).astype(np.float32)
    want, got = _both(lambda p, q: jc.divide(p, q, jf, n, extra_start),
                      lambda p, q: tc.divide(p, q, f, n, extra_start),
                      num, den)
    _same(got, want)
    yr = jfxp.quantize(jnp.asarray(num), jf)
    xr = jfxp.quantize(jnp.abs(jnp.asarray(den)) + 0.25, jf)
    _same(tc.divide_raw(torch.from_numpy(np.asarray(yr)),
                        torch.from_numpy(np.asarray(xr)), f, n, extra_start),
          jc.divide_raw(yr, xr, jf, n, extra_start))


# ---------------------------------------------------------------------------
# Circular rotation, sqrt, rsqrt, ln
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", list(FMTS))
def test_cos_sin_matches_reference(fmt, rng):
    f, jf = FMTS[fmt], JFMTS[fmt]
    a = rng.uniform(-1.7, 1.7, 2048).astype(np.float32)
    for n in (5, 12):
        for got, want in zip(tc.cos_sin(torch.from_numpy(a), f, n),
                             jc.cos_sin(jnp.asarray(a), jf, n)):
            _same(got, want)


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("fn", ["sqrt_fxp", "rsqrt_fxp", "ln_fxp"])
def test_vectoring_modes_match_reference(fmt, fn, rng):
    """Range-extended forms take ceil/round of log2: powers of two and one
    ulp either side are where a correctly rounded log2 would part ways
    with the reference."""
    f, jf = FMTS[fmt], JFMTS[fmt]
    a = np.concatenate([rng.uniform(1e-3, 900, 2048),
                        rng.uniform(0.05, 1.9, 512), _pow2_edges(-20, 20),
                        [0.0, 1.0, 1e-35]]).astype(np.float32)
    want, got = _both(lambda v: getattr(jc, fn)(v, jf),
                      lambda v: getattr(tc, fn)(v, f), a)
    _same(got, want)
    if fn != "rsqrt_fxp":
        native = rng.uniform(0.2, 1.9, 1024).astype(np.float32)
        want, got = _both(lambda v: getattr(jc, fn)(v, jf, 5, False),
                          lambda v: getattr(tc, fn)(v, f, 5, False), native)
        _same(got, want)


# ---------------------------------------------------------------------------
# DA-VINCI activations (core/activations.py)
# ---------------------------------------------------------------------------

def _af_inputs(rng) -> np.ndarray:
    edges = _pow2_edges(-10, 8)
    x = np.concatenate([rng.uniform(-8, 8, 2000), rng.normal(size=1000) * 30,
                        edges, -edges, [0.0]]).astype(np.float32)
    return x[:len(x) // 64 * 64].reshape(-1, 64)


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("range_extend", [True, False])
def test_activate_matches_reference(bits, range_extend, rng):
    """Every AF, float32, bit for bit; inputs at powers of two and one ulp
    either side (softmax's denominator scale is exp2(ceil(log2(sum))))."""
    x = _af_inputs(rng)
    jp = ja.CordicPolicy(bits=bits, range_extend=range_extend)
    tp = ta.CordicPolicy(bits=bits, range_extend=range_extend)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for name in ja.SUPPORTED_AFS:
        want, got = _both(lambda v: ja.activate(v, name, jp),
                          lambda v: ta.activate(v, name, tp), x)
        _same(got, want)
        if name == "softmax":
            want, got = _both(lambda v: ja.activate(v, name, jp, axis=0),
                              lambda v: ta.activate(v, name, tp, axis=0), x)
            _same(got, want)


def test_activate_exact_path_and_policies(rng):
    x = _af_inputs(rng)
    for name in ta.SUPPORTED_AFS:
        want, got = _both(lambda v: ja.activate(v, name),
                          lambda v: ta.activate(v, name), x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="unsupported AF"):
        ta.activate(torch.zeros(3), "mish", ta.DEFAULT_POLICY)
    assert ta.reuse_report() == ja.reuse_report()
    for tp, jp in ((ta.DEFAULT_POLICY, ja.DEFAULT_POLICY),
                   (ta.PAPER_FAITHFUL_POLICY, ja.PAPER_FAITHFUL_POLICY)):
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert dataclasses.asdict(tp.fmt) == dataclasses.asdict(jp.fmt)


@pytest.mark.parametrize("name", ["tanh", "sigmoid", "softmax", "gelu",
                                  "silu", "selu", "exp", "relu"])
def test_activate_ste_gradient_is_the_exact_one(name, rng):
    """Straight-through: the exact function's gradient, against torch's
    exact gradient and the reference's, within 1e-6 (float32 sums in
    another order)."""
    x = rng.uniform(-3, 3, (6, 16)).astype(np.float32)
    w = rng.normal(size=(6, 16)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    g, = torch.autograd.grad(
        (ta.activate(tx, name, ta.DEFAULT_POLICY) * torch.from_numpy(w)).sum(),
        tx)
    tx2 = torch.from_numpy(x).requires_grad_(True)
    ge, = torch.autograd.grad(
        (ta.activate(tx2, name) * torch.from_numpy(w)).sum(), tx2)
    torch.testing.assert_close(g, ge, rtol=0, atol=1e-6)
    jg = jax.grad(lambda v: (ja.activate(v, name, ja.DEFAULT_POLICY)
                             * jnp.asarray(w)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
