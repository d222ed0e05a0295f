"""The port's fixed-point core and CORDIC matmul against the JAX reference.

Same numpy inputs through both packages in one process: JAX on the CPU
(the Pallas kernel in interpret mode), the port with CPU tensors, which
take the kernel's plain torch version.  Raw int32 products must agree
bit for bit; the float front end too.  The STE gradient is the exact
matmul VJP, compared with an ``atol``: the reference's own
``rtol=1e-5, atol=0`` check fails on the reference itself (ROADMAP,
queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfxp
from repro.kernels.cordic_mac.kernel import cordic_matmul_raw as j_pallas_raw
from repro.kernels.cordic_mac.ops import cordic_matmul as j_cordic_matmul
from repro.kernels.cordic_mac.ref import (
    cordic_matmul_raw_ref as j_raw_ref, cordic_matmul_ref as j_cordic_matmul_ref,
    weight_sign_planes as j_planes)
from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import common
from repro_torch.kernels.cordic_mac import ops
from repro_torch.kernels.cordic_mac.ref import (cordic_matmul_raw_ref,
                                                cordic_matmul_ref,
                                                weight_sign_planes)

torch.set_num_threads(2)

FORMATS = {"fxp4": (fxp.FXP4, jfxp.FXP4), "fxp8": (fxp.FXP8, jfxp.FXP8),
           "fxp16": (fxp.FXP16, jfxp.FXP16), "fxp32": (fxp.FXP32, jfxp.FXP32)}


def _raw(rng, shape, fmt, zero_frac=0.0):
    """Uniform raw words over the whole format range, some zeroed."""
    a = rng.integers(fmt.raw_min, fmt.raw_max, size=shape,
                     endpoint=True).astype(np.int32)
    if zero_frac:
        a[rng.random(shape) < zero_frac] = 0
    return a


# ---------------------------------------------------------------------------
# fixed point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["rne", "trunc"])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_quantize_matches_reference(name, rounding):
    fmt, jfmt = FORMATS[name]
    rng = np.random.default_rng(0)
    k = np.arange(-40, 40, dtype=np.float64)
    vals = np.concatenate([
        (k + 0.5) * fmt.resolution,             # exact half-way values
        k * fmt.resolution,
        rng.standard_normal(500) * 4 * fmt.max_value,   # saturation
        [fmt.max_value, fmt.min_value, 1e30, -1e30, np.inf, -np.inf, 0.0,
         -0.0, 2.0 ** 31, -2.0 ** 31],
    ]).astype(np.float32)
    want = np.asarray(jfxp.quantize(vals, jfmt, rounding))
    got = fxp.quantize(torch.from_numpy(vals), fmt, rounding).numpy()
    np.testing.assert_array_equal(got, want)
    raw = _raw(rng, (300,), fmt)
    np.testing.assert_array_equal(
        fxp.dequantize(torch.from_numpy(raw), fmt).numpy(),
        np.asarray(jfxp.dequantize(jnp.asarray(raw), jfmt)))


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_constant_and_ashr_match_reference(name):
    fmt, jfmt = FORMATS[name]
    vals = [2.0 ** -i for i in range(12)] + [0.5 * fmt.resolution,
                                              1.5 * fmt.resolution,
                                              -2.5 * fmt.resolution, 1e9]
    assert [fxp.constant(v, fmt) for v in vals] == \
        [jfxp.constant(v, jfmt) for v in vals]
    raw = _raw(np.random.default_rng(1), (64,), fmt)
    for i in range(8):
        np.testing.assert_array_equal(
            fxp.ashr(torch.from_numpy(raw), i).numpy(),
            np.asarray(jfxp.ashr(jnp.asarray(raw), i)))


def test_fxp8_late_stage_constants_are_zero():
    """np.round is half-to-even: E_5 = round(0.5) = 0 in FXP8, so a
    shift formula (1 << (frac - i)) would be wrong past stage 4."""
    from repro_torch.kernels.cordic_mac.ref import stage_constants
    assert stage_constants(fxp.FXP8, 7) == (16, 8, 4, 2, 1, 0, 0)


# ---------------------------------------------------------------------------
# raw product: plain torch version vs the reference's ref and Pallas kernel
# ---------------------------------------------------------------------------

CASES = [(7, 13, 5), (1, 1, 1), (3, 40, 17), (16, 24, 8)]


@pytest.mark.parametrize("n_stages", [3, 5, 7])
@pytest.mark.parametrize("name", ["fxp8", "fxp16", "fxp32"])
def test_raw_matmul_bit_exact_vs_reference(name, n_stages):
    fmt, jfmt = FORMATS[name]
    rng = np.random.default_rng(n_stages)
    for m, k, n in CASES:
        x = _raw(rng, (m, k), fmt)
        w = _raw(rng, (k, n), fmt, zero_frac=0.25)
        want = np.asarray(j_raw_ref(jnp.asarray(x), jnp.asarray(w), fmt=jfmt,
                                    n_stages=n_stages))
        got = cordic_matmul_raw_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    fmt=fmt, n_stages=n_stages).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((m, k, n)))
        np.testing.assert_array_equal(
            weight_sign_planes(torch.from_numpy(w), fmt, n_stages).numpy(),
            np.asarray(j_planes(jnp.asarray(w), jfmt, n_stages)))


@pytest.mark.parametrize("n_stages", [3, 5, 7])
@pytest.mark.parametrize("name", ["fxp8", "fxp16", "fxp32"])
def test_raw_matmul_bit_exact_vs_pallas_interpret(name, n_stages):
    fmt, jfmt = FORMATS[name]
    rng = np.random.default_rng(10 + n_stages)
    x = _raw(rng, (16, 24), fmt)
    w = _raw(rng, (24, 16), fmt, zero_frac=0.25)
    want = np.asarray(j_pallas_raw(jnp.asarray(x), jnp.asarray(w), fmt=jfmt,
                                   n_stages=n_stages, block=(8, 8, 8),
                                   interpret=True))
    got = cordic_matmul_raw_ref(torch.from_numpy(x), torch.from_numpy(w),
                                fmt=fmt, n_stages=n_stages).numpy()
    np.testing.assert_array_equal(got, want)


def test_zero_weight_is_not_a_zero_product():
    """delta is +1 at z == 0: a zero weight still adds x - x/2 - ..."""
    fmt, jfmt = FORMATS["fxp16"]
    x = np.array([[1000]], np.int32)
    w = np.zeros((1, 1), np.int32)
    got = int(cordic_matmul_raw_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    fmt=fmt, n_stages=5))
    want = int(np.asarray(j_raw_ref(jnp.asarray(x), jnp.asarray(w),
                                    fmt=jfmt, n_stages=5))[0, 0])
    assert got == want != 0


def test_int32_wrap_matches_reference():
    """FXP32 words with a long K overflow int32; all three wrap mod 2**32."""
    fmt, jfmt = FORMATS["fxp32"]
    rng = np.random.default_rng(3)
    x = _raw(rng, (8, 512), fmt)
    w = _raw(rng, (512, 8), fmt)
    exact = x.astype(np.float64) @ np.where(w >= 0, 1.0, -1.0)
    assert np.abs(exact).max() > 2 ** 31           # the case does overflow
    got = cordic_matmul_raw_ref(torch.from_numpy(x), torch.from_numpy(w),
                                fmt=fmt, n_stages=5).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_raw_ref(
        jnp.asarray(x), jnp.asarray(w), fmt=jfmt, n_stages=5)))
    np.testing.assert_array_equal(got, np.asarray(j_pallas_raw(
        jnp.asarray(x), jnp.asarray(w), fmt=jfmt, n_stages=5,
        block=(8, 8, 128), interpret=True)))


def test_plain_version_refuses_inexact_and_bad_stage_counts():
    x = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="inner dims"):
        cordic_matmul_raw_ref(x, torch.zeros((3, 1), dtype=torch.int32),
                              fmt=fxp.FXP16, n_stages=5)
    for bad in (0, 33):
        with pytest.raises(ValueError, match="n_stages"):
            cordic_matmul_raw_ref(x, torch.zeros((2, 1), dtype=torch.int32),
                                  fmt=fxp.FXP16, n_stages=bad)


# ---------------------------------------------------------------------------
# dispatch and the float front end
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    spec = common.get_kernel("cordic_mac")
    common.reset_counts()
    x = torch.ones((2, 3), dtype=torch.int32)
    w = torch.ones((3, 4), dtype=torch.int32)
    ops.cordic_matmul_raw(x, w, fmt=fxp.FXP16, n_stages=5)
    assert (spec.launches, spec.plain_calls) == (0, 1)
    assert "cordic_mac" in common.registered_kernels()
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        ops.cordic_matmul_raw(x, w.to("meta"), fmt=fxp.FXP16, n_stages=5)


@pytest.mark.parametrize("name,n_stages", [("fxp8", 5), ("fxp16", 5),
                                           ("fxp16", 7), ("fxp32", 5)])
def test_float_frontend_bit_equal(name, n_stages):
    fmt, jfmt = FORMATS[name]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 21)).astype(np.float32)
    w = (rng.standard_normal((21, 11)) * 0.3).astype(np.float32)
    want = np.asarray(j_cordic_matmul(jnp.asarray(x), jnp.asarray(w),
                                      fmt=jfmt, n_stages=n_stages))
    got = ops.cordic_matmul(torch.from_numpy(x), torch.from_numpy(w), fmt=fmt,
                            n_stages=n_stages).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cordic_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), fmt=fmt,
                          n_stages=n_stages).numpy(),
        np.asarray(j_cordic_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                       fmt=jfmt, n_stages=n_stages)))


def test_ste_gradient_is_the_exact_matmul_vjp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    w = (rng.standard_normal((10, 7)) * 0.3).astype(np.float32)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    jgx, jgw = jax.vjp(lambda a, b: j_cordic_matmul(a, b), jnp.asarray(x),
                       jnp.asarray(w))[1](jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ops.cordic_matmul(tx, tw).backward(torch.from_numpy(g))
    # float32 dot products of length <= 10 summed in another order
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), g @ w.T, rtol=1e-5, atol=1e-6)
