"""The port's DA-VINCI kernels' plain versions and float frontends against
the JAX reference, on the CPU.

* raw words: ``cordic_act_raw_ref`` and ``cordic_softmax_raw_ref`` equal
  the reference's refs and its Pallas kernels (interpret mode) word for
  word, at FXP4/8/16, odd shapes, the saturated ends of each format and
  several iteration counts;
* float frontends: ``cordic_act`` / ``cordic_softmax`` equal the
  reference's frontends bit for bit, and stay within the reference tests'
  bands of the exact functions (0.02 at ``n_hyp=12``, 0.05 at the
  default for tanh, sigmoid and softmax);
* gradients: straight-through, the exact function's gradient, within an
  ``atol`` of 1e-6 (float32 sums in another order);
* refusals: FXP32 (``frac_bits + guard > 12``) and non-kernel AFs.

The card's kernels are held to these plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfxp
from repro.kernels.cordic_act import ops as j_act_ops
from repro.kernels.cordic_act.kernel import cordic_act_raw as j_act_kernel
from repro.kernels.cordic_act.ref import cordic_act_raw_ref as j_act_ref
from repro.kernels.cordic_softmax import ops as j_sm_ops
from repro.kernels.cordic_softmax.kernel import \
    cordic_softmax_raw as j_sm_kernel
from repro.kernels.cordic_softmax.ref import \
    cordic_softmax_raw_ref as j_sm_ref
from repro_torch.core import activations as ta
from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import common, cordic_act, cordic_softmax
from repro_torch.kernels.cordic_act.ops import cordic_act_raw
from repro_torch.kernels.cordic_act.ref import cordic_act_raw_ref
from repro_torch.kernels.cordic_softmax.ops import cordic_softmax_raw
from repro_torch.kernels.cordic_softmax.ref import cordic_softmax_raw_ref

torch.set_num_threads(2)

FMTS = {"FXP4": (fxp.FXP4, jfxp.FXP4), "FXP8": (fxp.FXP8, jfxp.FXP8),
        "FXP16": (fxp.FXP16, jfxp.FXP16)}
ITERS = [(5, 4), (5, None), (3, 6), (12, 12)]       # (n_hyp, n_div)


def _raw_inputs(fmt, shape, rng, scale=6.0):
    """Quantized uniform draws, with the format's two saturated ends and
    zero planted in the first row."""
    x = rng.uniform(-scale, scale, shape).astype(np.float32)
    raw = np.asarray(jfxp.quantize(jnp.asarray(x), fmt)).copy()
    flat = raw.reshape(-1)
    flat[:3] = [fmt.raw_min, fmt.raw_max, 0]
    return raw


def _n_div(fmt, n_div, guard=4):
    return max(4, fmt.frac_bits + guard) if n_div is None else n_div


@pytest.mark.parametrize("af", ["tanh", "sigmoid", "exp"])
@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("shape", [(8, 128), (7, 13), (32, 96)])
def test_act_raw_matches_reference_ref_and_kernel(af, fmt, shape, rng):
    f, jf = FMTS[fmt]
    raw = _raw_inputs(jf, shape, rng)
    for n_hyp, n_div in ITERS:
        kw = dict(af=af, n_hyp=n_hyp, n_div=_n_div(f, n_div))
        want = np.asarray(j_act_ref(jnp.asarray(raw), fmt=jf, **kw))
        got = cordic_act_raw_ref(torch.from_numpy(raw), fmt=f, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    block = (shape[0], 32 if shape[1] % 32 == 0 else shape[1])
    kern = np.asarray(j_act_kernel(jnp.asarray(raw), af=af, fmt=jf,
                                   block=block, interpret=True))
    np.testing.assert_array_equal(
        cordic_act_raw_ref(torch.from_numpy(raw), af=af, fmt=f).numpy(), kern)


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("shape", [(8, 32), (7, 13), (16, 1000)])
def test_softmax_raw_matches_reference_ref_and_kernel(fmt, shape, rng):
    f, jf = FMTS[fmt]
    x = (rng.normal(size=shape) * 2 - 3).astype(np.float32)
    x[1, 0] = 40.0                  # one entry dominates: the rest underflow
    raw = np.asarray(jfxp.quantize(jnp.asarray(x), jf)).copy()
    raw[2, :2] = [jf.raw_min, jf.raw_max]
    raw[3, :] = jf.raw_min          # a constant row at the negative end
    for n_hyp, n_div in ITERS:
        kw = dict(n_hyp=n_hyp, n_div=_n_div(f, n_div))
        want = np.asarray(j_sm_ref(jnp.asarray(raw), fmt=jf, **kw))
        got = cordic_softmax_raw_ref(torch.from_numpy(raw), fmt=f, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    kern = np.asarray(j_sm_kernel(jnp.asarray(raw), fmt=jf, block_rows=1,
                                  interpret=True))
    np.testing.assert_array_equal(
        cordic_softmax_raw_ref(torch.from_numpy(raw), fmt=f).numpy(), kern)


@pytest.mark.parametrize("af", ["tanh", "sigmoid", "exp"])
@pytest.mark.parametrize("n_hyp", [5, 12])
def test_act_frontend_matches_reference(af, n_hyp, rng):
    x = rng.uniform(-6, 6, (4, 8, 33)).astype(np.float32)
    want = np.asarray(j_act_ops.cordic_act(jnp.asarray(x), af, n_hyp=n_hyp,
                                           interpret=True))
    got = cordic_act(torch.from_numpy(x), af, n_hyp=n_hyp)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_hyp", [5, 12])
def test_softmax_frontend_matches_reference(n_hyp, rng):
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    want = np.asarray(j_sm_ops.cordic_softmax(jnp.asarray(x), n_hyp=n_hyp,
                                              interpret=True))
    got = cordic_softmax(torch.from_numpy(x), n_hyp=n_hyp)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("af,exact", [
    ("tanh", torch.tanh), ("sigmoid", torch.sigmoid),
    ("exp", lambda v: torch.exp(torch.clamp(v, max=0)))])
def test_act_frontend_within_band_of_exact(af, exact, rng):
    """The reference tests' bands: 0.02 at n_hyp = 12, and 0.05 at the
    default 5 for the bounded AFs (exp(0) at 5 iterations is 1.047, the
    reference's kernel gives the same word)."""
    x = torch.from_numpy(rng.uniform(-6, 6, (32, 64)).astype(np.float32))
    assert (cordic_act(x, af, n_hyp=12) - exact(x)).abs().max() < 0.02
    if af != "exp":
        assert (cordic_act(x, af) - exact(x)).abs().max() < 0.05


def test_softmax_frontend_within_band_of_exact(rng):
    x = torch.from_numpy((rng.normal(size=(16, 64)) * 2).astype(np.float32))
    assert (cordic_softmax(x, n_hyp=12) - torch.softmax(x, -1)).abs().max() \
        < 0.02
    s = cordic_softmax(x)
    assert (s - torch.softmax(x, -1)).abs().max() < 0.05
    assert (s.sum(-1) - 1).abs().max() < 0.05


def test_kernels_and_model_afs_differ_within_measured_band(rng):
    """The kernels run integer Q(frac+4) recurrences; the model's AFs
    (``activate``) run float-emulated fixed point.  They are two
    datapaths, not one: measured at FXP16 on a (32, 64) uniform [-6, 6]
    input (seed 0), tanh differs by 0.0625 at most, sigmoid by 0.02734375
    and softmax by 0.01416015625 (16, 7 and 3.6 FXP16 LSBs)."""
    x = torch.from_numpy(rng.uniform(-6, 6, (32, 64)).astype(np.float32))
    pol = ta.CordicPolicy(bits=16)
    for af, band in (("tanh", 0.0625), ("sigmoid", 0.02734375)):
        d = (cordic_act(x, af) - ta.activate(x, af, pol)).abs().max()
        assert 0 < d <= band, (af, d)
    d = (cordic_softmax(x) - ta.activate(x, "softmax", pol)).abs().max()
    assert 0 < d <= 0.01416015625


def test_ste_gradients_are_the_exact_ones(rng):
    x = torch.from_numpy(rng.uniform(-2, 2, (8, 8)).astype(np.float32))
    for af, exact in (("sigmoid", torch.sigmoid), ("tanh", torch.tanh),
                      ("exp", torch.exp)):
        xa = x.clone().requires_grad_(True)
        g, = torch.autograd.grad(cordic_act(xa, af).sum(), xa)
        xe = x.clone().requires_grad_(True)
        ge, = torch.autograd.grad(exact(xe).sum(), xe)
        torch.testing.assert_close(g, ge, rtol=0, atol=1e-6)
    w = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    g, = torch.autograd.grad((cordic_softmax(xa) * w).sum(), xa)
    xe = x.clone().requires_grad_(True)
    ge, = torch.autograd.grad((torch.softmax(xe, -1) * w).sum(), xe)
    torch.testing.assert_close(g, ge, rtol=0, atol=1e-6)
    # and the reference's STE gradient, through jax.grad
    jg = jax.grad(lambda v: j_act_ops.cordic_act(v, "sigmoid",
                                                 interpret=True).sum())(
        jnp.asarray(x.numpy()))
    xa = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(cordic_act(xa, "sigmoid").sum(), xa)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_refusals_and_cpu_dispatch():
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="gelu"):
        cordic_act(x, "gelu")
    for call in (lambda: cordic_act(x, "tanh", fmt=fxp.FXP32),
                 lambda: cordic_softmax(x, fmt=fxp.FXP32),
                 lambda: cordic_act(x, "tanh", fmt=fxp.FXP8, guard=9)):
        with pytest.raises(ValueError, match="12"):
            call()
    raw = torch.zeros((2, 4), dtype=torch.int32)
    common.reset_counts()
    cordic_act_raw(raw, af="exp", fmt=fxp.FXP16)
    cordic_softmax_raw(raw, fmt=fxp.FXP16)
    for name in ("cordic_act", "cordic_softmax"):
        spec = common.get_kernel(name)
        assert (spec.launches, spec.plain_calls) == (0, 1)
        assert spec.replaces.startswith(f"src/repro/kernels/{name}/kernel.py:")
