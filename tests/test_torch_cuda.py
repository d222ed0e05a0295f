"""The port's CUDA kernels against their plain torch versions, on a card.

This file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips (the ``cuda`` fixture decides at
run time).  On the card each kernel must equal its plain version bit for
bit, and a CUDA tensor must never take the plain version.  The
``CORDIC_EXEC`` modules (``quantized_dense`` W8A8, ``activate``) must give
the card the CPU's bits: their float ops are the reference's, one rounded
operation at a time (``core/libm.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (CORDIC_EXEC, CacheSpec, ExecutionPolicy,
                                 get_arch)
from repro_torch.core import activations as acts
from repro_torch.core import fixed_point as fxp
from repro_torch.core import quantization as quant
from repro_torch.core.quant_cache import quantize_blocked
from repro_torch.kernels import (common, cordic_act, cordic_softmax,
                                 flash_attention, flash_attention_q8, wkv,
                                 wkv_q8)
from repro_torch.kernels.cordic_act.ops import cordic_act_raw
from repro_torch.kernels.cordic_act.ref import cordic_act_raw_ref
from repro_torch.kernels.cordic_mac import ops
from repro_torch.kernels.cordic_mac.ref import cordic_matmul_raw_ref
from repro_torch.kernels.cordic_softmax.ops import cordic_softmax_raw
from repro_torch.kernels.cordic_softmax.ref import cordic_softmax_raw_ref
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import exact_attention
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref,
                                                     flash_q8_ref)
from repro_torch.kernels.wkv.ops import exact_wkv
from repro_torch.kernels.wkv.ref import (wkv_q8_ref, wkv_recurrence_bwd_ref,
                                         wkv_recurrence_ref)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.spec import to_device
from repro_torch.runtime.serve_loop import Request, ServeConfig, ServeEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _raw(gen, shape, fmt, dev):
    return torch.randint(fmt.raw_min, fmt.raw_max + 1, shape, generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("m", [1, 4, 5, 64, 70])
@pytest.mark.parametrize("fmt,n_stages", [(fxp.FXP8, 5), (fxp.FXP8, 7),
                                          (fxp.FXP16, 5), (fxp.FXP32, 5)])
def test_cordic_mac_bit_exact(cuda, m, fmt, n_stages):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m)
    x = _raw(gen, (m, 333), fmt, cuda)
    w = _raw(gen, (333, 301), fmt, cuda)
    w[:, ::7] = 0
    spec = common.get_kernel("cordic_mac")
    common.reset_counts()
    got = ops.cordic_matmul_raw(x, w, fmt=fmt, n_stages=n_stages)
    assert (spec.launches, spec.plain_calls) == (1, 0)
    want = cordic_matmul_raw_ref(x, w, fmt=fmt, n_stages=n_stages)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cordic_mac_refuses_bad_inputs(cuda):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    w = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    for args in ((x.float(), w), (x, w.t()), (x, w[:4]), (x[None], w)):
        with pytest.raises(ValueError):
            ops.cordic_matmul_raw(*args, fmt=fxp.FXP16, n_stages=5)


@pytest.mark.parametrize("matmul", ["bf16", "cordic_kernel"])
def test_reduced_model_on_card(cuda, matmul):
    """float32 matmuls: card vs CPU within 1e-4 (sums in another order).
    cordic_kernel: kernel vs plain version on the card, bit-equal logits
    (card vs CPU has no fixed tolerance: a 1-ulp float difference flips an
    FXP16 rounding, and the flip grows through the layers)."""
    cfg = dataclasses.replace(
        get_arch("glm4-9b").reduced().scaled(dtype="float32"),
        exec_policy=ExecutionPolicy(matmul=matmul))
    params = build_model(cfg, "cpu").init(seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))
    card = build_model(cfg, cuda)
    with torch.inference_mode():
        got = card.forward(to_device(params, cuda), {"tokens": tokens.to(cuda)})
    assert torch.isfinite(got).all()
    if matmul == "bf16":
        with torch.inference_mode():
            want = build_model(cfg, "cpu").forward(params, {"tokens": tokens})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        return
    spec = common.get_kernel("cordic_mac")
    kernel = spec.kernel
    spec.kernel = spec.plain
    try:
        with torch.inference_mode():
            want = card.forward(to_device(params, cuda),
                                {"tokens": tokens.to(cuda)})
    finally:
        spec.kernel = kernel
    assert torch.equal(got, want)


def test_engine_matches_single_stream_on_card(cuda):
    cfg = dataclasses.replace(get_arch("glm4-9b").reduced(),
                              exec_policy=ExecutionPolicy(
                                  matmul="cordic_kernel"))
    model = build_model(cfg, cuda)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip((5, 11, 16, 3), (4, 9, 2, 6)))]
    done = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq=32)
                       ).serve(reqs)
    assert len(done) == len(reqs)
    for r in done:
        with torch.inference_mode():
            lg, st = model.prefill(
                params, {"tokens": torch.from_numpy(r.prompt)[None].to(cuda)},
                headroom=32 - len(r.prompt))
            seq = [int(lg.reshape(-1).argmax())]
            for _ in range(r.max_new_tokens - 1):
                lg, st = model.decode_step(
                    params, st, {"tokens": torch.tensor([[seq[-1]]],
                                                        device=cuda)})
                seq.append(int(lg.reshape(-1).argmax()))
        assert r.output.tolist() == seq, r.rid


# ---------------------------------------------------------------------------
# DA-VINCI kernels: cordic_act and cordic_softmax
# ---------------------------------------------------------------------------

DAVINCI_FMTS = [fxp.FXP4, fxp.FXP8, fxp.FXP16]


def _ends(gen, shape, fmt, dev):
    """Uniform raw words over the format, both saturated ends and zero
    planted at the front."""
    x = _raw(gen, shape, fmt, dev)
    flat = x.view(-1)
    flat[:3] = torch.tensor([fmt.raw_min, fmt.raw_max, 0], dtype=torch.int32)
    return x


@pytest.mark.parametrize("af", ["tanh", "sigmoid", "exp"])
@pytest.mark.parametrize("fmt", DAVINCI_FMTS)
@pytest.mark.parametrize("shape", [(7, 13), (4, 13696), (64, 1000)])
def test_cordic_act_bit_exact(cuda, af, fmt, shape):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(shape[1])
    x = _ends(gen, shape, fmt, cuda)
    spec = common.get_kernel("cordic_act")
    for n_hyp, n_div in ((5, 4), (5, fmt.frac_bits + 4), (12, 12)):
        common.reset_counts()
        got = cordic_act_raw(x, af=af, fmt=fmt, n_hyp=n_hyp, n_div=n_div)
        assert (spec.launches, spec.plain_calls) == (1, 0)
        want = cordic_act_raw_ref(x, af=af, fmt=fmt, n_hyp=n_hyp,
                                  n_div=n_div)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", DAVINCI_FMTS)
@pytest.mark.parametrize("shape", [(7, 13), (2048, 16), (128, 64),
                                   (3, 1000), (4, 151552)])
def test_cordic_softmax_bit_exact(cuda, fmt, shape):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(shape[0])
    x = _ends(gen, shape, fmt, cuda)
    x[-1] = fmt.raw_min                 # a constant row
    if shape[0] > 1:
        x[0, 1] = fmt.raw_max           # one entry dominates row 0
    spec = common.get_kernel("cordic_softmax")
    for n_hyp, n_div in ((5, 4), (5, fmt.frac_bits + 4), (12, 12)):
        common.reset_counts()
        got = cordic_softmax_raw(x, fmt=fmt, n_hyp=n_hyp, n_div=n_div)
        assert (spec.launches, spec.plain_calls) == (1, 0)
        want = cordic_softmax_raw_ref(x, fmt=fmt, n_hyp=n_hyp, n_div=n_div)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_davinci_frontends_on_card_equal_cpu(cuda):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-6, 6, (5, 7, 33)).astype(np.float32))
    for af in ("tanh", "sigmoid", "exp"):
        got = cordic_act(x.to(cuda), af)
        assert torch.equal(got.cpu(), cordic_act(x, af))
    got = cordic_softmax(x.to(cuda) * 3)
    assert torch.equal(got.cpu(), cordic_softmax(x * 3))
    band = (cordic_softmax(x.to(cuda), n_hyp=12)
            - torch.softmax(x.to(cuda), -1)).abs().max().item()
    assert band < 0.02


def test_davinci_kernels_refuse_bad_inputs(cuda):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    for bad in (x.float(), x.t(), x[0]):
        with pytest.raises(ValueError):
            cordic_act_raw(bad, af="tanh", fmt=fxp.FXP16)
        with pytest.raises(ValueError):
            cordic_softmax_raw(bad, fmt=fxp.FXP16)
    with pytest.raises(ValueError, match="12"):
        cordic_act_raw(x, af="tanh", fmt=fxp.FXP32)
    with pytest.raises(ValueError, match="n_hyp"):
        cordic_act_raw(x, af="tanh", fmt=fxp.FXP16, n_hyp=33)


# ---------------------------------------------------------------------------
# CORDIC_EXEC modules and the reduced model on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 256), (64, 256, 136),
                                   (5, 13696, 64)])
def test_quantized_dense_w8a8_card_equals_cpu(cuda, dtype, m, k, n):
    gen = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=gen).to(dtype)
    w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(dtype)
    pol = quant.QuantPolicy()
    got = quant.quantized_dense(x.to(cuda), w.to(cuda), pol)
    assert torch.equal(got.cpu(), quant.quantized_dense(x, w, pol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activate_card_equals_cpu(cuda, dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.concatenate([
        rng.uniform(-8, 8, 4000), rng.normal(size=96) * 40]).astype(
            np.float32)).reshape(-1, 64).to(dtype)
    for bits in (8, 16):
        pol = acts.CordicPolicy(bits=bits)
        for name in acts.SUPPORTED_AFS:
            got = acts.activate(x.to(cuda), name, pol)
            assert torch.equal(got.cpu(), acts.activate(x, name, pol)), name


def test_cordic_exec_reduced_model_on_card(cuda):
    """float32 reduced glm4-9b under CORDIC_EXEC, card against CPU: equal
    logits (the last-bit float differences of attention and rms_norm move
    no int8 activation word on these inputs; measured on an H100 80GB HBM3
    at 700 W)."""
    cfg = dataclasses.replace(
        get_arch("glm4-9b").reduced().scaled(dtype="float32"),
        exec_policy=CORDIC_EXEC)
    params = build_model(cfg, "cpu").init(seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 9)))
    with torch.inference_mode():
        got = build_model(cfg, cuda).forward(to_device(params, cuda),
                                             {"tokens": tokens.to(cuda)})
        want = build_model(cfg, "cpu").forward(params, {"tokens": tokens})
    assert got.shape == (2, 9, 256) and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# wkv kernels (RWKV6 recurrence, float and int8 state)
# ---------------------------------------------------------------------------

WKV_TOL = 5e-5


def _wkv_raw(gen, bh, t, d, dtype, dev):
    r, k, v = (torch.randn((bh, t, d), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    w = (torch.rand((bh, t, d), generator=gen, device=dev) * 0.7 + 0.3
         ).to(dtype)
    return r, k, v, w, torch.randn((bh, d), generator=gen, device=dev)


def _y_close(got, want):
    """float32 output: atol = rtol = 5e-5; a bfloat16 output may also round
    the other way, one bfloat16 step (2**-7 of the value)."""
    rtol = WKV_TOL if got.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=WKV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,d", [(64, 64, 16), (64, 128, 32), (64, 32, 8),
                                    (160, 16, 64), (80, 1, 64), (16, 7, 64),
                                    (4, 65, 32)])
def test_wkv_kernels_match_plain_on_card(cuda, bh, t, d, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(bh * t + d)
    raw = _wkv_raw(gen, bh, t, d, dtype, cuda)
    common.reset_counts()
    got = wkv_kernel.wkv_recurrence_cuda(*raw)
    assert got.dtype == dtype
    _y_close(got, wkv_recurrence_ref(*raw))
    for s0, sc in ((torch.randint(-127, 128, (bh, d, d), generator=gen,
                                  device=cuda, dtype=torch.int8),
                    torch.rand((bh, d), generator=gen, device=cuda) * 0.1),
                   (torch.zeros((bh, d, d), dtype=torch.int8, device=cuda),
                    torch.zeros((bh, d), device=cuda))):
        out, q, scale = wkv_kernel.wkv_recurrence_q8_cuda(*raw, s0, sc)
        want = wkv_q8_ref(*raw, s0, sc)
        _y_close(out, want[0])
        assert torch.equal(q, want[1]) and torch.equal(scale, want[2])
    assert (common.get_kernel("wkv").launches,
            common.get_kernel("wkv_q8").launches) == (1, 2)


def test_wkv_frontends_launch_the_kernels(cuda):
    """The public (B, T, H, d) entry points on CUDA tensors launch the
    kernels and never take the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    b, t, h, d = 2, 9, 40, 64
    r, k, v, w = (torch.randn((b, t, h, d), generator=gen, device=cuda)
                  for _ in range(4))
    w = torch.sigmoid(w)
    u = torch.randn((h, d), generator=gen, device=cuda)
    s0 = torch.randint(-127, 128, (b, h, d, d), generator=gen, device=cuda,
                       dtype=torch.int8)
    sc = torch.rand((b, h, d), generator=gen, device=cuda)
    common.reset_counts()
    y = wkv(r, k, v, w, u)
    y8, q, scale = wkv_q8(r, k, v, w, u, s0, sc)
    assert y.shape == (b, t, h, d) and q.shape == (b, h, d, d)
    for name in ("wkv", "wkv_q8"):
        spec = common.get_kernel(name)
        assert (spec.launches, spec.plain_calls) == (1, 0), name
    want = wkv(*(x.cpu() for x in (r, k, v, w, u)))
    _y_close(y.cpu(), want)
    _y_close(y8.cpu(), wkv_q8(*(x.cpu() for x in (r, k, v, w, u, s0, sc)))[0])


def test_wkv_kernels_refuse_bad_inputs(cuda):
    raw = [torch.zeros((4, 3, 16), device=cuda) for _ in range(4)]
    u = torch.zeros((4, 16), device=cuda)
    bad = (
        ([raw[0].cpu()] + raw[1:] + [u]),            # a CPU tensor
        ([raw[0].double()] + raw[1:] + [u]),         # float64
        ([raw[0].transpose(0, 1)] + raw[1:] + [u]),  # wrong shape
        ([torch.zeros((4, 3, 128), device=cuda)] * 4
         + [torch.zeros((4, 128), device=cuda)]),   # d = 128
        (raw + [u[:, :8]]),                          # u of another width
    )
    for args in bad:
        with pytest.raises(ValueError, match="wkv"):
            wkv_kernel.wkv_recurrence_cuda(*args)
    s0 = torch.zeros((4, 16, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="state"):
        wkv_kernel.wkv_recurrence_q8_cuda(*raw, u, s0.float(),
                                          torch.zeros((4, 16), device=cuda))


@pytest.mark.parametrize("cache", [None, "int8"])
def test_reduced_rwkv6_on_card(cuda, cache):
    """float32 matmuls: card vs CPU within 1e-4; under cordic_kernel the
    engine (6 requests through 4 slots) equals single-stream decode, with
    the float32 and the int8 recurrent state."""
    base = get_arch("rwkv6-3b").reduced().scaled(dtype="float32")
    if cache:
        base = base.scaled(cache=CacheSpec(dtype=cache))
    params = build_model(base, "cpu").init(seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))
    with torch.inference_mode():
        got = build_model(base, cuda).forward(to_device(params, cuda),
                                              {"tokens": tokens.to(cuda)})
        want = build_model(base, "cpu").forward(params, {"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cfg = dataclasses.replace(base, exec_policy=ExecutionPolicy(
        matmul="cordic_kernel"))
    model = build_model(cfg, cuda)
    params = to_device(params, cuda)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip((5, 11, 16, 3, 24, 8),
                                           (4, 9, 2, 12, 1, 6)))]
    done = ServeEngine(model, params, ServeConfig(max_batch=4, max_seq=64)
                       ).serve(reqs)
    assert len(done) == len(reqs)
    for r in done:
        with torch.inference_mode():
            lg, st = model.prefill(
                params, {"tokens": torch.from_numpy(r.prompt)[None].to(cuda)})
            seq = [int(lg.reshape(-1).argmax())]
            for _ in range(r.max_new_tokens - 1):
                lg, st = model.decode_step(
                    params, st, {"tokens": torch.tensor([[seq[-1]]],
                                                        device=cuda)})
                seq.append(int(lg.reshape(-1).argmax()))
        assert r.output.tolist() == seq, r.rid


FLASH_TOL = 2e-4    # float32: the reference's own band for its flash tests


def _flash_close(got, want, dtype):
    """float32 within FLASH_TOL; bf16 outputs within one bf16 ulp."""
    tol = FLASH_TOL if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal", [
    (4, 4, 64, 64, 16, True), (4, 4, 64, 64, 16, False),
    (8, 2, 64, 64, 16, True), (4, 1, 64, 64, 8, True),
    (8, 4, 40, 40, 8, True), (2, 2, 96, 96, 16, False),
    (4, 2, 96, 96, 64, True), (4, 2, 40, 40, 128, False),
    (2, 1, 33, 70, 256, False), (2, 2, 130, 130, 100, True),
    (32, 2, 128, 128, 64, True)])
def test_flash_kernels_match_plain_on_card(cuda, hq, hkv, sq, sk, d, causal,
                                           dtype):
    """Kernels 4 and 6 against their plain versions on the same inputs:
    out, lse, dq, dk, dv.  The last case is a GQA group of 16 (glm4-9b's),
    whose dK/dV pass sums partial sums over parts of the group."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(hq * sq + d)
    q = torch.randn((hq, sq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((hkv, sk, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((hq, sq, d), generator=gen, device=cuda).to(dtype)
    group = hq // hkv
    common.reset_counts()
    out, lse = flash_kernel.flash_attention_nhd_cuda(
        q, k, v, causal=causal, group=group, return_residuals=True)
    w_out, w_lse = flash_fwd_ref(q, k, v, causal=causal, group=group)
    _flash_close(out, w_out, dtype)
    torch.testing.assert_close(lse, w_lse, rtol=FLASH_TOL, atol=FLASH_TOL)
    delta = (do.float() * w_out.float()).sum(-1)
    got = flash_kernel.flash_attention_bwd_nhd_cuda(
        q, k, v, do, w_lse, delta, causal=causal, group=group)
    want = flash_bwd_ref(q, k, v, do, w_lse, delta, causal=causal,
                         group=group)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=FLASH_TOL, atol=FLASH_TOL)
    assert (common.get_kernel("flash_attention").launches,
            common.get_kernel("flash_attention_bwd").launches) == (1, 1)


def test_flash_frontend_gradient_on_card(cuda):
    """``flash_attention`` on CUDA tensors launches kernels 4 and 6 and
    never the plain versions; its gradient equals the exact attention
    VJP (Sq == Sk, where the two causal masks agree)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    q = torch.randn((2, 72, 8, 64), generator=gen, device=cuda)
    k, v = (torch.randn((2, 72, 2, 64), generator=gen, device=cuda)
            for _ in range(2))
    g = torch.randn((2, 72, 8, 64), generator=gen, device=cuda)
    args = [a.clone().requires_grad_(True) for a in (q, k, v)]
    common.reset_counts()
    got = torch.autograd.grad(flash_attention(*args), args, g)
    for name in ("flash_attention", "flash_attention_bwd"):
        spec = common.get_kernel(name)
        assert (spec.launches, spec.plain_calls) == (1, 0), name
    ref = [a.clone().requires_grad_(True) for a in (q, k, v)]
    want = torch.autograd.grad(exact_attention(*ref, causal=True), ref, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,d,block_t", [(4, 32, 8, 8), (4, 64, 16, 64),
                                            (2, 24, 32, 16), (80, 48, 64, 16),
                                            (3, 40, 64, 64)])
def test_wkv_backward_matches_plain_on_card(cuda, bh, t, d, block_t, dtype):
    """Kernel 7's checkpoints equal its plain version's word for word;
    kernel 9's gradients are within the reference's 2e-4 band of the
    plain adjoint sweep (sums in another order)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(bh * t + d)
    raw = _wkv_raw(gen, bh, t, d, dtype, cuda)
    dy = torch.randn((bh, t, d), generator=gen, device=cuda).to(dtype)
    bt = common.largest_divisor(t, block_t)
    common.reset_counts()
    _, ckpt = wkv_kernel.wkv_recurrence_cuda(*raw, block_t=bt,
                                             return_residuals=True)
    _, w_ckpt = wkv_recurrence_ref(*raw, block_t=bt, return_residuals=True)
    assert torch.equal(ckpt, w_ckpt)
    got = wkv_kernel.wkv_recurrence_bwd_cuda(*raw, dy, ckpt, block_t=bt)
    want = wkv_recurrence_bwd_ref(*raw, dy, w_ckpt, block_t=bt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    assert (common.get_kernel("wkv").launches,
            common.get_kernel("wkv_bwd").launches) == (1, 1)


def test_wkv_frontend_gradient_on_card(cuda):
    """``wkv`` on CUDA tensors under a gradient launches kernels 7 and 9
    only; the gradient equals the exact VJP of the float scan."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    b, t, h, d = 2, 40, 4, 64
    r, k, v = (torch.randn((b, t, h, d), generator=gen, device=cuda) * 0.5
               for _ in range(3))
    w = torch.rand((b, t, h, d), generator=gen, device=cuda) * 0.5 + 0.45
    u = torch.randn((h, d), generator=gen, device=cuda) * 0.5
    g = torch.randn((b, t, h, d), generator=gen, device=cuda)
    args = [a.clone().requires_grad_(True) for a in (r, k, v, w, u)]
    common.reset_counts()
    got = torch.autograd.grad(wkv(*args), args, g)
    for name in ("wkv", "wkv_bwd"):
        spec = common.get_kernel(name)
        assert (spec.launches, spec.plain_calls) == (1, 0), name
    ref = [a.clone().requires_grad_(True) for a in (r, k, v, w, u)]
    want = torch.autograd.grad(exact_wkv(*ref), ref, g)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", ["wkv", "flash_attention"])
def test_exact_backward_switch_counts_plain_on_card(cuda, family,
                                                    monkeypatch):
    """``REPRO_FUSED_BWD=0`` on CUDA tensors: the backward is the exact
    VJP, which the backward kernel's spec counts as a plain call; the
    backward kernel is not launched."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    if family == "wkv":
        b, t, h, d = 1, 32, 2, 64
        args = [torch.randn((b, t, h, d), generator=gen, device=cuda) * 0.5
                for _ in range(3)]
        args.append(torch.rand((b, t, h, d), generator=gen, device=cuda)
                    * 0.5 + 0.45)
        args.append(torch.randn((h, d), generator=gen, device=cuda) * 0.5)
        fn, exact, bwd = wkv, exact_wkv, "wkv_bwd"
    else:
        args = [torch.randn((1, 32, hh, 64), generator=gen, device=cuda)
                for hh in (4, 2, 2)]
        fn, bwd = flash_attention, "flash_attention_bwd"

        def exact(q, k, v):
            return exact_attention(q, k, v, causal=True)
    monkeypatch.setenv("REPRO_FUSED_BWD", "0")
    args = [a.requires_grad_(True) for a in args]
    out = fn(*args)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    common.reset_counts()
    got = torch.autograd.grad(out, args, g)
    spec = common.get_kernel(bwd)
    assert (spec.launches, spec.plain_calls) == (0, 1)
    ref = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(exact(*ref), ref, g)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b"])
def test_reduced_training_on_card(cuda, arch):
    """Two Trainer steps of the reduced model in float32 under CORDIC_EXEC:
    the card's losses within 1e-4 of the CPU's (float32 sums in another
    order), no kernel's plain version taken on the card."""
    import dataclasses as dc

    from repro_torch.configs import LM_SHAPES
    from repro_torch.data.pipeline import stream_for_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    base = get_arch(arch).reduced().scaled(dtype="float32")
    init = build_model(base, "cpu").init(seed=0)
    shape = dc.replace(LM_SHAPES["train_4k"], seq_len=16, global_batch=2)
    losses = {}
    for where in ("cpu", cuda):
        model = build_model(base, where)
        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=2), log_every=1)
        tr = Trainer(model, tcfg, stream_for_model(model, shape),
                     pol=CORDIC_EXEC)
        tr.init_state = (lambda seed=0, m=model, t=tcfg: (
            _copy(init, m.device), adamw.init(t.optimizer, _copy(
                init, m.device)), torch.zeros((), device=m.device)))
        common.reset_counts()
        losses[str(where)] = [x for _, x in tr.run(2)["losses"]]
        assert not any(common.get_kernel(n).plain_calls
                       for n in common.registered_kernels()) or where == "cpu"
    a, b = losses["cpu"], losses[str(cuda)]
    assert len(a) == 2 and max(abs(x - y) for x, y in zip(a, b)) <= 1e-4


def _copy(tree, device):
    return {k: (_copy(v, device) if isinstance(v, dict) else
                v.to(device, copy=True)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Kernel 5: flash attention over an int8 K/V cache; the int8 K/V cache
# ---------------------------------------------------------------------------

def _q8_close(got, want, dtype):
    """float32 within atol = rtol = 2e-4 (kernel 4's band); a bf16 output
    within atol 2e-4 plus one bf16 step of the value."""
    rtol = FLASH_TOL if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=FLASH_TOL)


def _q8_raw(gen, hq, hkv, sq, sk, d, dtype, dev):
    """q (Hq, Sq, d) in ``dtype``; int8 k, v (Hkv, Sk, d) and their scales
    (Hkv, Sk) from ``quantize_blocked``, positions 0 and 3 all zero."""
    q = torch.randn((hq, sq, d), generator=gen, device=dev).to(dtype)
    out = [q]
    for _ in range(2):
        x = 2 * torch.randn((hkv, sk, d), generator=gen, device=dev)
        x[:, [p for p in (0, 3) if p < sk]] = 0
        w, s = quantize_blocked(x)
        out += [w, s[..., 0].contiguous()]
    q, kw, ks, vw, vs = out
    return q, kw, vw, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal", [
    (4, 4, 64, 64, 16, True), (8, 2, 64, 64, 16, False),
    (16, 1, 33, 70, 8, True), (32, 2, 16, 16, 128, True),
    (32, 2, 1, 64, 128, False), (32, 2, 1, 4096, 128, False),
    (32, 2, 130, 130, 128, True), (2, 1, 40, 17, 256, True),
    (6, 3, 50, 50, 100, False), (128, 8, 1, 4096, 128, False),
    (32, 2, 1, 1000, 128, False), (32, 2, 1, 300, 128, True)])
def test_flash_q8_kernel_matches_plain_on_card(cuda, hq, hkv, sq, sk, d,
                                               causal, dtype):
    """Kernel 5 against its plain version on the same inputs: glm4-9b's
    prefill and decode shapes (32 q / 2 kv heads of 128) among them.  The
    decode shapes cut the keys into several chunks combined by a second
    kernel: 4 slots over 4096 positions, 1000 keys (the last chunk
    ragged), and Sq = 1 causal (key 0 alone is live)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(hq * sq + d)
    x = _q8_raw(gen, hq, hkv, sq, sk, d, dtype, cuda)
    common.reset_counts()
    got = flash_kernel.flash_attention_q8_nhd_cuda(*x, causal=causal,
                                                   group=hq // hkv)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (hq, sq, d)
    _q8_close(got, flash_q8_ref(*x, causal=causal, group=hq // hkv), dtype)
    spec = common.get_kernel("flash_attention_q8")
    assert (spec.launches, spec.plain_calls) == (1, 0)


def test_flash_q8_frontend_on_card(cuda):
    """``flash_attention_q8`` on strided views of a (L, B, S, Hkv, dh)
    cache launches kernel 5 once and agrees with the CPU's plain version
    on the same words."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    words, scales = quantize_blocked(
        torch.randn((2, 3, 40, 2, 128), generator=gen, device=cuda))
    q = torch.randn((3, 1, 32, 128), generator=gen, device=cuda)
    args = (q, words[1, :, :25], words[0, :, :25], scales[1, :, :25, :, 0],
            scales[0, :, :25, :, 0])
    common.reset_counts()
    got = flash_attention_q8(*args, causal=False)
    spec = common.get_kernel("flash_attention_q8")
    assert (spec.launches, spec.plain_calls) == (1, 0)
    want = flash_attention_q8(*(a.cpu() for a in args), causal=False)
    torch.testing.assert_close(got.cpu(), want, rtol=FLASH_TOL,
                               atol=FLASH_TOL)


def test_flash_q8_refuses_bad_inputs(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    q, kw, vw, ks, vs = _q8_raw(gen, 4, 2, 8, 8, 16, torch.float32, cuda)
    run = flash_kernel.flash_attention_q8_nhd_cuda
    for bad in ((q, kw.float(), vw, ks, vs), (q, kw, vw, ks[:, :4], vs),
                (q, kw, vw, ks.half(), vs), (q, kw, vw, ks, vs.t()),
                (q.transpose(1, 2), kw, vw, ks, vs),
                (q, kw, vw, ks.cpu(), vs)):
        with pytest.raises(ValueError):
            run(*bad, group=2)
    with pytest.raises(ValueError, match="hq"):
        run(q, kw, vw, ks, vs, group=3)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("cache", ["int8", "fxp8"])
def test_decode_attention_kv_cache_card_equals_cpu(cuda, cache, per_row):
    """One decode attention over the int8 (per-vector scales) or fxp8
    cache, the same inputs on the card and the CPU: the words and scales
    written equal (the quantizers' float ops round alike), the context
    within 1e-4 (float32 sums in another order)."""
    from repro_torch.models import attention as A
    gen = torch.Generator().manual_seed(3)
    b, s_max, hkv, hq, dh = 3, 16, 2, 8, 16
    q = torch.randn((b, 1, hq, dh), generator=gen)
    k_new, v_new = (torch.randn((b, 1, hkv, dh), generator=gen)
                    for _ in range(2))
    words, scales = quantize_blocked(torch.randn((2, b, s_max, hkv, dh),
                                                 generator=gen))
    if cache == "fxp8":
        words, scales = A.quantize_kv(4 * torch.randn(
            (2, b, s_max, hkv, dh), generator=gen)), None
    pos = (torch.tensor([3, 17, 9], dtype=torch.int32) if per_row
           else torch.tensor(5, dtype=torch.int32))
    cfg = get_arch("glm4-9b").reduced()
    out = {}
    for dev in ("cpu", cuda):
        ck, cv = words[0].clone().to(dev), words[1].clone().to(dev)
        sc = ([] if scales is None else
              [scales[0].clone().to(dev), scales[1].clone().to(dev)])
        ctx = A.decode_attention(q.to(dev), k_new.to(dev), v_new.to(dev),
                                 ck, cv, pos.to(dev), cfg, cfg.exec_policy,
                                 2 ** 30, *sc)
        out[str(dev)] = [t.cpu() for t in (ctx, ck, cv, *sc)]
    got, want = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cache", ["int8", "fxp8"])
def test_reduced_glm4_kv_cache_engine_on_card(cuda, cache):
    """Reduced glm4-9b with the int8 or fxp8 K/V cache under
    cordic_kernel on the card: the engine (6 requests through 4 slots)
    equals single-stream decode, with no plain-version call."""
    cfg = dataclasses.replace(
        get_arch("glm4-9b").reduced().scaled(cache=CacheSpec(dtype=cache)),
        exec_policy=ExecutionPolicy(matmul="cordic_kernel"))
    model = build_model(cfg, cuda)
    p = model.init(seed=0)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip((5, 11, 16, 3, 24, 8),
                                           (4, 9, 2, 12, 1, 6)))]
    common.reset_counts()
    done = ServeEngine(model, p, ServeConfig(max_batch=4, max_seq=64)
                       ).serve(reqs)
    assert common.get_kernel("cordic_mac").plain_calls == 0
    assert len(done) == len(reqs)
    for r in done:
        with torch.inference_mode():
            lg, st = model.prefill(
                p, {"tokens": torch.from_numpy(r.prompt)[None].to(cuda)},
                headroom=64 - len(r.prompt))
            assert st.cache_k.dtype == torch.int8
            seq = [int(lg.reshape(-1).argmax())]
            for _ in range(r.max_new_tokens - 1):
                lg, st = model.decode_step(
                    p, st, {"tokens": torch.tensor([[seq[-1]]], device=cuda)})
                seq.append(int(lg.reshape(-1).argmax()))
        assert r.output.tolist() == seq, r.rid


@pytest.mark.parametrize("cache", ["int8", "fxp8"])
def test_cordic_exec_reduced_model_kv_cache_on_card(cuda, cache):
    """float32 reduced glm4-9b under CORDIC_EXEC with the int8 or fxp8 K/V
    cache, card against CPU: prefill and 4 greedy decode steps give equal
    logits and equal cache words and scales (K/V are W8A8 products, their
    rotary embedding the reference's float ops, so both devices quantize
    the same values)."""
    cfg = dataclasses.replace(
        get_arch("glm4-9b").reduced().scaled(dtype="float32",
                                             cache=CacheSpec(dtype=cache)),
        exec_policy=CORDIC_EXEC)
    params = build_model(cfg, "cpu").init(seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 9)))
    nxt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 2, 1)))
    out = {}
    for dev in ("cpu", cuda):
        model, p = build_model(cfg, dev), to_device(params, dev)
        with torch.inference_mode():
            lg, st = model.prefill(p, {"tokens": tokens.to(dev)}, headroom=4)
            logits = [lg]
            for step in nxt:
                lg, st = model.decode_step(p, st, {"tokens": step.to(dev)})
                logits.append(lg)
        out[str(dev)] = [t.cpu() for t in (*logits, st.cache_k, st.cache_v)
                         + ((st.scale_k, st.scale_v) if cache == "int8"
                            else ())]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(got, want)
