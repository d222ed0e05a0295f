"""The port's flash-attention plain versions and frontends against the JAX
reference, on the CPU.

The same numpy inputs go through ``repro``'s oracles
(``attention_nhd_ref``, ``attention_bwd_ref``), its Pallas kernels in
interpret mode (``flash_attention_nhd`` with its residuals,
``flash_attention_bwd_nhd``) and its differentiable ``flash_attention``,
and through the port's counterparts (a CPU tensor takes the plain
versions of the kernels).  Bars: atol = rtol = 2e-4 in float32, the
reference's own (``tests/test_kernel_grads.py``); the sums run in
another order.

The kernels mask causally top-left (``qpos >= kpos``), the oracle
bottom-right (``tril(k=Sk-Sq)``): the two agree when Sq == Sk or when not
causal, and each side is held to its own counterpart where they differ.
The CUDA kernels are held to these plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Kernel 5 (``flash_attention_q8``, int8 K/V with one float32 scale per
cached vector, forward only) has no reference test to port: its plain
version is held to ``repro``'s oracle ``attention_q8_nhd_ref`` within
2e-6 (both dequantize in float32, then one float32 softmax each: the
sums in another order), and to the interpret-mode Pallas kernel and
``repro.kernels.flash_attention_q8`` within kernel 4's 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.kernel import flash_attention_nhd as j_fwd
from repro.kernels.flash_attention.kernel_bwd import \
    flash_attention_bwd_nhd as j_bwd
from repro.core.quant_cache import quantize_blocked as j_quantize_blocked
from repro.kernels.flash_attention.kernel_q8 import \
    flash_attention_q8_nhd as j_q8
from repro.kernels.flash_attention.ref import attention_bwd_ref as j_bwd_ref
from repro.kernels.flash_attention.ref import attention_nhd_ref as j_ref
from repro.kernels.flash_attention.ref import \
    attention_q8_nhd_ref as j_q8_ref
from repro_torch import kernels as K
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_nhd_ref,
                                                     attention_q8_nhd_ref,
                                                     flash_bwd_ref,
                                                     flash_fwd_ref,
                                                     flash_q8_ref)

torch.set_num_threads(2)

TOL = 2e-4
Q8_ORACLE_TOL = 2e-6
# (b, s, hq, hkv, d), causal: the reference's gradient test cases
CASES = [((2, 64, 4, 4, 16), True), ((2, 64, 4, 4, 16), False),
         ((1, 64, 8, 2, 16), True), ((1, 64, 4, 1, 8), True),
         ((2, 40, 4, 2, 8), True), ((1, 96, 2, 2, 16), False)]


def _inputs(b, s, hq, hkv, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    g = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    return q, k, v, g


def _hsd(x):
    """(B, S, H, d) -> (B * H, S, d)."""
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


@pytest.mark.parametrize("shape,causal", CASES)
def test_plain_forward_and_lse_match_reference(shape, causal):
    """(out, lse) of the plain kernel 4 against the interpret-mode Pallas
    kernel with its residuals, and out against the oracle (Sq == Sk)."""
    q, k, v, _ = _inputs(*shape)
    group = shape[2] // shape[3]
    qs, ks, vs = _hsd(q), _hsd(k), _hsd(v)
    out, lse = flash_fwd_ref(*_t(qs, ks, vs), causal=causal, group=group)
    j_out, j_lse = j_fwd(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
                         causal=causal, group=group, interpret=True,
                         return_residuals=True)
    _close(out, j_out)
    _close(lse, j_lse)
    _close(out, j_ref(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
                      causal=causal, group=group))
    _close(attention_nhd_ref(*_t(qs, ks, vs), causal=causal, group=group),
           out)


@pytest.mark.parametrize("shape,causal", CASES)
def test_plain_backward_matches_reference(shape, causal):
    """Plain kernel 6 against the interpret-mode Pallas backward on the
    same lse and delta, and against the oracle's exact VJP."""
    q, k, v, g = _inputs(*shape, seed=1)
    group = shape[2] // shape[3]
    qs, ks, vs, gs = _hsd(q), _hsd(k), _hsd(v), _hsd(g)
    j_out, j_lse = j_fwd(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
                         causal=causal, group=group, interpret=True,
                         return_residuals=True)
    delta = np.einsum("hsd,hsd->hs", gs, np.asarray(j_out))
    lse = np.asarray(j_lse)
    got = flash_bwd_ref(*_t(qs, ks, vs, gs, lse, delta), causal=causal,
                        group=group)
    want = j_bwd(*map(jnp.asarray, (qs, ks, vs, gs, lse, delta)),
                 causal=causal, group=group, interpret=True)
    exact = j_bwd_ref(*map(jnp.asarray, (qs, ks, vs, gs)), causal=causal,
                      group=group)
    mine = attention_bwd_ref(*_t(qs, ks, vs, gs), causal=causal, group=group)
    for a, b_, c, d_ in zip(got, want, exact, mine):
        _close(a, b_)
        _close(a, c)
        _close(d_, c)


@pytest.mark.parametrize("shape,causal", CASES)
def test_ops_gradient_matches_reference_vjp(shape, causal):
    """``repro_torch.kernels.flash_attention`` forward and gradient
    against ``jax.vjp`` of ``repro.kernels.flash_attention``."""
    q, k, v, g = _inputs(*shape, seed=2)
    out_j, vjp = jax.vjp(
        lambda a, b_, c: jops.flash_attention(a, b_, c, causal=causal),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    args = [a.requires_grad_(True) for a in _t(q, k, v)]
    common.reset_counts()
    out = K.flash_attention(*args, causal=causal)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    assert common.get_kernel("flash_attention").plain_calls == 1
    assert common.get_kernel("flash_attention_bwd").plain_calls == 1
    _close(out.detach(), out_j)
    for a, b_ in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b_)


def test_exact_backward_switch(monkeypatch):
    """``REPRO_FUSED_BWD=0``: the backward is the oracle's exact VJP and
    the fused kernel is not called, as in the reference."""
    q, k, v, g = _inputs(1, 32, 4, 2, 8, seed=3)
    monkeypatch.setenv("REPRO_FUSED_BWD", "0")
    assert not common.fused_backward_enabled()
    args = [a.requires_grad_(True) for a in _t(q, k, v)]
    common.reset_counts()
    got = torch.autograd.grad(K.flash_attention(*args), args,
                              torch.from_numpy(g))
    assert common.get_kernel("flash_attention_bwd").plain_calls == 0
    _, vjp = jax.vjp(lambda *a: jops._exact_attention(*a, causal=True),
                     *map(jnp.asarray, (q, k, v)))
    for a, b_ in zip(got, vjp(jnp.asarray(g))):
        _close(a, b_)


def test_causal_mask_alignment_when_sq_differs_from_sk():
    """Causal with Sk > Sq: the reference's interpret-mode kernel (mask
    top-left) and its oracle (bottom-right) disagree; the port's plain
    kernel matches the kernel and the port's oracle matches the oracle.
    Not causal, all four agree."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 16, 16)).astype(np.float32)
    v = rng.normal(size=(2, 16, 16)).astype(np.float32)
    for causal in (True, False):
        j_k = np.asarray(j_fwd(*map(jnp.asarray, (q, k, v)), causal=causal,
                               block_q=8, block_k=8, interpret=True))
        j_o = np.asarray(j_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
        mine_k = flash_fwd_ref(*_t(q, k, v), causal=causal)[0]
        mine_o = attention_nhd_ref(*_t(q, k, v), causal=causal)
        _close(mine_k, j_k)
        _close(mine_o, j_o)
        gap = np.abs(j_k - j_o).max()
        if causal:
            assert gap > 0.5, gap           # 2.77 at this seed
        else:
            assert gap < 1e-5, gap


def test_bfloat16_forward_in_inputs_dtype():
    """bf16 inputs: out in bf16, products in float32; against the
    reference's interpret-mode kernel within one bf16 ulp of |out| <= 4."""
    q, k, v, _ = _inputs(1, 40, 4, 2, 16, seed=4)
    qs, ks, vs = (_hsd(a).astype(jnp.bfloat16) for a in (q, k, v))
    out, lse = flash_fwd_ref(*[torch.from_numpy(a.view(np.uint16)).view(
        torch.bfloat16) for a in (qs, ks, vs)], group=2)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    j_out, j_lse = j_fwd(*map(jnp.asarray, (qs, ks, vs)), group=2,
                         interpret=True, return_residuals=True)
    _close(out.float(), np.asarray(j_out, np.float32), tol=2 ** -7)
    _close(lse, j_lse)


def test_spec_registry():
    for name, line, src in (
            ("flash_attention", "src/repro/kernels/flash_attention/"
             "kernel.py:82", "flash_fwd.cu"),
            ("flash_attention_bwd", "src/repro/kernels/flash_attention/"
             "kernel_bwd.py:141", "flash_bwd.cu")):
        spec = common.get_kernel(name)
        assert spec.replaces == line
        assert spec.source == ("src/repro_torch/kernels/flash_attention/"
                               f"csrc/{src}")
    assert ops.flash_attention is K.flash_attention


# ---------------------------------------------------------------------------
# Kernel 5: flash attention over an int8 K/V cache
# ---------------------------------------------------------------------------

# (hq, hkv, sq, sk, d), causal
Q8_SQUARE = [((4, 4, 64, 64, 16), True), ((4, 4, 64, 64, 16), False),
             ((8, 2, 64, 64, 16), True), ((16, 1, 32, 32, 8), True),
             ((4, 2, 40, 40, 8), True), ((2, 2, 96, 96, 16), False)]
# Sq != Sk: causal top-left (the kernel's mask), and the decode shape, one
# query per head over a cache prefix, not causal
Q8_RAGGED = [((4, 2, 16, 48, 16), True), ((2, 1, 8, 40, 16), False),
             ((16, 1, 1, 64, 16), False), ((32, 2, 1, 24, 32), False)]


def _q8_inputs(hq, hkv, sq, sk, d, seed=0, zero=()):
    """q (Hq, Sq, d) float32; k, v (Hkv, Sk, d) int8 and their scales
    (Hkv, Sk), quantized by ``repro``'s ``quantize_blocked``; the kv
    positions in ``zero`` hold all-zero vectors (scale 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(hq, sq, d)).astype(np.float32)
    out = [q]
    for _ in range(2):
        x = rng.normal(0, 2.0, (hkv, sk, d)).astype(np.float32)
        x[:, list(zero)] = 0.0
        w, s = j_quantize_blocked(jnp.asarray(x))
        out += [np.asarray(w), np.asarray(s)[..., 0]]
    q, kw, ks, vw, vs = out
    return q, kw, vw, ks, vs


@pytest.mark.parametrize("shape,causal", Q8_SQUARE)
def test_q8_plain_matches_reference_oracle(shape, causal):
    """Plain kernel 5 and the port's oracle against ``repro``'s
    ``attention_q8_nhd_ref`` (Sq == Sk), within 2e-6."""
    x = _q8_inputs(*shape, seed=5)
    group = shape[0] // shape[1]
    want = np.asarray(j_q8_ref(*map(jnp.asarray, x), causal=causal,
                               group=group))
    got = flash_q8_ref(*_t(*x), causal=causal, group=group)
    assert got.dtype == torch.float32
    _close(got, want, tol=Q8_ORACLE_TOL)
    _close(attention_q8_nhd_ref(*_t(*x), causal=causal, group=group), want,
           tol=Q8_ORACLE_TOL)


@pytest.mark.parametrize("shape,causal", Q8_SQUARE + Q8_RAGGED)
def test_q8_plain_matches_interpret_kernel(shape, causal):
    """Plain kernel 5 against the interpret-mode Pallas kernel, Sq != Sk
    included (both mask top-left), within 2e-4."""
    x = _q8_inputs(*shape, seed=6)
    group = shape[0] // shape[1]
    want = j_q8(*map(jnp.asarray, x), causal=causal, block_q=16,
                block_k=16, group=group, interpret=True)
    _close(flash_q8_ref(*_t(*x), causal=causal, group=group), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_frontend_matches_reference_frontend(dtype):
    """``repro_torch.kernels.flash_attention_q8`` on the serving cache's
    layout, from strided views of a (L, B, S, Hkv, dh) cache as a decode
    state holds it, against ``repro.kernels.flash_attention_q8`` (interpret
    mode): float32 within 2e-4; a bfloat16 q and output within 2e-4 plus
    one bfloat16 step of the value."""
    rng = np.random.default_rng(7)
    b, sq, sk, hq, hkv, d = 2, 12, 12, 8, 2, 16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q = jnp.asarray(rng.normal(size=(b, sq, hq, d)).astype(np.float32), jdt)
    cache = rng.normal(0, 2.0, (2, 3, b, sk + 4, hkv, d)).astype(np.float32)
    words, scales = j_quantize_blocked(jnp.asarray(cache))
    kw, vw = (np.asarray(words[i, 1, :, :sk]) for i in range(2))
    ks, vs = (np.asarray(scales[i, 1, :, :sk, :, 0]) for i in range(2))
    want = jops.flash_attention_q8(q, *map(jnp.asarray, (kw, vw, ks, vs)),
                                   causal=True, interpret=True)
    tw, ts = (torch.from_numpy(np.array(a)) for a in (words, scales))
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        getattr(torch, dtype))
    common.reset_counts()
    got = K.flash_attention_q8(tq, tw[0, 1, :, :sk], tw[1, 1, :, :sk],
                               ts[0, 1, :, :sk, :, 0], ts[1, 1, :, :sk, :, 0],
                               causal=True)
    spec = common.get_kernel("flash_attention_q8")
    assert (spec.launches, spec.plain_calls) == (0, 1)
    assert got.shape == (b, sq, hq, d) and got.dtype == tq.dtype
    rtol = TOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=rtol)


def test_q8_group_and_zero_vectors():
    """GQA: q head h reads kv head h // group, as the float kernel with
    the kv heads repeated.  All-zero cached vectors have scale 0 and read
    back as exact zeros, so the output is the float plain version's on
    the dequantized cache, and the Pallas kernel's within 2e-4."""
    q, kw, vw, ks, vs = _q8_inputs(8, 2, 24, 24, 16, seed=8, zero=(0, 5, 23))
    assert np.all(ks[:, [0, 5, 23]] == 0) and np.all(kw[:, [0, 5, 23]] == 0)
    tq, tkw, tvw, tks, tvs = _t(q, kw, vw, ks, vs)
    for causal in (True, False):
        got = flash_q8_ref(tq, tkw, tvw, tks, tvs, causal=causal, group=4)
        rep = [t.repeat_interleave(4, dim=0) for t in (tkw, tvw, tks, tvs)]
        assert torch.equal(got, flash_q8_ref(tq, *rep, causal=causal))
        kf, vf = (w.float() * s[..., None] for w, s in ((tkw, tks),
                                                       (tvw, tvs)))
        assert torch.all(kf[:, [0, 5, 23]] == 0)
        assert torch.equal(got, flash_fwd_ref(tq, kf, vf, causal=causal,
                                              group=4)[0])
        _close(got, j_q8(*map(jnp.asarray, (q, kw, vw, ks, vs)),
                         causal=causal, group=4, interpret=True))


def test_q8_spec_registry_and_dispatch():
    spec = common.get_kernel("flash_attention_q8")
    assert spec.replaces == ("src/repro/kernels/flash_attention/"
                             "kernel_q8.py:81")
    assert spec.source == ("src/repro_torch/kernels/flash_attention/"
                           "csrc/flash_q8.cu")
    assert spec.plain is flash_q8_ref
    assert ops.flash_attention_q8 is K.flash_attention_q8
    x = _t(*_q8_inputs(4, 2, 8, 8, 8))
    common.reset_counts()
    ops.flash_attention_q8_nhd(*x, group=2)
    assert (spec.launches, spec.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        common.dispatch(spec, x[0], x[1].to("meta"))


# ---------------------------------------------------------------------------
# The tensor-core kernels' rounding, emulated on the CPU.  Kernels 5 and 6
# multiply bf16 operands on the tensor cores with float32 sums: a float32
# operand (P, dS, p s_v, and float32 or fp16 inputs) is split into hi =
# bf16(x) and lo = bf16(x - hi), and a product of two split operands is
# hi·hi + hi·lo + lo·hi.  These tests hold that rounding, and kernel 5's
# split-key (m, l, acc) combine, to the plain versions within the kernels'
# bars before the card runs them.
# ---------------------------------------------------------------------------

_F32 = torch.float32


def _bf(x):
    return x.to(torch.bfloat16).to(_F32)


def _planes(x, split):
    """The kernels' bf16 operand planes of ``x``: (hi, lo) when split, else
    x itself (a bf16 input, exact)."""
    x = x.to(_F32)
    hi = _bf(x)
    return (hi, _bf(x - hi)) if split else (hi,)


def _mma(eq, a, b):
    """sum over plane pairs (i, j), i + j <= 1, of einsum(eq, a_i, b_j)."""
    return sum(torch.einsum(eq, a[i], b[j]) for i in range(len(a))
               for j in range(len(b)) if i + j <= 1)


def _emulated_bwd(q, k, v, do, lse, delta, *, causal, group):
    """Kernel 6's arithmetic: dq, dk, dv (dk/dv summed over the group)."""
    hkv, sk, d = k.shape
    sq = q.shape[1]
    scale = 1.0 / d ** 0.5
    split = any(t.dtype != torch.bfloat16 for t in (q, k, v, do))
    rep = (lambda t: t.repeat_interleave(group, dim=0))
    qp, op_ = _planes(q, split), _planes(do, split)
    kp = tuple(map(rep, _planes(k, split)))
    vp = tuple(map(rep, _planes(v, split)))
    s = _mma("hqd,hkd->hqk", qp, kp) * scale
    if causal:
        live = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(live, s, torch.full((), -1e30))
    p = torch.exp(s - lse[..., None])
    ds = p * (_mma("hqd,hkd->hqk", op_, vp) - delta[..., None]) * scale
    pp, dsp = _planes(p, True), _planes(ds, True)
    dq = _mma("hqk,hkd->hqd", dsp, kp)
    dk = _mma("hqk,hqd->hkd", dsp, qp).reshape(hkv, group, sk, d).sum(1)
    dv = _mma("hqk,hqd->hkd", pp, op_).reshape(hkv, group, sk, d).sum(1)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", CASES + [((1, 48, 32, 2, 16), True)])
def test_emulated_tensor_core_backward_within_bar(shape, causal, dtype):
    """Kernel 6's hi/lo rounding (P and dS always, Q, K, V and dO when
    float32) against its plain version, within its bar, atol = rtol =
    2e-4; the last shape is a GQA group of 16, as glm4-9b's."""
    q, k, v, g = (torch.from_numpy(_hsd(a)).to(dtype)
                  for a in _inputs(*shape, seed=7))
    group = shape[2] // shape[3]
    out, lse = flash_fwd_ref(q, k, v, causal=causal, group=group)
    delta = (g.float() * out.float()).sum(-1)
    want = flash_bwd_ref(q, k, v, g, lse, delta, causal=causal, group=group)
    got = _emulated_bwd(q, k, v, g, lse, delta, causal=causal, group=group)
    for a, b_ in zip(got, want):
        _close(a, b_)
    # one bf16 rounding of P and dS instead of the split misses the bar
    p_only = _planes(torch.tensor([1 / 3]), True)
    assert abs(float(p_only[0]) - 1 / 3) > TOL * (1 / 3)
    assert abs(float(p_only[0] + p_only[1]) - 1 / 3) < 2 ** -16 / 3


def _emulated_q8(q, kw, vw, ks, vs, *, causal, group, chunk):
    """Kernel 5's arithmetic: Q Wₖᵀ on exact words, the K scale after the
    dot, (p s_v) split hi/lo times W_v, each key chunk's (m, l, acc)
    combined in order of chunk."""
    hkv, sk, d = kw.shape
    sq = q.shape[1]
    rep = (lambda t: t.repeat_interleave(group, dim=0))
    qp = _planes(q, q.dtype != torch.bfloat16)
    wk, wv = rep(kw.to(_F32)), rep(vw.to(_F32))
    s = (_mma("hqd,hkd->hqk", qp, (wk,)) * rep(ks)[:, None, :]
         * (1.0 / d ** 0.5))
    live = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        live = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
    parts = []
    for c0 in range(0, max(sk, 1), chunk):
        sl = slice(c0, min(c0 + chunk, sk))
        sc = torch.where(live[:, sl], s[..., sl], torch.full((), -1e30))
        m = torch.where(live[:, sl], sc, torch.full((), -3e38)).amax(-1)
        m = torch.maximum(m, torch.full((), -1e30))
        p = torch.where(live[:, sl], torch.exp(sc - m[..., None]),
                        torch.zeros(()))
        pv = _planes(p * rep(vs)[:, None, sl], True)
        parts.append((m, p.sum(-1), _mma("hqk,hkd->hqd", pv, (wv[:, sl],))))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - big) for m, _, _ in parts]
    den = torch.clamp(sum(l * e for (_, l, _), e in zip(parts, w)), min=1e-30)
    out = sum(a * e[..., None] for (_, _, a), e in zip(parts, w))
    return (out / den[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", Q8_SQUARE + Q8_RAGGED + [
    ((32, 2, 1, 300, 16), False), ((32, 2, 1, 300, 16), True),
    ((16, 1, 3, 200, 32), False)])
def test_emulated_q8_split_keys_within_bar(shape, causal, dtype):
    """Kernel 5's rounding and its split-key combine, with the chunks the
    wrapper plans on a 132-SM card, against the plain version within its
    bars (float32 atol = rtol = 2e-4; a bf16 output atol 2e-4, rtol one
    bf16 step).  The decode shapes give several key chunks, the last one
    ragged (300 keys in chunks of 64)."""
    q, kw, vw, ks, vs = _t(*_q8_inputs(*shape, seed=8, zero=(0, 3)))
    q = q.to(dtype)
    hq, hkv, sq, sk, _ = shape
    plan = flash_kernel.q8_plan(hkv, sq, sk, hq // hkv, 132)
    assert plan["chunk"] % flash_kernel.Q8_KEY_TILE == 0
    assert plan["nsplit"] == -(-sk // plan["chunk"])
    got = _emulated_q8(q, kw, vw, ks, vs, causal=causal, group=hq // hkv,
                       chunk=plan["chunk"])
    want = flash_q8_ref(q, kw, vw, ks, vs, causal=causal, group=hq // hkv)
    rtol = TOL if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=TOL, rtol=rtol)
    if sq == 1 and sk == 300:
        assert plan["nsplit"] == 5 and plan["grid"] == (1, hkv, 5)


def test_split_plans_at_glm4_shapes():
    """The plans at glm4-9b's layouts on a 132-SM card: kernel 5's 4-slot
    decode over 4096 positions cuts the keys into 64 chunks (512 blocks of
    the decode kernel), its causal 4096-token prefill does not cut them;
    kernel 6's dK/dV pass cuts each kv head's 16 q heads into 8 parts
    (1024 blocks) and reads bf16 inputs as they are."""
    dec = flash_kernel.q8_plan(8, 1, 4096, 16, 132)
    assert dec == {"decode": True, "nsplit": 64, "chunk": 64,
                   "grid": (1, 8, 64)}
    pre = flash_kernel.q8_plan(2, 4096, 4096, 16, 132)
    assert not pre["decode"] and pre["grid"] == (1024, 2, 1)
    bwd = flash_kernel.bwd_plan(32, 2, 4096, 128, True, True, 132)
    assert bwd == {"np": 1, "planes": False, "ld": 128, "nsplit": 8}
    f32 = flash_kernel.bwd_plan(32, 2, 4096, 100, False, True, 132)
    assert (f32["np"], f32["planes"], f32["ld"]) == (2, True, 104)
    assert flash_kernel.bwd_plan(4, 4, 64, 16, True, True, 132)["nsplit"] == 1
