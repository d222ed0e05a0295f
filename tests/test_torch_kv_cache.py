"""The port's int8 K/V caches against the JAX reference, on the CPU.

Two formats of the dense family's decode cache:

* ``CacheSpec(dtype="int8")``: int8 words with one float32 scale per
  (position, kv head) vector (``core/quant_cache.py``), quantized on
  write, dequantized on read;
* ``CacheSpec(dtype="fxp8")`` (``kv_cache_bits=8``): int8 words at the
  fixed Q3.4 scale of the paper's FxP8 cache study.

The same numpy inputs go through ``repro`` and the port.  Bars:

* the quantizer: words and scales bit-equal to ``repro``'s; the
  round-trip error within half a quantization step, plus (in the seeded
  port of ``test_quant_numerics.py``) one float32 ulp of |x| for the
  roundings of ``x / scale`` and ``q * scale`` that the reference's own
  bound leaves out (ROADMAP queue 3);
* the reduced glm4-9b in float32: under ``cordic_kernel`` and
  ``CORDIC_EXEC`` the int8 words, the scales and the logits equal
  ``repro``'s; under the float32 matmul the words equal (measured at
  these inputs), the logits within 1e-5 and the scales within the same
  bar over 127 (float32 sums in another order: ``test_torch_model.py``
  holds the unquantized cache within 1e-5, and a scale is amax / 127);
* the engine: greedy outputs equal single-stream decode (float32 and
  ``cordic_kernel`` matmuls), and equal ``repro``'s engine on the same
  mix (also under ``CORDIC_EXEC``, whose activation scale couples a
  batch).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import CORDIC_EXEC as J_CORDIC_EXEC
from repro.configs.base import CacheSpec as JCacheSpec
from repro.configs.base import ExecutionPolicy as JPolicy
from repro.core import quant_cache as jqc
from repro.models import attention as JA
from repro.models.model_zoo import build_model as j_build_model
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import (CORDIC_EXEC, CacheSpec, ExecutionPolicy,
                                 get_arch)
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant_cache as qc
from repro_torch.models import attention as A
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import Request, ServeConfig, ServeEngine

_BASELINE = os.path.join(os.path.dirname(__file__), os.pardir,
                         "benchmarks", "quant_baseline.json")
F32_TOL = 1e-5
SCALE_TOL = F32_TOL / 127            # a scale is its vector's amax / 127
MAX_SEQ = 64
LENS = [5, 11, 16, 3, 24, 8]
NEWS = [4, 9, 2, 12, 1, 6]
# (L, B, S, Hkv, dh): the decode state's K/V layout
KV_SHAPE = (2, 3, 8, 2, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads here, the process's own count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both_quantize(x: np.ndarray, block=None):
    """(port words, port scales, repro words, repro scales) of ``x``."""
    q, s = qc.quantize_blocked(torch.from_numpy(x), block)
    jq, js = jqc.quantize_blocked(jnp.asarray(x), block)
    return q, s, np.asarray(jq), np.asarray(js)


# ---------------------------------------------------------------- roundtrip
# tests/test_quant_cache.py, on the K/V layout besides its own shapes

@pytest.mark.parametrize("shape", [(16,), (3, 5, 32), (2, 4, 8, 16),
                                   KV_SHAPE])
def test_roundtrip_error_bound(shape):
    x = np.random.default_rng(0).normal(0, 3.0, shape).astype(np.float32)
    q, s, jq, js = _both_quantize(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    dq = qc.dequantize_blocked(q, s).numpy()
    bound = np.broadcast_to(s.numpy() / 2.0 + 1e-12, x.shape)
    assert np.all(np.abs(x - dq) <= bound)


@pytest.mark.parametrize("shape", [(4, 32), KV_SHAPE[:-1] + (32,)])
def test_blocked_scales(shape):
    x = np.random.default_rng(1).normal(0, 1.0, shape).astype(np.float32)
    q, s, jq, js = _both_quantize(x, block=8)
    assert tuple(s.shape) == shape[:-1] + (4,)
    np.testing.assert_array_equal(s.numpy(), js)
    dq = qc.dequantize_blocked(q, s).numpy()
    step = np.repeat(s.numpy(), 8, axis=-1)
    assert np.all(np.abs(x - dq) <= step / 2.0 + 1e-12)


def test_zero_vectors_exact():
    """An all-zero K/V vector keeps scale 0 (not an epsilon) and reads back
    as exact zeros, next to live vectors."""
    x = np.random.default_rng(2).normal(0, 1.0, KV_SHAPE).astype(np.float32)
    x[:, :, 3] = 0.0                          # one position, every head
    x[1, 0, :, 1] = 0.0                       # one head, every position
    q, s, jq, js = _both_quantize(x)
    np.testing.assert_array_equal(s.numpy(), js)
    assert np.all(s.numpy()[:, :, 3] == 0.0)
    assert np.all(q.numpy()[:, :, 3] == 0)
    dq = qc.dequantize_blocked(q, s).numpy()
    assert np.all(dq[:, :, 3] == 0.0) and np.all(dq[1, 0, :, 1] == 0.0)
    zq, zs = qc.quantize_blocked(torch.zeros(KV_SHAPE))
    assert torch.all(zs == 0) and torch.all(
        qc.dequantize_blocked(zq, zs) == 0)


def test_scatter_then_read_equals_read_then_scatter():
    """Per-vector scales: quantizing rows and scattering them along the
    slot (batch) axis gives the cache that quantizing the scattered float
    cache gives, which ``slot_update`` relies on."""
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.normal(0, 1.0, KV_SHAPE).astype(np.float32))
    rows = torch.from_numpy(rng.normal(0, 2.0, (2, 2) + KV_SHAPE[2:])
                            .astype(np.float32))
    idx = torch.tensor([2, 0])
    qcache, scache = qc.quantize_blocked(cache)
    qrows, srows = qc.quantize_blocked(rows)
    qcache[:, idx], scache[:, idx] = qrows, srows
    cache[:, idx] = rows
    q2, s2 = qc.quantize_blocked(cache)
    assert torch.equal(qcache, q2) and torch.equal(scache, s2)


def test_permutation_invariance():
    x = np.random.default_rng(4).normal(0, 1.0, KV_SHAPE).astype(np.float32)
    perm = torch.from_numpy(np.random.default_rng(4).permutation(KV_SHAPE[1]))
    q, s = qc.quantize_blocked(torch.from_numpy(x))
    qp, sp = qc.quantize_blocked(torch.from_numpy(x)[:, perm])
    assert torch.equal(q[:, perm], qp) and torch.equal(s[:, perm], sp)


# ---------------------------------------------------------------- numerics
# tests/test_quant_numerics.py's three properties over fixed seeds

def _draw(seed: int, shape, scale: float, dtype):
    """A seeded float32 normal, rounded to ``dtype`` in both packages."""
    x = np.random.default_rng(seed).normal(0.0, scale, shape).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return tx, jx


SEEDS = range(10)


@pytest.mark.parametrize("seed", SEEDS)
def test_numerics_roundtrip_bound(seed):
    """|x - dq(q(x))| <= step / 2 + 1e-12 mag + one float32 ulp of |x|;
    words and scales equal ``repro``'s; all-zero blocks come back exact."""
    rng = np.random.default_rng(1000 + seed)
    rows, cols = int(rng.integers(1, 7)), int(rng.choice([8, 16, 32, 64]))
    blk = [None, 8, 16][int(rng.integers(0, 3))]
    blk = None if blk is not None and cols % blk else blk
    mag = float(10.0 ** rng.uniform(-3, 3))
    dtype = (jnp.float32, jnp.bfloat16)[seed % 2]
    tx, jx = _draw(seed, (rows, cols), mag, dtype)
    q, s = qc.quantize_blocked(tx, blk)
    jq, js = jqc.quantize_blocked(jx, blk)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    nb = 1 if blk is None else cols // blk
    assert tuple(s.shape) == (rows, nb)
    dq = qc.dequantize_blocked(q, s).numpy().astype(np.float64)
    xf = tx.to(torch.float32).numpy()
    step = np.repeat(s.numpy().astype(np.float64), cols // nb, axis=-1)
    ulp = np.spacing(np.abs(xf)).astype(np.float64)
    assert np.all(np.abs(xf.astype(np.float64) - dq)
                  <= step / 2.0 + 1e-12 * mag + ulp)
    zq, zs = qc.quantize_blocked(torch.zeros_like(tx), blk)
    assert torch.all(zs == 0) and torch.all(qc.dequantize_blocked(zq, zs) == 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_numerics_scatter_commutes(seed):
    rng = np.random.default_rng(2000 + seed)
    slots = int(rng.integers(2, 9))
    nupd = min(int(rng.integers(1, 5)), slots)
    dtype = (jnp.float32, jnp.bfloat16)[seed % 2]
    cache, _ = _draw(seed, (slots, 5, 16), 1.0, dtype)
    rows, _ = _draw(seed + 100, (nupd, 5, 16), 2.0, dtype)
    idx = torch.from_numpy(rng.choice(slots, nupd, replace=False))
    q1, s1 = qc.quantize_blocked(cache)
    qr, sr = qc.quantize_blocked(rows)
    q1[idx], s1[idx] = qr, sr
    scattered = cache.clone()
    scattered[idx] = rows
    q2, s2 = qc.quantize_blocked(scattered)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert torch.equal(qc.dequantize_blocked(q1, s1),
                       qc.dequantize_blocked(q2, s2))


@pytest.mark.parametrize("seed", SEEDS)
def test_numerics_permutation_invariance(seed):
    rng = np.random.default_rng(3000 + seed)
    slots = int(rng.integers(2, 9))
    blk = [None, 8][int(rng.integers(0, 2))]
    dtype = (jnp.float32, jnp.bfloat16)[seed % 2]
    x, _ = _draw(seed, (slots, 3, 16), 1.0, dtype)
    perm = torch.from_numpy(rng.permutation(slots))
    q, s = qc.quantize_blocked(x, blk)
    qp, sp = qc.quantize_blocked(x[perm], blk)
    assert torch.equal(q[perm], qp) and torch.equal(s[perm], sp)


# ------------------------------------------------------ the legacy format

def test_fxp8_words_match_reference():
    """``quantize_kv``/``dequantize_kv``: round(x * 16) clipped to +-127,
    float32 and bfloat16 inputs, bit for bit."""
    x = np.concatenate([np.random.default_rng(5).normal(0, 4.0, 500),
                        [0.03125, -0.03125, 0.09375, 7.9375, 8.0, -9.0,
                         1e6, -1e6]]).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        jx = jnp.asarray(x, dtype)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        w = A.quantize_kv(tx)
        np.testing.assert_array_equal(w.numpy(), np.asarray(JA.quantize_kv(jx)))
        assert int(w.max()) == 127 and int(w.min()) == -127
        for out in (torch.float32, torch.bfloat16):
            back = A.dequantize_kv(w, out)
            want = JA.dequantize_kv(jnp.asarray(w.numpy()),
                                    jnp.float32 if out == torch.float32
                                    else jnp.bfloat16)
            assert back.dtype == out
            np.testing.assert_array_equal(back.float().numpy(),
                                          np.asarray(want, np.float32))
    f = torch.ones(3, dtype=torch.bfloat16)
    assert A.dequantize_kv(f, torch.float32).dtype == torch.float32


# ------------------------------------------------------------- validation

def test_int8_and_legacy_kv_bits_are_mutually_exclusive():
    cfg = get_arch("glm4-9b").reduced().scaled(cache_quant="int8",
                                               kv_cache_bits=8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_model(cfg, "cpu")


def test_unknown_cache_quant_rejected():
    with pytest.raises(ValueError, match="cache_quant"):
        build_model(get_arch("glm4-9b").reduced().scaled(cache_quant="int4"),
                    "cpu")


def test_with_cache_dtype():
    model = build_model(get_arch("glm4-9b").reduced(), "cpu")
    assert model.with_cache_dtype(None) is model
    assert model.with_cache_dtype("none") is model
    q = model.with_cache_dtype("int8")
    assert q.cfg.cache_quant == "int8" and q.cfg.cache_spec().quantized
    assert q.with_cache_dtype("int8") is q
    assert q.device == model.device
    with pytest.raises(ValueError):
        model.with_cache_dtype("fp8")
    f = model.with_cache_spec(CacheSpec(dtype="fxp8"))
    assert f.cfg.cache_spec() == CacheSpec(dtype="fxp8")
    assert f.with_cache_spec(CacheSpec(dtype="fxp8")) is f


@pytest.mark.parametrize("cache", ["int8", "fxp8", "native"])
def test_decode_state_layout_matches_reference(cache):
    """Fields, shapes and dtypes of the slot state of each format."""
    jcfg = j_get_arch("glm4-9b").reduced().scaled(
        cache=JCacheSpec(dtype=cache))
    cfg = get_arch("glm4-9b").reduced().scaled(cache=CacheSpec(dtype=cache))
    want = j_build_model(jcfg).init_slot_state(4, 32, abstract=True)
    got = build_model(cfg, "cpu").init_slot_state(4, 32)
    for name in ("cache_k", "cache_v", "scale_k", "scale_v", "pos"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            assert not torch.any(g != 0), name


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b"])
def test_int8_state_at_least_2x_smaller_than_fp32(arch):
    floor = json.load(open(_BASELINE))["slots_per_gb_floor"]
    model = build_model(get_arch(arch).reduced().scaled(dtype="float32"),
                        "cpu")
    sizes = {}
    for name, m in (("fp", model), ("q", model.with_cache_dtype("int8"))):
        st = m.init_slot_state(4, 64)
        sizes[name] = sum(t.numel() * t.element_size() for t in st
                          if t is not None)
    assert sizes["fp"] / sizes["q"] >= floor, (arch, sizes)


# ------------------------------------------------------------------ model

def _pair(mode: str, cache=None):
    """(repro model, repro params, port model, port params): reduced
    glm4-9b in float32 with the ``cache`` format (None: the native cache
    with no format pinned), biases nonzero."""
    if mode == "cordic_exec":
        jpol, pol = J_CORDIC_EXEC, CORDIC_EXEC
    else:
        jpol, pol = JPolicy(matmul=mode), ExecutionPolicy(matmul=mode)
    jcfg = dataclasses.replace(_j_arch(cache), exec_policy=jpol)
    cfg = dataclasses.replace(get_arch("glm4-9b").reduced().scaled(
        dtype="float32", cache=cache and CacheSpec(dtype=cache)),
        exec_policy=pol)
    jm = j_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    attn = tree["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (rng.standard_normal(attn[b].shape) * 0.1).astype(
            attn[b].dtype)
    return (jm, jax.tree.map(jnp.asarray, tree), build_model(cfg, "cpu"),
            params_from_numpy(tree, cfg, "cpu"))


def _j_arch(cache):
    """Reduced glm4-9b of the reference in float32 with ``cache``."""
    return j_get_arch("glm4-9b").reduced().scaled(
        dtype="float32", cache=cache and JCacheSpec(dtype=cache))


def _check_state(jst, tst, mode: str):
    for name in ("cache_k", "cache_v"):
        w, g = np.asarray(getattr(jst, name)), getattr(tst, name)
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for name in ("scale_k", "scale_v"):
        w, g = getattr(jst, name), getattr(tst, name)
        assert (w is None) == (g is None), name
        if w is None:
            continue
        if mode == "bf16":
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=SCALE_TOL, rtol=F32_TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def _check_logits(want, got, mode: str):
    want, got = np.asarray(want, np.float32), got.numpy()
    if mode == "bf16":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cache", ["int8", "fxp8"])
@pytest.mark.parametrize("mode", ["bf16", "cordic_kernel", "cordic_exec"])
def test_prefill_and_decode_match_reference(mode, cache):
    """Prefill logits, 8 greedy decode steps' logits, and after each the
    cache words and scales against ``repro``'s ``Model``."""
    jm, jp, m, p = _pair(mode, cache)
    toks = np.random.default_rng(2).integers(0, 256, (2, 9)).astype(np.int32)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, headroom=8)
    with torch.inference_mode():
        tl, tst = m.prefill(p, {"tokens": torch.from_numpy(toks)}, headroom=8)
    _check_logits(jl, tl, mode)
    _check_state(jst, tst, mode)
    assert torch.all(tst.cache_k[:, :, 9:] == 0)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(8):
        jl, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(nxt)})
        with torch.inference_mode():
            tl, tst = m.decode_step(p, tst, {"tokens": torch.from_numpy(nxt)})
        _check_logits(jl, tl, mode)
        assert int(tst.pos) == int(jst.pos)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _check_state(jst, tst, mode)


def test_slot_update_moves_words_and_scales():
    """A prefill's int8 words and scales land at their slots word for
    word, padded with zeros past the prompt; a sentinel row drops; a
    state of another format is refused rather than cast."""
    _, _, m, p = _pair("bf16", "int8")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 6)).astype(np.int32))
    with torch.inference_mode():
        _, sub = m.prefill(p, {"tokens": toks}, headroom=0,
                           lengths=torch.tensor([6, 4]))
        state = m.init_slot_state(3, 16)
        m.slot_update(state, sub, [2, 3])          # row 1 -> sentinel
    for name in ("cache_k", "cache_v", "scale_k", "scale_v"):
        tgt, src = getattr(state, name), getattr(sub, name)
        assert torch.equal(tgt[:, 2, :6], src[:, 0]), name
        assert not torch.any(tgt[:, 2, 6:] != 0), name
        assert not torch.any(tgt[:, :2] != 0), name
    assert state.pos.tolist() == [0, 0, 6]
    native = build_model(dataclasses.replace(m.cfg, cache=None), "cpu")
    with pytest.raises(ValueError, match="cache format"):
        native.slot_update(native.init_slot_state(3, 16), sub, [0, 1])


# ----------------------------------------------------------------- engine

def _prompts(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENS]


def _single_stream(model, params, prompt, max_new):
    with torch.inference_mode():
        lg, st = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                               headroom=MAX_SEQ - len(prompt))
        seq = [int(lg.reshape(-1).argmax())]
        for _ in range(max_new - 1):
            lg, st = model.decode_step(params, st,
                                       {"tokens": torch.tensor([[seq[-1]]])})
            seq.append(int(lg.reshape(-1).argmax()))
    return seq


@pytest.mark.parametrize("cache", ["int8", "fxp8"])
@pytest.mark.parametrize("mode", ["bf16", "cordic_kernel"])
def test_engine_matches_single_stream(mode, cache):
    """6 requests through 3 slots (retire and refill): each equals the
    port's own unbatched prefill + decode with the same cache format."""
    _, _, model, params = _pair(mode, cache)
    eng = ServeEngine(model, params, ServeConfig(max_batch=3, max_seq=MAX_SEQ))
    done = eng.serve([Request(i, pr, max_new_tokens=n)
                      for i, (pr, n) in enumerate(zip(_prompts(1), NEWS))])
    assert len(done) == len(LENS)
    assert eng.model.cfg.cache_spec().dtype == cache
    for r in done:
        assert r.output.tolist() == _single_stream(model, params, r.prompt,
                                                   r.max_new_tokens), r.rid
    admits = [e for e in eng.events if e[0] == "admit"]
    assert len({e[2] for e in admits}) <= 3 < len(admits)


@pytest.mark.parametrize("mode", ["bf16", "cordic_exec"])
def test_engine_matches_reference_engine(mode):
    """The int8 cache through both engines (``cache_dtype="int8"``), the
    same mix: equal outputs per request, finish order and decode steps."""
    jm, jp, native, p = _pair(mode)              # each engine applies int8
    reqs = list(zip(_prompts(0), NEWS))
    jeng = JServeEngine(jm, jp, JServeConfig(max_batch=4, max_seq=MAX_SEQ,
                                             cache_dtype="int8"))
    want = {r.rid: r.output.tolist() for r in jeng.serve(
        [JRequest(i, pr, max_new_tokens=n) for i, (pr, n) in enumerate(reqs)])}
    eng = ServeEngine(native, p, ServeConfig(max_batch=4, max_seq=MAX_SEQ,
                                             cache_dtype="int8"))
    done = eng.serve([Request(i, pr, max_new_tokens=n)
                      for i, (pr, n) in enumerate(reqs)])
    assert eng.model.cfg.cache_spec().quantized
    assert {r.rid: r.output.tolist() for r in done} == want
    assert [r.rid for r in done] == list(want)
    assert eng.metrics["decode_steps"] == jeng.metrics["decode_steps"]


def test_engine_int8_within_committed_ceiling():
    """``tests/test_quant_cache.py::test_engine_int8_within_committed_ceiling``
    for glm4-9b: int8-cache decode tracks float-cache decode within the
    committed logit-error ceiling (``benchmarks/quant_baseline.json``),
    and the engine serves mixed lengths with the int8 cache."""
    ceiling = json.load(open(_BASELINE))["max_logit_err"]["glm4-9b"]
    cfg = get_arch("glm4-9b").reduced().scaled(dtype="float32")
    model = build_model(cfg, "cpu")
    model_q = model.with_cache_dtype("int8")
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, 7).astype(np.int64)[None])}
    with torch.inference_mode():
        lg_f, st_f = model.prefill(params, batch, headroom=16)
        lg_q, st_q = model_q.prefill(params, batch, headroom=16)
        worst = float((lg_f - lg_q).abs().max())
        cur = int(lg_f.reshape(-1).argmax())
        for _ in range(8):
            nb = {"tokens": torch.tensor([[cur]])}
            lg_f, st_f = model.decode_step(params, st_f, nb)
            lg_q, st_q = model_q.decode_step(params, st_q, nb)
            worst = max(worst, float((lg_f - lg_q).abs().max()))
            cur = int(lg_f.reshape(-1).argmax())
    assert 0 < worst <= ceiling, (worst, ceiling)
    eng = ServeEngine(model, params, ServeConfig(max_batch=4, max_seq=64,
                                                 cache_dtype="int8"))
    news = [4, 3, 5]
    done = {r.rid: r for r in eng.serve(
        [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                 max_new_tokens=k)
         for i, (n, k) in enumerate(zip((3, 9, 5), news))])}
    assert len(done) == 3
    assert all(len(done[i].output) == k for i, k in enumerate(news))
    assert set(eng.prefill_counts) == {16}
