"""The port's rwkv6 (ssm family) against the JAX reference, on the CPU.

``repro``'s ``Model.init`` makes the parameters of the reduced rwkv6-3b
(2 layers, d_model 64, 4 heads of 16, vocab 256); the token-shift
factors, the decay base and the bonus, which it initialises to 0 and 1,
are redrawn from numpy so that every path counts.  ``params_from_numpy``
carries them into the port.  Tolerances:

* float32 under ``cordic_kernel`` and ``CORDIC_EXEC``: bit-equal logits
  and int8 state words; the float recurrent leaves (token-shift
  boundaries, the float32 wkv state, the int8 state's scales) within
  1e-6, a last bit or two: ``rms_norm``'s mean and the decay LoRA's
  float32 matmuls sum in another order (ROADMAP queue 3);
* float32 under ``matmul="bf16"`` (plain float32 matmuls, and the decay
  LoRA's matmuls under every policy): 1e-5, float32 sums taken in another
  order by the two frameworks;
* bfloat16 under ``matmul="bf16"`` and ``cordic_kernel``: equal greedy
  tokens.  The reference's compiler keeps an op's float32 result
  unrounded where the program converts it to float32 next: the decay's
  token-shift lerp (``ssm._mix_f32``) and the residual sum the channel
  mix's norm reads (``layers.residual_norm``); the port does the same.

The reference's compiled layer loop fuses float32 multiplies and adds
(token shift, the state update, the channel-mix residual) and evaluates
exp, tanh and sigmoid its own way; the port spells each out
(``core/libm.py``, ``models/ssm.py``), which is what makes the
fixed-point policies bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import CORDIC_EXEC as J_CORDIC_EXEC
from repro.configs.base import CacheSpec as JCacheSpec
from repro.configs.base import ExecutionPolicy as JPolicy
from repro.models import ssm as JS
from repro.models.model_zoo import build_model as j_build_model
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import (CORDIC_EXEC, CacheSpec, ExecutionPolicy,
                                 get_arch)
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as S
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import Request, ServeConfig, ServeEngine

torch.set_num_threads(2)

F32_TOL = 1e-5
MAX_SEQ = 64
LENS = [5, 11, 16, 3, 24, 8]
NEWS = [4, 9, 2, 12, 1, 6]
MODES = [("bf16", "float32"), ("cordic_kernel", "float32"),
         ("cordic_exec", "float32"), ("bf16", "bfloat16"),
         ("cordic_kernel", "bfloat16")]


def _policies(mode):
    if mode == "cordic_exec":
        return J_CORDIC_EXEC, CORDIC_EXEC
    return JPolicy(matmul=mode), ExecutionPolicy(matmul=mode)


def _tree(jm, seed=1):
    """The reference's init as numpy, with the zero- and one-initialised
    leaves of the mixers redrawn."""
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    tm, cm = tree["blocks"]["tm"], tree["blocks"]["cm"]
    for d, key, lo, hi in ((tm, "mu", 0.0, 1.0), (tm, "w0", -1.0, 1.0),
                           (tm, "bonus", -0.5, 0.5), (tm, "ln_w", 0.5, 1.5),
                           (cm, "mu_k", 0.0, 1.0), (cm, "mu_r", 0.0, 1.0)):
        d[key] = rng.uniform(lo, hi, d[key].shape).astype(d[key].dtype)
    return tree


def _pair(mode, dtype, cache=None):
    """(reference model, reference params, port model, port params)."""
    jpol, pol = _policies(mode)
    jcfg = dataclasses.replace(j_get_arch("rwkv6-3b").reduced().scaled(
        dtype=dtype), exec_policy=jpol)
    cfg = dataclasses.replace(get_arch("rwkv6-3b").reduced().scaled(
        dtype=dtype), exec_policy=pol)
    jm = j_build_model(jcfg)
    tree = _tree(jm)
    m = build_model(cfg, "cpu")
    if cache is not None:
        jm = jm.with_cache_spec(JCacheSpec(dtype=cache))
        m = m.with_cache_spec(CacheSpec(dtype=cache))
    return (jm, jax.tree.map(jnp.asarray, tree), m,
            params_from_numpy(tree, cfg, "cpu"))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _compare(want, got, mode, dtype):
    want, got = _f32(want), _f32(got)
    assert np.isfinite(got).all()
    if dtype == "float32" and mode != "bf16":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


STATE_TOL = 1e-6


def _compare_state(jst, tst, mode, dtype):
    """Recurrent leaves in float32: int8 words equal under the fixed-point
    policies (within one word under plain float32 matmuls); float leaves
    within STATE_TOL, or F32_TOL under plain float32 matmuls."""
    for name in ("x_prev", "cm_prev", "wkv", "wkv_scale"):
        want, got = getattr(jst, name), getattr(tst, name)
        assert (want is None) == (got is None), name
        if want is None:
            continue
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        if dtype != "float32":
            continue
        want, got = _f32(want), _f32(got)
        if tst.wkv.dtype == torch.int8 and name == "wkv":
            assert np.abs(got - want).max() <= (mode == "bf16"), name
        else:
            tol = F32_TOL if mode == "bf16" else STATE_TOL
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_mixers_match_reference(masked):
    """rwkv6_timemix and rwkv6_channelmix on converted parameters, from a
    nonzero state, with and without a pad mask, against the reference's
    compiled (jitted) functions: outputs and state within 1e-5 (plain
    float32 matmuls); pad steps leave the state exactly as it was."""
    jm, jp, m, p = _pair("bf16", "float32")
    jcfg, cfg = jm.cfg, m.cfg
    rng = np.random.default_rng(7)
    b, t, d, h = 3, 8, cfg.d_model, cfg.n_heads
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    xp = rng.normal(size=(b, d)).astype(np.float32)
    s0 = rng.normal(size=(b, h, d // h, d // h)).astype(np.float32) * 0.3
    lengths = np.array([8, 3, 5], np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]) if masked else None
    ln = lengths if masked else None
    jtm = jax.tree.map(lambda a: a[0], jp["blocks"]["tm"])
    jcmp = jax.tree.map(lambda a: a[0], jp["blocks"]["cm"])
    want, (wxp, ws) = jax.jit(lambda x, xp, s, mask, ln: JS.rwkv6_timemix(
        x, JS.Rwkv6Params(**jtm), jcfg, jcfg.exec_policy, (xp, s), mask=mask,
        lengths=ln))(x, xp, s0, mask, ln)
    tm = {k: v[0] for k, v in p["blocks"]["tm"].items()}
    tmask = None if mask is None else torch.from_numpy(mask)
    tln = None if ln is None else torch.from_numpy(ln)
    got, (gxp, gs) = S.rwkv6_timemix(
        torch.from_numpy(x), S.Rwkv6Params(**tm), cfg, cfg.exec_policy,
        (torch.from_numpy(xp), torch.from_numpy(s0)), mask=tmask,
        lengths=tln)
    for a, b_ in ((want, got), (wxp, gxp), (ws, gs)):
        np.testing.assert_allclose(_f32(b_), _f32(a), rtol=F32_TOL,
                                   atol=F32_TOL)
    if masked:
        # row 1 sees 3 real steps: its state equals an unpadded 3-step run
        _, (_, s3) = S.rwkv6_timemix(
            torch.from_numpy(x[1:2, :3]), S.Rwkv6Params(**tm), cfg,
            cfg.exec_policy, (torch.from_numpy(xp[1:2]),
                              torch.from_numpy(s0[1:2])))
        assert torch.equal(s3, gs[1:2])
        np.testing.assert_array_equal(_f32(gxp[1]), x[1, 2])
    want, wcp = jax.jit(lambda x, xp, ln: JS.rwkv6_channelmix(
        x, JS.Rwkv6ChannelParams(**jcmp), jcfg, jcfg.exec_policy, xp,
        lengths=ln))(x, xp, ln)
    cmp = {k: v[0] for k, v in p["blocks"]["cm"].items()}
    got, gcp = S.rwkv6_channelmix(
        torch.from_numpy(x), S.Rwkv6ChannelParams(**cmp), cfg,
        cfg.exec_policy, torch.from_numpy(xp), lengths=tln)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(_f32(gcp), _f32(wcp))


@pytest.mark.parametrize("mode,dtype", MODES)
def test_forward_matches_reference(mode, dtype):
    jm, jp, m, p = _pair(mode, dtype)
    toks = _tokens((2, 12))
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 12, 256)
    _compare(want, got, mode, dtype)


@pytest.mark.parametrize("cache", [None, "int8"])
@pytest.mark.parametrize("mode,dtype", MODES)
def test_prefill_and_decode_match_reference(mode, dtype, cache):
    """Prefill of 2 x 9 tokens, then 3 decode steps: logits each step, and
    the recurrent state after prefill and after every step — in the int8
    mode the int8 words and scales, word for word where the float state
    is bit-equal."""
    jm, jp, m, p = _pair(mode, dtype, cache)
    toks = _tokens((2, 9), seed=2)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, headroom=4)
    with torch.inference_mode():
        tl, tst = m.prefill(p, {"tokens": torch.from_numpy(toks)}, headroom=4)
    _compare(jl, tl, mode, dtype)
    _compare_state(jst, tst, mode, dtype)
    assert (tst.wkv.dtype == torch.int8) == (cache == "int8")
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(nxt)})
        with torch.inference_mode():
            tl, tst = m.decode_step(p, tst, {"tokens": torch.from_numpy(nxt)})
        _compare(jl, tl, mode, dtype)
        _compare_state(jst, tst, mode, dtype)
        assert int(tst.pos) == int(jst.pos)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("cache", [None, "int8"])
def test_padded_prefill_matches_reference_and_unpadded(cache):
    """Right-padded rows: each row's last-real-position logits, per-row
    pos, and a recurrent state bit-equal to the unpadded prefill of that
    row alone (pad steps are exact no-ops) and to the reference's."""
    jm, jp, m, p = _pair("cordic_kernel", "float32", cache)
    toks = _tokens((3, 16), seed=3)
    lengths = np.array([16, 5, 11], np.int32)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, headroom=0,
                         lengths=jnp.asarray(lengths))
    with torch.inference_mode():
        tl, tst = m.prefill(p, {"tokens": torch.from_numpy(toks)}, headroom=0,
                            lengths=torch.from_numpy(lengths))
        _compare(jl, tl, "cordic_kernel", "float32")
        _compare_state(jst, tst, "cordic_kernel", "float32")
        np.testing.assert_array_equal(tst.pos.numpy(), lengths)
        for row, n in enumerate(lengths):
            one_l, one = m.prefill(
                p, {"tokens": torch.from_numpy(toks[row:row + 1, :n])},
                headroom=0)
            assert torch.equal(one_l[0], tl[row])
            for name in ("x_prev", "cm_prev", "wkv", "wkv_scale"):
                leaf = getattr(one, name)
                if leaf is not None:
                    assert torch.equal(leaf[:, 0], getattr(tst, name)[:, row])


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENS]


def _single_stream(model, params, prompt, max_new):
    with torch.inference_mode():
        lg, st = model.prefill(params,
                               {"tokens": torch.from_numpy(prompt)[None]},
                               headroom=MAX_SEQ - len(prompt))
        cur = int(lg.reshape(-1).argmax())
        seq = [cur]
        for _ in range(max_new - 1):
            lg, st = model.decode_step(params, st,
                                       {"tokens": torch.tensor([[cur]])})
            cur = int(lg.reshape(-1).argmax())
            seq.append(cur)
    return seq


@pytest.mark.parametrize("knob", [{}, {"cache": "int8"},
                                  {"cache_dtype": "int8"}])
def test_engine_matches_single_stream_and_reference(knob):
    """6 requests of mixed length through 4 slots (slots retire and
    refill), float32 under ``cordic_kernel``: the port's engine equals the
    port's single-stream decode per request, and the reference's engine
    for the same traffic, with the float32 and the int8 state (both
    spellings of the int8 format)."""
    jm, jp, m, p = _pair("cordic_kernel", "float32")
    jknob = dict(knob)
    tknob = dict(knob)
    if "cache" in knob:
        jknob["cache"] = JCacheSpec(dtype="int8")
        tknob["cache"] = CacheSpec(dtype="int8")
    prompts = _prompts()
    want = {r.rid: r.output.tolist() for r in JServeEngine(
        jm, jp, JServeConfig(max_batch=4, max_seq=MAX_SEQ, **jknob)).serve(
        [JRequest(i, pr, max_new_tokens=n)
         for i, (pr, n) in enumerate(zip(prompts, NEWS))])}
    eng = ServeEngine(m, p, ServeConfig(max_batch=4, max_seq=MAX_SEQ, **tknob))
    got = {r.rid: r.output.tolist() for r in eng.serve(
        [Request(i, pr, max_new_tokens=n)
         for i, (pr, n) in enumerate(zip(prompts, NEWS))])}
    assert got == want
    assert (eng.model.cfg.cache_spec().quantized) == bool(knob)
    served = eng.model
    for i, (pr, n) in enumerate(zip(prompts, NEWS)):
        assert got[i] == _single_stream(served, p, pr, n), i
    assert len({t for out in got.values() for t in out}) > 3


@pytest.mark.parametrize("policy", ["bf16", "cordic_kernel", "cordic_exec"])
def test_launcher_serves_rwkv6_on_the_cpu(capsys, policy):
    from repro_torch.launch.serve import main
    assert main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--max-seq", "64",
                 "--policy", policy]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "on cpu" in out
