"""The port's dense model against the JAX reference, on the CPU.

``repro``'s ``Model.init`` makes the parameters (biases redrawn nonzero
from numpy so the bias path counts); ``params_from_numpy`` carries them
into the port.  Tolerances:

* float32 under ``matmul="bf16"`` (a plain float32 matmul): 1e-5, float32
  sums taken in another order;
* float32 under ``matmul="cordic_kernel"``: equal greedy tokens and logits
  within 8 LSBs of FXP16 (8 * 2**-8): the raw products are bit-exact, but
  a 1-ulp float32 difference before ``quantize`` can move one word;
* the paper's ``CORDIC_EXEC`` (W8A8 matmuls, DA-VINCI AFs): bit-equal
  logits, float32 (with and without ``softmax_cordic``) and bfloat16;
* bfloat16 under ``matmul="bf16"`` and ``cordic_kernel``: equal greedy
  tokens.

In bfloat16 the norm after each residual add reads the sum's float32
value, as the reference's compiled block does (``layers.residual_norm``),
and under ``CORDIC_EXEC`` a block's W8A8 projections rescale by the
activation scale's float32 value before its bfloat16 rounding, as that
block does too (``wide_scale`` in ``core/quantization.py``); the head
after the blocks runs op by op in the reference and rounds the scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import CORDIC_EXEC as J_CORDIC_EXEC
from repro.configs.base import CordicPolicy as JCordicPolicy
from repro.configs.base import ExecutionPolicy as JPolicy
from repro.models import layers as JL
from repro.models.model_zoo import build_model as j_build_model
from repro_torch.configs import (CORDIC_EXEC, CacheSpec, CordicPolicy,
                                 ExecutionPolicy, get_arch)
from repro_torch.convert import params_from_numpy
from repro_torch.core.fixed_point import FXP16
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model
from repro_torch.models.spec import materialize

torch.set_num_threads(2)

F32_TOL = 1e-5
CORDIC_ATOL = 8 * FXP16.resolution


def _policies(mode: str):
    """(reference policy, port policy) for a mode name: a matmul datapath,
    or ``cordic_exec`` / ``cordic_exec_softmax`` for the paper's policy
    without / with the CORDIC softmax."""
    if mode.startswith("cordic_exec"):
        sm = mode == "cordic_exec_softmax"
        return (dataclasses.replace(J_CORDIC_EXEC, softmax_cordic=sm),
                dataclasses.replace(CORDIC_EXEC, softmax_cordic=sm))
    return JPolicy(matmul=mode), ExecutionPolicy(matmul=mode)


def _pair(matmul: str, dtype: str, **arch):
    """(reference model, reference params, port model, port params)."""
    jpol, pol = _policies(matmul)
    jcfg = dataclasses.replace(j_get_arch("glm4-9b").reduced().scaled(
        dtype=dtype, **arch), exec_policy=jpol)
    cfg = dataclasses.replace(get_arch("glm4-9b").reduced().scaled(
        dtype=dtype, **arch), exec_policy=pol)
    jm = j_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    attn = tree["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (rng.standard_normal(attn[b].shape) * 0.1).astype(
            attn[b].dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    m = build_model(cfg, "cpu")
    return jm, jp, m, params_from_numpy(tree, cfg, "cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.to(torch.float32).numpy()


def _compare(want, got, matmul, dtype):
    want, got = _f32(want), _f32(got)
    if matmul.startswith("cordic_exec"):
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if dtype == "float32" and matmul == "bf16":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=CORDIC_ATOL)


MODES = [("bf16", "float32"), ("cordic_kernel", "float32"),
         ("bf16", "bfloat16"), ("cordic_exec", "float32"),
         ("cordic_exec_softmax", "float32"), ("cordic_kernel", "bfloat16"),
         ("cordic_exec", "bfloat16")]


@pytest.mark.parametrize("matmul,dtype", MODES)
def test_forward_matches_reference(matmul, dtype):
    jm, jp, m, p = _pair(matmul, dtype)
    toks = _tokens((2, 12))
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 12, 256) and got.dtype == m.params_spec()[
        "lm_head"].dtype
    _compare(want, got, matmul, dtype)


@pytest.mark.parametrize("matmul,dtype", MODES)
def test_prefill_and_decode_match_reference(matmul, dtype):
    jm, jp, m, p = _pair(matmul, dtype)
    toks = _tokens((2, 9), seed=2)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, headroom=4)
    with torch.inference_mode():
        tl, tst = m.prefill(p, {"tokens": torch.from_numpy(toks)}, headroom=4)
    _compare(jl, tl, matmul, dtype)
    assert tuple(tst.cache_k.shape) == jst.cache_k.shape
    if dtype == "float32":
        np.testing.assert_allclose(_f32(tst.cache_k), _f32(jst.cache_k),
                                   rtol=1e-5, atol=1e-5)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(nxt)})
        with torch.inference_mode():
            tl, tst = m.decode_step(p, tst, {"tokens": torch.from_numpy(nxt)})
        _compare(jl, tl, matmul, dtype)
        assert int(tst.pos) == int(jst.pos)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("head_dim", [32, 128])
def test_cordic_exec_bfloat16_bit_equal_at_wider_heads(head_dim):
    """bfloat16 ``CORDIC_EXEC`` at head widths whose 1/sqrt(head_dim) is
    not a power of two (glm4-9b's is 128): the block scales its scores as
    the reference's compiled block does (``attention._scaled``): forward,
    prefill and 2 decode steps give bit-equal logits."""
    jm, jp, m, p = _pair("cordic_exec", "bfloat16", head_dim=head_dim,
                         d_model=4 * head_dim)
    toks = _tokens((2, 9), seed=3)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, headroom=2)
    with torch.inference_mode():
        got = m.forward(p, {"tokens": torch.from_numpy(toks)})
        tl, tst = m.prefill(p, {"tokens": torch.from_numpy(toks)},
                            headroom=2)
    _compare(want, got, "cordic_exec", "bfloat16")
    _compare(jl, tl, "cordic_exec", "bfloat16")
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(nxt)})
        with torch.inference_mode():
            tl, tst = m.decode_step(p, tst, {"tokens": torch.from_numpy(nxt)})
        _compare(jl, tl, "cordic_exec", "bfloat16")


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 10000.0),
                                            (128, 1000000.0)])
def test_rope_matches_reference_bit_for_bit(head_dim, theta):
    """The rotary embedding in float32, positions 0-299 (both reductions
    of sin/cos), as the reference's compiled model computes it: the
    inverse frequencies folded in float64, ``sinf``/``cosf``, the
    rotation's multiply-adds fused."""
    pos = np.arange(300, dtype=np.int32)
    x = np.random.default_rng(6).normal(size=(2, 300, 2, head_dim)).astype(
        np.float32)
    want = jax.jit(lambda p, v: JL.apply_rope(
        v, JL.rope_angles(p, head_dim, theta)))(jnp.asarray(pos),
                                                jnp.asarray(x))
    got = L.apply_rope(torch.from_numpy(x), L.rope_sincos(
        torch.from_numpy(pos), head_dim, theta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_impls_match_reference(impl):
    """The online-softmax chunked path (taken above 2048 keys) on a short
    sequence cut into chunks of 4, and the naive path, forced by name."""
    jm, jp, m, p = _pair("bf16", "float32", attn_impl=impl, attn_chunk=4)
    toks = _tokens((2, 12), seed=4)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = m.forward(p, {"tokens": torch.from_numpy(toks)})
    _compare(want, got, "bf16", "float32")


def test_prefill_with_lengths_matches_reference():
    """Right-padded rows: last-real-position logits, per-row pos."""
    jm, jp, m, p = _pair("bf16", "float32")
    toks = _tokens((3, 16), seed=3)
    lengths = np.array([16, 5, 11], np.int32)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, headroom=0,
                         lengths=jnp.asarray(lengths))
    with torch.inference_mode():
        tl, tst = m.prefill(p, {"tokens": torch.from_numpy(toks)}, headroom=0,
                            lengths=torch.from_numpy(lengths))
    _compare(jl, tl, "bf16", "float32")
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    # per-row positions then decode each slot at its own position
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl2, _ = jm.decode_step(jp, jst._replace(
        cache_k=jnp.pad(jst.cache_k, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        cache_v=jnp.pad(jst.cache_v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))),
        {"tokens": jnp.asarray(nxt)})
    grown = tst._replace(
        cache_k=torch.nn.functional.pad(tst.cache_k, (0, 0, 0, 0, 0, 4)),
        cache_v=torch.nn.functional.pad(tst.cache_v, (0, 0, 0, 0, 0, 4)))
    with torch.inference_mode():
        tl2, _ = m.decode_step(p, grown, {"tokens": torch.from_numpy(nxt)})
    _compare(jl2, tl2, "bf16", "float32")


def test_params_from_numpy_moves_leaves_bit_for_bit():
    jm, jp, m, p = _pair("bf16", "bfloat16")
    want = jax.tree.map(np.asarray, jp)
    got = p["blocks"]["ffn"]["w_up"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        want["blocks"]["ffn"]["w_up"].view(np.int16))
    bad = dict(want, ln_f=want["ln_f"][:-1])
    with pytest.raises(ValueError, match="ln_f"):
        params_from_numpy(bad, m.cfg, "cpu")


def test_materialize_is_seeded_and_scaled():
    cfg = get_arch("glm4-9b").reduced()
    m = build_model(cfg, "cpu")
    a, b, c = m.init(seed=3), m.init(seed=3), m.init(seed=4)
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["blocks"]["attn"]["wq"].shape == (2, 64, 64)
    assert a["ln_f"].dtype == torch.float32 and torch.all(a["ln_f"] == 1)
    assert torch.all(a["blocks"]["attn"]["bq"] == 0)
    std = a["blocks"]["ffn"]["w_down"].float().std().item()
    assert abs(std - 128 ** -0.5) < 0.01          # fan-in scaled normal
    assert abs(a["embed"].float().std().item() - 0.02) < 0.002
    tree = materialize({"w": m.params_spec()["lm_head"]}, 0, "cpu")
    assert tree["w"].shape == (64, 256)


def test_unported_modes_raise_naming_the_roadmap_item():
    """The families and cache formats not ported yet are refused by name:
    the moe, hybrid and audio families, and paged caches (item 13).  The
    int8 and fxp8 K/V caches of the dense family build, and read back
    their format.  (The W8A8/W8A16 matmuls, the CORDIC AFs and the CORDIC
    softmax run now, held to the reference in
    ``test_layers_under_cordic_policies_*`` and the ``cordic_exec`` model
    cases above; rwkv6 and its int8 recurrent state in
    ``test_torch_ssm.py``; the int8 and fxp8 K/V caches in
    ``test_torch_kv_cache.py``.)"""
    cfg = get_arch("glm4-9b").reduced()
    for arch in ("arctic-480b", "hymba-1.5b", "musicgen-medium"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_arch(arch).reduced(), "cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        build_model(cfg.scaled(cache=CacheSpec(paged=True)), "cpu")
    for dtype in ("int8", "fxp8"):
        spec = CacheSpec(dtype=dtype)
        assert build_model(cfg.scaled(cache=spec),
                           "cpu").cfg.cache_spec() == spec
    q = build_model(cfg, "cpu").with_cache_dtype("int8")
    assert q.cfg.cache_spec() == CacheSpec(dtype="int8")
    assert q.init_slot_state(2, 8).cache_k.dtype == torch.int8
    ssm = get_arch("rwkv6-3b").reduced()
    assert build_model(ssm.scaled(cache=CacheSpec(dtype="int8")),
                       "cpu").cfg.cache_spec().quantized
    with pytest.raises(NotImplementedError, match="item 13"):
        build_model(ssm.scaled(cache=CacheSpec(paged=True)), "cpu")
    with pytest.raises(ValueError, match="matmul"):
        L.dense(torch.zeros((2, 64)), torch.zeros((64, 8)),
                ExecutionPolicy(matmul="fxp4"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_under_cordic_policies_match_reference(dtype):
    """``dense`` under fxp8 / fxp8_weight, every AF under a CordicPolicy
    and the CORDIC softmax, layer by layer against ``repro.models.layers``
    on shared inputs: bit-equal, except W8A16's float matmul (1e-6 in
    float32; in bfloat16 1 ulp of the output)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 40)) / 8).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(v).astype(dtype) for v in (x, w, b))
    tx, tw, tb = (torch.from_numpy(v).to(getattr(torch, dtype))
                  for v in (x, w, b))
    for mode in ("fxp8", "fxp8_weight"):
        want = _f32(JL.dense(jx, jw, JPolicy(matmul=mode), jb))
        got = _f32(L.dense(tx, tw, ExecutionPolicy(matmul=mode), tb))
        if mode == "fxp8":
            np.testing.assert_array_equal(got, want)
        else:
            tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want)
            np.testing.assert_array_less(np.abs(got - want), tol + 1e-6)
    for bits in (8, 16):
        jpol = JPolicy(af=JCordicPolicy(bits=bits), softmax_cordic=True)
        pol = ExecutionPolicy(af=CordicPolicy(bits=bits), softmax_cordic=True)
        for name in ("silu", "gelu", "tanh", "sigmoid", "relu", "exp",
                     "selu", "swish", "identity"):
            got = L.af(tx, name, pol)
            assert got.dtype == tx.dtype
            np.testing.assert_array_equal(_f32(got),
                                          _f32(JL.af(jx, name, jpol)))
        np.testing.assert_array_equal(_f32(L.softmax(tx, pol)),
                                      _f32(JL.softmax(jx, jpol)))


def test_entry_points_default_to_cuda():
    cfg = get_arch("glm4-9b").reduced()
    assert build_model(cfg).device.type == "cuda"


def test_arch_registry_matches_reference_field_for_field():
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS
    assert list(ARCHS) == list(J_ARCHS)
    for name, jcfg in J_ARCHS.items():
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(ARCHS[name].reduced()) == \
            dataclasses.asdict(jcfg.reduced())
        assert get_arch(name).head_dim_ == jcfg.head_dim_
