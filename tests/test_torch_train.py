"""The port's training path against the JAX reference, on the CPU.

Reduced glm4-9b and rwkv6-3b in float32 (2 layers, d_model 64), the
reference's parameters carried over with ``params_from_numpy`` (rwkv6's
zero- and one-initialised mixer leaves redrawn, so every path counts).
Bars:

* ``loss_fn``: within 2e-6 of the reference's loss (a few float32 ulps of
  ~6); each gradient leaf within 1e-5 of that leaf's largest magnitude
  (largest seen: 2.7e-6).  float32 sums run in another order, and the
  reference's compiled backward fuses multiply-adds, under the default
  policy (float32 matmuls), ``cordic_kernel`` and ``CORDIC_EXEC`` alike;
* ``adamw.update`` against ``jax.jit(adamw.update)`` (the reference's
  trainer compiles it): parameters and float32 moments within 1e-6
  (two float32 ulps at |x| <= 4); the global norm and the cosine of the
  schedule round in the last bit, so the int8 moments' scales agree
  within 1e-6 relative, and the int8 words are equal at these inputs;
* pruning masks, synthetic batches and checkpoint words: equal;
* ``Trainer``: per-step losses within 1e-5 of the reference's over 4
  steps, a checkpoint written by either trainer resumes in the other on
  the same track, and a ``fault_at`` restart equals the uninterrupted
  run, bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs import get_arch as j_get_arch
from repro.configs.base import CORDIC_EXEC as J_CORDIC_EXEC
from repro.configs.base import LM_SHAPES as J_SHAPES
from repro.configs.base import ExecutionPolicy as JPolicy
from repro.core import pruning as jpr
from repro.data import pipeline as jdata
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro.runtime import train_loop as jtl
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import (CORDIC_EXEC, LM_SHAPES, ExecutionPolicy,
                                 get_arch)
from repro_torch.convert import params_from_numpy
from repro_torch.core import pruning as pr
from repro_torch.data import pipeline as data
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as tl

torch.set_num_threads(2)

LOSS_TOL = 2e-6
GRAD_TOL = 1e-5
OPT_TOL = 1e-6
TRAIN_TOL = 1e-5
MODES = ["bf16", "cordic_kernel", "cordic_exec"]


def _policies(mode):
    if mode == "cordic_exec":
        return J_CORDIC_EXEC, CORDIC_EXEC
    return JPolicy(matmul=mode), ExecutionPolicy(matmul=mode)


def _tree(jm, arch, seed=1):
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if arch == "rwkv6-3b":
        rng = np.random.default_rng(seed)
        tm, cm = tree["blocks"]["tm"], tree["blocks"]["cm"]
        for d, key, lo, hi in ((tm, "mu", 0.0, 1.0), (tm, "w0", -1.0, 1.0),
                               (tm, "bonus", -0.5, 0.5),
                               (tm, "ln_w", 0.5, 1.5), (cm, "mu_k", 0.0, 1.0),
                               (cm, "mu_r", 0.0, 1.0)):
            d[key] = rng.uniform(lo, hi, d[key].shape).astype(d[key].dtype)
    return tree


def _pair(arch, mode="bf16"):
    """(reference model, numpy params, port model)."""
    jpol, pol = _policies(mode)
    jcfg = dataclasses.replace(j_get_arch(arch).reduced().scaled(
        dtype="float32"), exec_policy=jpol)
    cfg = dataclasses.replace(get_arch(arch).reduced().scaled(
        dtype="float32"), exec_policy=pol)
    jm = j_build_model(jcfg)
    return jm, _tree(jm, arch), build_model(cfg, "cpu")


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batch(b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return {"tokens": toks[:, :s].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b"])
def test_loss_and_gradients_match_reference(arch, mode):
    jm, tree, m = _pair(arch, mode)
    batch = _batch()
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jm.cfg), has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, m.cfg, "cpu")
    leaves = [p.requires_grad_(True) for _, p in _leaves_with_paths(params)]
    loss, aux = m.loss(params, {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(j_loss)) <= LOSS_TOL
    assert abs(float(aux["ce"].detach()) - float(j_aux["ce"])) <= LOSS_TOL
    for (path, _), g in zip(_leaves_with_paths(params), grads):
        want = np.asarray(_get(j_grads, path))
        bar = GRAD_TOL * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=bar,
                                   err_msg="/".join(path))


def test_cross_entropy_with_mask():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (2, 5)).astype(np.float32)
    from repro.models import layers as JL
    for mk in (None, mask):
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mk is None else jnp.asarray(mk))
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mk is None else torch.from_numpy(mk))
        assert abs(float(got) - float(want)) <= LOSS_TOL


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the gradients do not change."""
    _, tree, m = _pair("rwkv6-3b", "cordic_exec")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(m.cfg, remat=remat)
        params = params_from_numpy(tree, cfg, "cpu")
        leaves = [p.requires_grad_(True)
                  for _, p in _leaves_with_paths(params)]
        loss, _ = T.loss_fn(params, batch, cfg)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (3, 16, 24), "b": (24,)}, "e": (40, 16)}

    def mk(scale):
        def build(v):
            if isinstance(v, dict):
                return {k: build(x) for k, x in v.items()}
            return (rng.normal(size=v) * scale).astype(np.float32)
        return build(shapes)
    return mk(1.0), [mk(3.0) for _ in range(5)]


def _jmasks(tree, as_torch):
    def build(v):
        if isinstance(v, dict):
            return {k: build(x) for k, x in v.items()}
        if v.ndim < 2:
            return None
        m = np.abs(v) > 0.5
        return torch.from_numpy(m) if as_torch else jnp.asarray(m)
    return build(tree)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_update_matches_jitted_reference(moment_dtype, masked):
    params, grads = _opt_trees()
    kw = dict(moment_dtype=moment_dtype, warmup_steps=2, total_steps=10,
              lr=1e-2)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    jst, st = jadamw.init(jcfg, jp), adamw.init(cfg, tp)
    jm = _jmasks(params, False) if masked else None
    tm = _jmasks(params, True) if masked else None
    jupd = jax.jit(functools.partial(jadamw.update, jcfg))
    for g in grads:
        jp, jst, jmet = jupd(jax.tree.map(jnp.asarray, g), jst, jp, jm)
        tp, st, met = adamw.update(cfg, jax.tree.map(torch.from_numpy, g),
                                   st, tp, tm)
    assert int(st.step) == int(jst.step) == 5
    assert abs(float(met["lr"]) - float(jmet["lr"])) <= OPT_TOL * 1e-2
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=OPT_TOL)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=OPT_TOL)
    if masked:
        for (path, mk) in _leaves_with_paths(tm):
            if mk is not None:
                assert torch.all(_get(tp, path)[~mk] == 0)
    is_q = lambda x: isinstance(x, adamw.QMoment)  # noqa: E731
    for jt, tt in ((jst.m, st.m), (jst.v, st.v)):
        for a, b in zip(jax.tree.leaves(jt),
                        [x for q in jax.tree.leaves(tt, is_leaf=is_q)
                         for x in (q if is_q(q) else (q,))]):
            a, b = np.asarray(a), b.numpy()
            if a.dtype == np.int8:
                np.testing.assert_array_equal(b, a)
            elif moment_dtype == "int8":
                np.testing.assert_allclose(b, a, rtol=OPT_TOL, atol=0)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=OPT_TOL)


def test_adamw_blockwise_update_equals_whole():
    """Leaves of >= BLOCK_SCAN_MIN elements update one leading slice at a
    time; the result is the whole-tensor update's, bit for bit."""
    params, grads = _opt_trees(1)
    outs = []
    for block_min in (adamw.BLOCK_SCAN_MIN, 16):
        adamw.BLOCK_SCAN_MIN, saved = block_min, adamw.BLOCK_SCAN_MIN
        try:
            for md in ("float32", "int8"):
                cfg = adamw.AdamWConfig(moment_dtype=md)
                tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                  params)
                st = adamw.init(cfg, tp)
                for g in grads[:2]:
                    tp, st, _ = adamw.update(
                        cfg, jax.tree.map(torch.from_numpy, g), st, tp)
                outs.append((md, tp))
        finally:
            adamw.BLOCK_SCAN_MIN = saved
    for (_, a), (_, b) in zip(outs[:2], outs[2:]):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("policy", [pr.PruningPolicy(0.4),
                                    pr.PruningPolicy(n=4, m=9)])
def test_prune_tree_masks_equal(policy):
    jm, tree, m = _pair("glm4-9b")
    jpol = jpr.PruningPolicy(policy.rate, policy.n, policy.m)
    j_pruned, j_masks = jpr.prune_tree(jax.tree.map(jnp.asarray, tree), jpol)
    params = params_from_numpy(tree, m.cfg, "cpu")
    pruned, masks = pr.prune_tree(params, policy)
    n_masks = 0
    for path, mk in _leaves_with_paths(masks):
        want = _get(j_masks, path)
        if want is None:
            assert mk is None, path
            continue
        n_masks += 1
        np.testing.assert_array_equal(mk.numpy(), np.asarray(want))
        np.testing.assert_array_equal(_get(pruned, path).numpy(),
                                      np.asarray(_get(j_pruned, path)))
    assert n_masks > 5
    stats = pr.sparsity_stats(pruned, masks)
    want = jpr.sparsity_stats(j_pruned, j_masks)
    assert stats == want


@pytest.mark.parametrize("kind,codebooks", [("tokens", 0), ("tokens", 2),
                                            ("frames", 0)])
def test_synthetic_stream_batches_equal(kind, codebooks):
    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=3,
              kind=kind, d_model=8, n_codebooks=codebooks)
    for shard in (0, 1):
        js = jdata.SyntheticStream(jdata.DataConfig(**kw), shard, 2)
        ts = data.SyntheticStream(data.DataConfig(**kw), shard, 2)
        for step in (0, 5):
            a, b = js.batch_at(step), ts.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    pf = data.Prefetcher(ts, depth=2, start_step=5)
    try:
        step, batch = pf.next()
        assert step == 5
        np.testing.assert_array_equal(batch["labels"],
                                      ts.batch_at(5)["labels"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    for name in J_SHAPES:
        assert dataclasses.asdict(LM_SHAPES[name]) == dataclasses.asdict(
            J_SHAPES[name])


def _ckpt_state_pair(moment_dtype):
    """The same state as the reference's tree and the port's, bf16 and
    float32 parameters and the optimizer's moments."""
    rng = np.random.default_rng(0)
    p32 = rng.normal(size=(5, 7)).astype(np.float32)
    pbf = rng.normal(size=(3, 4)).astype(jnp.bfloat16)
    jparams = {"w": jnp.asarray(p32), "emb": jnp.asarray(pbf)}
    jcfg = jadamw.AdamWConfig(moment_dtype=moment_dtype)
    jst = jadamw.init(jcfg, jparams)
    g = {"w": jnp.asarray(rng.normal(size=(5, 7)).astype(np.float32)),
         "emb": jnp.asarray(rng.normal(size=(3, 4)).astype(jnp.bfloat16))}
    jparams, jst, _ = jadamw.update(jcfg, g, jst, jparams)
    jstate = {"params": jparams, "opt": jst, "resid": jnp.zeros(())}
    tparams = {"w": torch.zeros((5, 7)),
               "emb": torch.zeros((3, 4), dtype=torch.bfloat16)}
    tstate = {"params": tparams,
              "opt": adamw.init(adamw.AdamWConfig(moment_dtype=moment_dtype),
                                tparams),
              "resid": torch.zeros(())}
    return jstate, tstate


def _words(x):
    x = x.view(torch.int16) if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else x
    if isinstance(x, torch.Tensor):
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_checkpoint_cross_restore(tmp_path, moment_dtype):
    """A checkpoint written by the reference's manager restores in the
    port's, and the port's in the reference's, word for word."""
    jstate, tstate = _ckpt_state_pair(moment_dtype)
    JCkpt(str(tmp_path / "j"), async_save=False).save(3, jstate)
    got = CheckpointManager(str(tmp_path / "j")).restore(tstate)
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert isinstance(got["opt"], adamw.AdamWState)
    pairs = list(zip(jax.tree.leaves(jstate),
                     jax.tree.leaves(got, is_leaf=lambda x: isinstance(
                         x, torch.Tensor))))
    assert len(pairs) == len(jax.tree.leaves(jstate))
    for a, b in pairs:
        np.testing.assert_array_equal(_words(b), _words(a))
    mgr = CheckpointManager(str(tmp_path / "t"), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, got)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    back = JCkpt(str(tmp_path / "t")).restore(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_words(a), _words(b))


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_async_save_snapshots_cpu_state(tmp_path, monkeypatch, moment_dtype):
    """An async save of CPU tensors writes the state of its step, though
    the next AdamW step updates the same tensors in place before the
    background write runs (the write is held until that step is done)."""
    import threading
    rng = np.random.default_rng(5)
    cfg = adamw.AdamWConfig(warmup_steps=1, moment_dtype=moment_dtype)
    params = {"w": torch.from_numpy(rng.normal(size=(5, 7)).astype(
        np.float32)), "emb": torch.from_numpy(rng.normal(size=(3, 4)).astype(
            np.float32)).to(torch.bfloat16)}
    grads = [{k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
        np.float32)).to(v.dtype) for k, v in params.items()}
        for _ in range(2)]
    opt = adamw.init(cfg, params)
    params, opt, _ = adamw.update(cfg, grads[0], opt, params)
    state = {"params": params, "opt": opt, "resid": torch.zeros(())}
    flat = functools.partial(jax.tree.leaves, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    want = [x.clone() for x in flat(state)]
    gate, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert gate.wait(30)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state)
    adamw.update(cfg, grads[1], opt, params)        # step 2, in place
    assert not all(torch.equal(a, b) for a, b in zip(flat(state), want))
    gate.set()
    mgr.wait()
    got = flat(mgr.restore(state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _trainers(arch, mode, tmp, masks=False, moment_dtype="float32"):
    """A reference Trainer and a port Trainer over the same stream, both
    starting from the reference's parameters."""
    jm, tree, m = _pair(arch, mode)
    shape = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4,
               moment_dtype=moment_dtype)
    jcfg = jtl.TrainConfig(optimizer=jadamw.AdamWConfig(**okw), log_every=1,
                           ckpt_every=1, ckpt_dir=f"{tmp}/j")
    tcfg = tl.TrainConfig(optimizer=adamw.AdamWConfig(**okw), log_every=1,
                          ckpt_every=1, ckpt_dir=f"{tmp}/t")
    jmasks = tmasks = None
    if masks:
        _, jmasks = jpr.prune_tree(jax.tree.map(jnp.asarray, tree),
                                   jpr.PruningPolicy(0.4))
        _, tmasks = pr.prune_tree(params_from_numpy(tree, m.cfg, "cpu"),
                                  pr.PruningPolicy(0.4))
    jt = jtl.Trainer(jm, jcfg, jdata.stream_for_model(jm, shape), masks=jmasks)
    tt = tl.Trainer(m, tcfg, data.stream_for_model(m, shape), masks=tmasks)

    def j_init(seed=0):
        p = jax.tree.map(jnp.asarray, tree)
        if masks:
            p = jax.tree.map(lambda w, k: w if k is None else w * k, p,
                             jmasks, is_leaf=lambda x: x is None)
        return p, jadamw.init(jcfg.optimizer, p), jnp.zeros(())

    def t_init(seed=0):
        p = params_from_numpy(tree, m.cfg, "cpu")
        if masks:
            p = pr.prune_tree(p, pr.PruningPolicy(0.4))[0]
        return p, adamw.init(tcfg.optimizer, p), torch.zeros(())

    jt.init_state, tt.init_state = j_init, t_init
    return jt, tt, (jm, m, jcfg, tcfg, j_init, t_init, shape, jmasks, tmasks)


@pytest.mark.parametrize("arch,mode,masks,moments", [
    ("glm4-9b", "bf16", True, "int8"),
    ("rwkv6-3b", "cordic_exec", False, "float32")])
def test_trainer_tracks_reference_and_resumes_across(tmp_path, arch, mode,
                                                     masks, moments):
    jt, tt, (jm, m, jcfg, tcfg, j_init, t_init, shape, jmasks, tmasks) = \
        _trainers(arch, mode, tmp_path, masks, moments)
    j_losses = dict(jt.run(4)["losses"])
    out = tt.run(4)
    t_losses = dict(out["losses"])
    assert sorted(t_losses) == [0, 1, 2, 3]
    for s in t_losses:
        assert abs(t_losses[s] - j_losses[s]) <= TRAIN_TOL, (s, t_losses,
                                                             j_losses)
    if masks:
        for path, mk in _leaves_with_paths(tmasks):
            if mk is not None:
                assert torch.all(_get(out["params"], path)[~mk] == 0)
    # the reference's checkpoint of step 1 resumes in the port, and the
    # port's in the reference
    for name, src, dst_cls, dst_cfg, dst_model, init, mk, want in (
            ("t2", "j", tl.Trainer, tcfg, m, t_init, tmasks, j_losses),
            ("j2", "t", jtl.Trainer, jcfg, jm, j_init, jmasks, t_losses)):
        import shutil
        shutil.rmtree(tmp_path / src)
        first = (jtl.Trainer(jm, jcfg, jdata.stream_for_model(jm, shape),
                             masks=jmasks) if src == "j" else
                 tl.Trainer(m, tcfg, data.stream_for_model(m, shape),
                            masks=tmasks))
        first.init_state = j_init if src == "j" else t_init
        with pytest.raises(RuntimeError, match="injected fault"):
            first.run(4, fault_at=1)
        cfg2 = dataclasses.replace(dst_cfg, ckpt_dir=str(tmp_path / src))
        stream = (data.stream_for_model(m, shape) if dst_cls is tl.Trainer
                  else jdata.stream_for_model(jm, shape))
        second = dst_cls(dst_model, cfg2, stream, masks=mk)
        second.init_state = init
        resumed = dict(second.run(4)["losses"])
        assert sorted(resumed) == [2, 3]
        for s in resumed:
            assert abs(resumed[s] - want[s]) <= TRAIN_TOL, (name, s)


def test_fault_at_resume_equals_uninterrupted_run(tmp_path):
    _, tt, (_, m, _, tcfg, _, t_init, shape, _, _) = _trainers(
        "glm4-9b", "cordic_exec", tmp_path)
    whole = dict(tt.run(4)["losses"])
    cfg = dataclasses.replace(tcfg, ckpt_dir=str(tmp_path / "f"))
    first = tl.Trainer(m, cfg, data.stream_for_model(m, shape))
    first.init_state = t_init
    with pytest.raises(RuntimeError, match="injected fault at step 2"):
        first.run(4, fault_at=2)
    second = tl.Trainer(m, cfg, data.stream_for_model(m, shape))
    second.init_state = t_init
    resumed = dict(second.run(4)["losses"])
    assert resumed == {3: whole[3]}


def test_train_config_refuses_grad_compression():
    with pytest.raises(NotImplementedError, match="item 15"):
        tl.TrainConfig(grad_compression=True)


def test_launcher_runs_reduced_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    assert train.main(["--arch", "rwkv6-3b", "--reduced", "--cordic",
                       "--batch", "2", "--seq", "8", "--steps", "2",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "1", "--fault-at", "0"]) == 0
    out = capsys.readouterr().out
    assert "injected fault at step 0" in out and "step     1" in out


def test_grad_accum_step_matches_reference():
    """One step with two micro-batches against the reference's jitted
    step: the loss within LOSS_TOL, and the first moment (the clipped
    gradient summed over the micro-batches, times 1 - beta1) within
    GRAD_TOL of each leaf's largest magnitude.  (The new parameters are
    not compared entry by entry: Adam's first step is g / (|g| + eps),
    which turns a last-bit difference of a gradient entry of a few eps
    into a fraction of lr.)"""
    jm, tree, m = _pair("glm4-9b")
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jstep = jax.jit(jtl.make_train_step(
        jm, jtl.TrainConfig(optimizer=jadamw.AdamWConfig(**okw),
                            grad_accum=2)))
    step = tl.make_train_step(m, tl.TrainConfig(
        optimizer=adamw.AdamWConfig(**okw), grad_accum=2))
    batch = _batch(b=4, seed=3)
    jp = jax.tree.map(jnp.asarray, tree)
    _, jst, _, jmet = jstep(jp, jadamw.init(jadamw.AdamWConfig(**okw),
                                            jp), jnp.zeros(()),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.tree.map(lambda _: None, jp))
    tp = params_from_numpy(tree, m.cfg, "cpu")
    _, st, _, met = step(tp, adamw.init(adamw.AdamWConfig(**okw), tp),
                          torch.zeros(()),
                          {k: torch.from_numpy(v).long()
                           for k, v in batch.items()}, None)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    for path, leaf in _leaves_with_paths(st.m):
        want = np.asarray(_get(jst.m, path))
        np.testing.assert_allclose(leaf.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg="/".join(path))
