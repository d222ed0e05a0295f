"""The port's continuous-batching engine against the JAX reference's.

Same converted parameters in both packages (reduced glm4-9b, float32 so
near-ties cannot split the two argmaxes), mixed prompt lengths and more
requests than slots, so slots retire and refill: equal greedy outputs per
request.  The same holds under the paper's ``CORDIC_EXEC`` policy, with
and without the CORDIC softmax.  The port's engine must also equal the
port's own single-stream prefill + decode under the float and
``cordic_kernel`` matmuls, and its per-bucket prefill counts are the torch
form of the reference's trace-count rule.  (Not under ``CORDIC_EXEC``: its
activation scale spans the whole batch, idle slots and pads included, so
a request's tokens depend on its batch-mates, in the reference too.)
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import CORDIC_EXEC as J_CORDIC_EXEC
from repro.models.model_zoo import build_model as j_build_model
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import (CORDIC_EXEC, CacheSpec, ExecutionPolicy,
                                 get_arch)
from repro_torch.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import (Request, ServeConfig, ServeEngine,
                                            next_pow2)

torch.set_num_threads(2)

MAX_SEQ = 64
LENS = [5, 11, 16, 3, 24, 8]
NEWS = [4, 9, 2, 12, 1, 6]


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_arch("glm4-9b").reduced().scaled(dtype="float32")
    cfg = get_arch("glm4-9b").reduced().scaled(dtype="float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jm, jp, cfg, tree


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENS]


def _single_stream(model, params, prompt, max_new):
    with torch.inference_mode():
        lg, st = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                               headroom=MAX_SEQ - len(prompt))
        cur = int(lg.reshape(-1).argmax())
        seq = [cur]
        for _ in range(max_new - 1):
            lg, st = model.decode_step(params, st,
                                       {"tokens": torch.tensor([[cur]])})
            cur = int(lg.reshape(-1).argmax())
            seq.append(cur)
    return seq


def test_engine_matches_reference_engine(pair):
    _check_engines(*pair, _prompts())


def _check_engines(jm, jp, cfg, tree, prompts):
    """Both engines over the same traffic: equal outputs per request, finish
    order, decode steps and prefill buckets."""
    jeng = JServeEngine(jm, jp, JServeConfig(max_batch=4, max_seq=MAX_SEQ))
    want = {r.rid: r.output.tolist() for r in jeng.serve(
        [JRequest(i, p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, NEWS))])}
    model = build_model(cfg, "cpu")
    eng = ServeEngine(model, params_from_numpy(tree, cfg, "cpu"),
                      ServeConfig(max_batch=4, max_seq=MAX_SEQ))
    done = eng.serve([Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, NEWS))])
    assert {r.rid: r.output.tolist() for r in done} == want
    assert [r.rid for r in done] == list(want)          # same finish order
    # one prefill program per bucket in the reference; the port runs its
    # prefills at those buckets only, every one at B = max_batch
    assert len(eng.prefill_counts) == jeng.trace_counts["prefill"]
    assert set(eng.prefill_counts) <= {16, 32}
    assert sum(eng.prefill_counts.values()) == len(
        {e[3] for e in eng.events if e[0] == "admit"})
    assert eng.metrics["decode_steps"] == jeng.metrics["decode_steps"]
    assert eng.metrics["prefill_tokens"] == sum(LENS)


@pytest.mark.parametrize("softmax_cordic", [False, True])
def test_engine_matches_reference_engine_under_cordic_exec(pair,
                                                           softmax_cordic):
    """W8A8 matmuls and DA-VINCI AFs (and the CORDIC softmax): the port's
    engine equals the reference's jitted engine request for request."""
    _, jp, cfg, tree = pair
    jcfg = dataclasses.replace(
        j_get_arch("glm4-9b").reduced().scaled(dtype="float32"),
        exec_policy=dataclasses.replace(J_CORDIC_EXEC,
                                        softmax_cordic=softmax_cordic))
    cfg = dataclasses.replace(cfg, exec_policy=dataclasses.replace(
        CORDIC_EXEC, softmax_cordic=softmax_cordic))
    _check_engines(j_build_model(jcfg), jp, cfg, tree, _prompts())


@pytest.mark.parametrize("matmul", ["bf16", "cordic_kernel"])
def test_engine_matches_single_stream(pair, matmul):
    _, _, cfg, tree = pair
    cfg = dataclasses.replace(cfg, exec_policy=ExecutionPolicy(matmul=matmul))
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    prompts = _prompts(seed=1)
    eng = ServeEngine(model, params, ServeConfig(max_batch=3, max_seq=MAX_SEQ))
    done = eng.serve([Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, NEWS))])
    assert len(done) == len(prompts)
    for r in done:
        assert r.status == "done" and len(r.output) == r.max_new_tokens
        assert r.output.tolist() == _single_stream(model, params, r.prompt,
                                                   r.max_new_tokens), r.rid
    # retire-and-refill: more requests than slots, slots reused
    admits = [e for e in eng.events if e[0] == "admit"]
    assert len({e[2] for e in admits}) <= 3 < len(admits)
    assert set(eng.prefill_counts) <= {16, 32}
    assert sum(eng.prefill_counts.values()) == len({e[3] for e in admits})
    assert 0 < eng.metrics["slot_occupancy"] <= 1


def test_bucketing():
    cfg = get_arch("glm4-9b").reduced()
    eng = ServeEngine(build_model(cfg, "cpu"), None,
                      ServeConfig(max_batch=2, max_seq=48, min_bucket=8))
    assert [eng._bucket(n) for n in (1, 8, 9, 17, 32)] == [8, 8, 16, 32, 32]
    assert next_pow2(33) == 64


def test_sampling_is_seeded_and_in_vocab(pair):
    _, _, cfg, tree = pair
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    prompts = _prompts(seed=2)[:3]

    def run():
        eng = ServeEngine(model, params, ServeConfig(
            max_batch=2, max_seq=MAX_SEQ, greedy=False))
        return {r.rid: r.output.tolist() for r in eng.serve(
            [Request(i, p, max_new_tokens=6, temperature=1.0, top_k=20,
                     seed=7) for i, p in enumerate(prompts)])}

    a, b = run(), run()
    assert a == b
    assert all(0 <= t < 256 for out in a.values() for t in out)


def test_refuses_unported_knobs_and_bad_requests():
    for knob in ({"spec_k": 2}, {"max_queue": 4}, {"snapshot_dir": "x"},
                 {"num_shards": 2}, {"prefix_cache": False}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeConfig(**knob)
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError, match="exactly one"):
        ServeConfig(cache_dtype="int8", cache=CacheSpec(dtype="int8"))
    cfg = get_arch("glm4-9b").reduced()
    # paged caches are refused, naming the ROADMAP item; both spellings
    # of the int8 K/V cache are taken
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 13"):
        ServeEngine(build_model(cfg, "cpu"), None,
                    ServeConfig(cache=CacheSpec(paged=True)))
    for knob in ({"cache_dtype": "int8"}, {"cache": CacheSpec(dtype="int8")}):
        eng = ServeEngine(build_model(cfg, "cpu"), None, ServeConfig(**knob))
        assert eng.model.cfg.cache_spec() == CacheSpec(dtype="int8")
    eng = ServeEngine(build_model(cfg, "cpu"), None,
                      ServeConfig(max_batch=2, max_seq=16))
    prompt = np.arange(8, dtype=np.int32)
    for bad in ([Request(0, prompt, max_new_tokens=9)],
                [Request(0, prompt), Request(0, prompt)],
                [Request(0, prompt[:0], max_new_tokens=1)],
                [Request(0, prompt + 250, max_new_tokens=1)]):
        with pytest.raises(ValueError):
            eng.serve(bad)


@pytest.mark.parametrize("policy", ["bf16", "cordic_kernel", "cordic_exec"])
def test_launcher_serves_on_the_cpu(capsys, policy):
    from repro_torch.launch.serve import main
    assert main(["--arch", "glm4-9b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--max-seq", "64",
                 "--policy", policy]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "on cpu" in out
