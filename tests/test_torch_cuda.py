"""The port's CUDA kernels against their plain torch versions, on a card.

This file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips (the ``cuda`` fixture decides at
run time).  On the card each kernel must equal its plain version bit for
bit, and a CUDA tensor must never take the plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ExecutionPolicy, get_arch
from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import common
from repro_torch.kernels.cordic_mac import ops
from repro_torch.kernels.cordic_mac.ref import cordic_matmul_raw_ref
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
