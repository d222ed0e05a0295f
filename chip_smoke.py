#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device    — a CUDA card must be present; prints nvidia-smi's name and
               power limit.
2. build     — builds every kernel of the serving path from the sources in
               this checkout (nvcc, sm_90a), printing build time and ptxas'
               register report.
3. kernel    — holds ``cordic_mac`` bit-exact against its plain torch
               version on the card (FXP8/16/32, E_i = 0 stages, odd shapes,
               int32 wrap, and every shape the serving path gives it), and
               times kernel, plain version and bound at the serving shapes.
4. reference — a reduced glm4-9b on the card (kernel) against the same
               model on the CPU (plain version): logits within a stated
               tolerance, equal greedy tokens.
5. serve     — full-width glm4-9b (40 layers, d_model 4096, vocab 151552,
               bf16, random weights from seed 0) under
               ``ExecutionPolicy(matmul="cordic_kernel")`` through the port's
               ``ServeEngine``: 4 requests, 8 new tokens each.  Asserts 281
               kernel launches per forward call and no plain-version call,
               and that one request's greedy output equals the port's own
               single-stream prefill + decode; profiles one decode step; then
               holds the engine to single-stream decode on the reduced model
               too, whose greedy tokens vary.

The last three lines are nvidia-smi's name and power limit, one JSON
object with a record per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ExecutionPolicy, get_arch  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.cordic_mac import kernel as mac_kernel  # noqa: E402
from repro_torch.kernels.cordic_mac.ref import cordic_matmul_raw_ref  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.spec import to_device  # noqa: E402
from repro_torch.runtime.serve_loop import (Request, ServeConfig,  # noqa: E402
                                            ServeEngine)

# H100 SXM peaks (NVIDIA data sheet, 700 W).  The int32 multiply-add rate
# is not in the data sheet's table: an SM issues 64 int32 lanes per clock
# (half its 128 float32 lanes), so it is a quarter of the 67 TFLOP/s
# float32 rate, which counts a fused multiply-add as two operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
L2_BYTES = 50 * 2 ** 20

# (K, N) of every projection of glm4-9b and its launches per forward call:
# wq, wo (4096x4096), wk, wv (4096x256), w_gate, w_up (4096x13696), w_down
# (13696x4096) in each of 40 layers, and lm_head (4096x151552) once.
SERVE_SHAPES = {(4096, 4096): 80, (4096, 256): 80, (4096, 13696): 80,
                (13696, 4096): 40, (4096, 151552): 1}
LAUNCHES_PER_FORWARD = sum(SERVE_SHAPES.values())          # 281
SERVE_M = (4, 64)      # decode rows (max_batch) and prefill rows (4 x 16)
N_STAGES = 5
FMT = fxp.FXP16
FULL_WIDTH = (40, 4096, 151552, "bfloat16")  # layers, d_model, vocab, dtype

# Tolerance of the float reference: the reduced model with float32
# matmuls on the card against the CPU; sums in another order.
FLOAT_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(m: int, k: int, n: int) -> tuple:
    """Least time for one raw product: int32 x, w read once and out
    written once, against M*N*K*n_stages int32 multiply-adds."""
    t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    t_ops = m * n * k * N_STAGES / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, args_list, reps: int) -> float:
    """Mean ms per call with CUDA events, cycling through ``args_list``
    (distinct copies, so weights come from HBM and not from L2)."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(*args_list[r % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, args_list, reps: int, kernel_name: str):
    """Mean device time per call of the kernels named ``kernel_name``, from
    torch.profiler's CUPTI trace; None where the trace has no device time."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for r in range(reps):
            fn(*args_list[r % len(args_list)])
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages() if kernel_name in e.key)
    return total_us / 1e3 / reps if total_us > 0 else None


def raw_words(gen, shape, fmt, dev, zero_frac=0.0) -> torch.Tensor:
    """Uniform raw words over the format's whole range, some set to 0."""
    w = torch.randint(fmt.raw_min, fmt.raw_max + 1, shape, generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    if zero_frac:
        w[torch.rand(shape, generator=gen, device=dev) < zero_frac] = 0
    return w


def check_exact(x, w, fmt, n_stages, what, errs: list) -> None:
    got = mac_kernel.cordic_matmul_raw_cuda(x, w, fmt=fmt, n_stages=n_stages)
    want = cordic_matmul_raw_ref(x, w, fmt=fmt, n_stages=n_stages)
    torch.cuda.synchronize()
    errs.append(int((got.long() - want.long()).abs().max()))
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"cordic_mac {what}: {bad} of {got.numel()} "
                             f"words differ from the plain version")
    log(f"  bit-exact: {what}")


def phase_kernel(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs: list = []
    log("[kernel] bit-exactness against the plain version")
    for fmt_name, fmt in (("FXP8", fxp.FXP8), ("FXP16", fxp.FXP16),
                          ("FXP32", fxp.FXP32)):
        for m in (4, 64):          # both kernel tilings: M <= 4 and M > 4
            x = raw_words(gen, (m, 300), fmt, dev)
            w = raw_words(gen, (300, 517), fmt, dev, zero_frac=0.2)
            check_exact(x, w, fmt, 5, f"{fmt_name} n_stages=5 M={m} K=300 "
                                      f"N=517, 20% zero weights", errs)
    for m in (3, 70):
        x = raw_words(gen, (m, 129), fxp.FXP8, dev)
        w = raw_words(gen, (129, 257), fxp.FXP8, dev, zero_frac=0.2)
        check_exact(x, w, fxp.FXP8, 7, f"FXP8 n_stages=7 (E_5 = E_6 = 0) "
                                       f"M={m}", errs)
    for m in (3, 7):
        check_exact(raw_words(gen, (m, 13), fxp.FXP16, dev),
                    raw_words(gen, (13, 5), fxp.FXP16, dev), fxp.FXP16, 5,
                    f"odd shape {m}x13x5", errs)
    x = raw_words(gen, (64, 8192), fxp.FXP32, dev)
    w = raw_words(gen, (8192, 384), fxp.FXP32, dev)
    stage0 = (x.double() @ torch.where(w >= 0, 1.0, -1.0).double())
    if stage0.abs().max().item() < 2 ** 31:
        raise AssertionError("the int32-wrap case does not overflow")
    check_exact(x, w, fxp.FXP32, 5, "FXP32 K=8192, sums beyond int32 wrap",
                errs)
    del x, w

    log("[kernel] serving shapes: bit-exactness and times (ms per call)")
    rows = []
    for (k, n), count in SERVE_SHAPES.items():
        # weights as the serving path makes them: fan-in scaled normal,
        # quantized to FXP16; activations of unit scale
        w = fxp.quantize(torch.randn((k, n), generator=gen, device=dev)
                         / math.sqrt(k), FMT)
        copies = [w] + [w.clone() for _ in range(
            min(15, math.ceil(2 * L2_BYTES / w.nbytes) - 1))]
        for m in SERVE_M:
            x = fxp.quantize(torch.randn((m, k), generator=gen, device=dev),
                             FMT)
            check_exact(x, w, FMT, N_STAGES, f"M={m} K={k} N={n}", errs)
            launch = (lambda a, b: mac_kernel.cordic_matmul_raw_cuda(
                a, b, fmt=FMT, n_stages=N_STAGES))
            kern = time_ms(launch, [(x, c) for c in copies], reps=10)
            dev_only = device_ms(launch, [(x, c) for c in copies], reps=10,
                                 kernel_name="cordic_mac_kernel")
            plain = time_ms(lambda a, b: cordic_matmul_raw_ref(
                a, b, fmt=FMT, n_stages=N_STAGES), [(x, w)], reps=2)
            wb = w.to(torch.bfloat16)
            xb = x.to(torch.bfloat16)
            ctx = time_ms(torch.matmul, [(xb, wb)], reps=10)
            bnd, by = bound_ms(m, k, n)
            rows.append(dict(m=m, k=k, n=n, count=count, ms=kern,
                             plain_ms=plain, bound_ms=bnd, bound_by=by))
            dev_txt = "not measured" if dev_only is None else f"{dev_only:.4f}"
            log(f"  M={m:3d} K={k:6d} N={n:6d}  kernel {kern:9.4f} (device "
                f"only {dev_txt})  plain {plain:9.4f}  bound {bnd:8.4f} "
                f"({by})  kernel/bound {kern / bnd:6.2f}  [context only: "
                f"bf16 torch.matmul {ctx:.4f}]")
            del wb, xb
        del w, copies
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": max(errs)}


def phase_reference(dev) -> None:
    """Reduced glm4-9b (float32) on the card against two references.

    1. ``matmul="bf16"`` (float32 matmuls), card vs CPU: within FLOAT_TOL.
    2. ``matmul="cordic_kernel"``, kernel vs plain version on the card: the
       same float ops on the same device, so the logits must be equal bit
       for bit.  (Card vs CPU cannot be held to a tolerance here: a 1-ulp
       float difference flips an FXP16 rounding, and the flip grows through
       the layers; ROADMAP queue 3.)
    """
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 12)))
    base = get_arch("glm4-9b").reduced().scaled(dtype="float32")
    params = build_model(base, "cpu").init(seed=0)
    logits = {}
    for matmul in ("bf16", "cordic_kernel"):
        cfg = dataclasses.replace(base,
                                  exec_policy=ExecutionPolicy(matmul=matmul))
        with torch.inference_mode():
            logits[matmul, "cpu"] = build_model(cfg, "cpu").forward(
                params, {"tokens": tokens})
            logits[matmul, "card"] = build_model(cfg, dev).forward(
                to_device(params, dev), {"tokens": tokens.to(dev)}).cpu()
    err = (logits["bf16", "card"] - logits["bf16", "cpu"]).abs().max().item()
    log(f"[reference] reduced glm4-9b, float32 matmuls: card vs CPU max abs "
        f"err {err:.3e} (tolerance {FLOAT_TOL})")
    if not err <= FLOAT_TOL:
        raise AssertionError("float model on the card disagrees with the CPU")

    spec = common.get_kernel("cordic_mac")
    kernel = spec.kernel
    spec.kernel = spec.plain            # CUDA tensors take the plain version
    try:
        with torch.inference_mode():
            plain = build_model(dataclasses.replace(
                base, exec_policy=ExecutionPolicy(matmul="cordic_kernel")),
                dev).forward(to_device(params, dev),
                             {"tokens": tokens.to(dev)}).cpu()
    finally:
        spec.kernel = kernel
    got = logits["cordic_kernel", "card"]
    cross = (got - logits["cordic_kernel", "cpu"]).abs().max().item()
    log(f"[reference] reduced glm4-9b, cordic_kernel: kernel vs plain version "
        f"on the card equal: {torch.equal(got, plain)}; (card vs CPU max abs "
        f"err {cross:.3e}, recorded only)")
    if not (torch.isfinite(got).all() and got.shape == (2, 12, 256)
            and torch.equal(got, plain)):
        raise AssertionError("cordic model: kernel and plain version disagree")


def single_stream(model, params, prompt, max_new, max_seq) -> list:
    """Greedy decode of one request, unbatched and unpadded."""
    dev = model.device
    with torch.inference_mode():
        lg, st = model.prefill(
            params, {"tokens": torch.from_numpy(prompt[None]).long().to(dev)},
            headroom=max_seq - len(prompt))
        if not torch.isfinite(lg).all():
            raise AssertionError("single-stream prefill logits not finite")
        cur = int(lg.reshape(-1).argmax())
        seq = [cur]
        for _ in range(max_new - 1):
            lg, st = model.decode_step(
                params, st, {"tokens": torch.tensor([[cur]], device=dev)})
            cur = int(lg.reshape(-1).argmax())
            seq.append(cur)
    return seq


def profile_step(model, params, engine) -> None:
    """Where one decode step's device time goes (torch.profiler), and the
    device's idle share of that step's wall time."""
    tokens = torch.zeros((engine.max_batch, 1), dtype=torch.long,
                         device=model.device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        state = model.init_slot_state(engine.max_batch, engine.max_seq)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            model.decode_step(params, state, {"tokens": tokens})
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    # device-side entries only: a CPU op's device time repeats its kernels'
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in kernels)
    if not busy:
        log("[profile] the trace holds no device time: not measured")
        return
    log(f"[profile] one decode step (M=4): wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for key, t, n in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"  {t:8.2f} ms {t / busy:6.1%} x{n:4d}  {key[:90]}")


def phase_serve(dev, smi: str) -> dict:
    cfg = dataclasses.replace(get_arch("glm4-9b"),
                              exec_policy=ExecutionPolicy(
                                  matmul="cordic_kernel"))
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) != FULL_WIDTH:
        raise AssertionError(f"glm4-9b is not at full width: {cfg}")
    t0 = time.monotonic()
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    log(f"[serve] glm4-9b full width: {model.n_params() / 1e9:.3f} B params "
        f"initialised on the card in {time.monotonic() - t0:.1f} s")
    max_seq, max_new = 64, 8
    engine = ServeEngine(model, params, ServeConfig(max_batch=4,
                                                    max_seq=max_seq))
    rng = np.random.default_rng(0)
    warm = [Request(100, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=2)]
    engine.serve(warm)          # first-touch costs (cuBLAS handles etc.)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n)).astype(
        np.int32), max_new_tokens=max_new)
        for i, n in enumerate(rng.integers(8, 17, 4))]
    spec = common.get_kernel("cordic_mac")
    base = {k: engine.metrics[k] for k in ("prefill_s", "decode_s",
                                           "decode_steps", "decode_tokens")}
    prefills_before = sum(engine.prefill_counts.values())
    torch.cuda.reset_peak_memory_stats(dev)
    common.reset_counts()
    done = engine.serve(reqs)
    torch.cuda.synchronize()
    launches, plain = spec.launches, spec.plain_calls
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prefills = sum(engine.prefill_counts.values()) - prefills_before
    steps = engine.metrics["decode_steps"] - base["decode_steps"]
    forwards = prefills + steps
    log(f"[serve] {len(done)} requests, {prefills} prefill(s), {steps} decode "
        f"steps: cordic_mac launches {launches} (= {launches / forwards:.1f} "
        f"per forward call), plain-version calls {plain}")
    if len(done) != len(reqs):
        raise AssertionError("not every request was served")
    for r in done:
        if len(r.output) != max_new or not np.all(
                (r.output >= 0) & (r.output < cfg.vocab_size)):
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    if launches != LAUNCHES_PER_FORWARD * forwards or plain != 0:
        raise AssertionError(f"expected {LAUNCHES_PER_FORWARD} launches per "
                             f"forward call and no plain call")
    prefill_s = engine.metrics["prefill_s"] - base["prefill_s"]
    decode_s = engine.metrics["decode_s"] - base["decode_s"]
    decode_tok = engine.metrics["decode_tokens"] - base["decode_tokens"]
    log(f"[serve] prefill (4 x 16 tokens, M=64) {prefill_s * 1e3:.1f} ms; "
        f"decode {decode_s / steps * 1e3:.1f} ms/step, "
        f"{decode_tok / decode_s:.2f} tok/s; peak allocated {peak_gb:.2f} GB "
        f"[{smi}]")
    profile_step(model, params, engine)
    r0 = min(done, key=lambda r: r.rid)
    ref = single_stream(model, params, r0.prompt, max_new, max_seq)
    log(f"[serve] request {r0.rid}: engine {r0.output.tolist()} single-stream "
        f"{ref}")
    if r0.output.tolist() != ref:
        raise AssertionError("engine output differs from single-stream decode")
    del engine, params
    torch.cuda.empty_cache()
    # With random fan-in-scaled weights every |w| < 1/16 runs through the
    # 5-stage FXP16 recurrence as +-1/16, activations grow and saturate,
    # and the full-width greedy output is one token repeated.  So the
    # engine is also held to single-stream decode on the reduced model,
    # whose tokens vary: 6 requests of mixed length through 4 slots.
    small = dataclasses.replace(get_arch("glm4-9b").reduced(),
                                exec_policy=ExecutionPolicy(
                                    matmul="cordic_kernel"))
    model = build_model(small, dev)
    params = model.init(seed=0)
    engine = ServeEngine(model, params, ServeConfig(max_batch=4,
                                                    max_seq=max_seq))
    reqs = [Request(i, rng.integers(0, small.vocab_size, n).astype(np.int32),
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip((5, 11, 16, 3, 24, 8),
                                           (4, 9, 2, 12, 1, 6)))]
    done = engine.serve(reqs)
    bad = [r.rid for r in done if r.output.tolist() != single_stream(
        model, params, r.prompt, r.max_new_tokens, max_seq)]
    log(f"[serve] reduced glm4-9b (bf16, cordic_kernel): {len(done)} requests "
        f"through 4 slots, {len({t for r in done for t in r.output})} distinct "
        f"tokens, equal to single-stream decode: {not bad}")
    if bad or len(done) != len(reqs):
        raise AssertionError(f"engine differs from single-stream for {bad}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script measures the port on a card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    built = mac_kernel.library()
    log(f"[build] cordic_mac: {built.path.name} in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    t_kernel = phase_kernel(dev)
    phase_reference(dev)
    served = phase_serve(dev, smi)

    # the record's work: one decode forward call, the 281 launches at
    # M = max_batch = 4; its bound is the larger of all their bytes over
    # the memory rate and all their operations over the int32 rate
    decode = [r for r in t_kernel["rows"] if r["m"] == SERVE_M[0]]
    m = SERVE_M[0]
    t_bytes = sum(4 * (m * r["k"] + r["k"] * r["n"] + m * r["n"]) * r["count"]
                  for r in decode) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(m * r["k"] * r["n"] * N_STAGES * r["count"]
                for r in decode) / INT32_OPS_PER_S * 1e3
    spec = common.get_kernel("cordic_mac")
    record = {
        "name": spec.name, "route": "cuda", "source": spec.source,
        "replaces": spec.replaces, "launches": served["launches"],
        "max_abs_err": t_kernel["max_abs_err"],
        "ms": sum(r["ms"] * r["count"] for r in decode),
        "plain_ms": sum(r["plain_ms"] * r["count"] for r in decode),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "work": f"one decode forward call of glm4-9b: "
                f"{LAUNCHES_PER_FORWARD} launches at M={m}",
    }
    log(smi)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
