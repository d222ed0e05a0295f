#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device    — a CUDA card must be present; prints nvidia-smi's name and
               power limit.
2. build     — builds every kernel from the sources in this checkout (one
               nvcc per source, all started together, sm_90a), printing
               build times and ptxas' register report.
3. kernel    — holds ``cordic_mac`` bit-exact against its plain torch
               version on the card (FXP8/16/32, E_i = 0 stages, odd shapes,
               int32 wrap, and every shape the serving path gives it), and
               times kernel, plain version and bound at the serving shapes.
4. davinci   — holds ``cordic_act`` (tanh, sigmoid, exp) and
               ``cordic_softmax`` bit-exact against their plain versions at
               FXP4/8/16, two iteration counts, odd shapes, the saturated
               ends of each format and the serving run's shapes, and their
               float frontends within the reference tests' bands.
5. reference — a reduced glm4-9b on the card (kernel) against the same
               model on the CPU (plain version): logits within a stated
               tolerance, equal greedy tokens.  Then the ``CORDIC_EXEC``
               modules (``quantized_dense``, ``activate``) card against CPU,
               and the reduced glm4-9b under ``CORDIC_EXEC`` card against
               CPU: forward logits, and greedy outputs of the engine.
6. serve     — full-width glm4-9b (40 layers, d_model 4096, vocab 151552,
               bf16, random weights from seed 0) under
               ``ExecutionPolicy(matmul="cordic_kernel")`` through the port's
               ``ServeEngine``: 4 requests, 8 new tokens each.  Asserts 281
               kernel launches per forward call and no plain-version call,
               and that one request's greedy output equals the port's own
               single-stream prefill + decode; profiles one decode step; then
               holds the engine to single-stream decode on the reduced model
               too, whose greedy tokens vary.
7. cordic_exec serve — the same model, parameters and traffic under the
               paper's ``CORDIC_EXEC`` (W8A8 matmuls, DA-VINCI AFs): every
               request served, tokens in the vocabulary, a second serve
               gives the same tokens, no plain-version call; prefill and
               decode times, tok/s, peak memory, one profiled decode step.
               The second serve records the activations the DA-VINCI
               kernels take: the gate pre-activations (prefill and
               decode), the attention score rows and the logits.
8. davinci path — the DA-VINCI kernels' path, the public entry points
               ``repro_torch.kernels.cordic_act`` (sigmoid, on the gate
               pre-activations) and ``cordic_softmax`` (on the score rows
               and the logits), driven with every count set to 0 before and
               read after; then each launch's raw words against the plain
               version, and kernel, plain version and bound timed on them.
               (The model's CORDIC AFs are ``activate``'s float-emulated
               recurrences, as in the reference, so phase 7 launches
               neither kernel.)

9. wkv       — holds ``wkv`` and ``wkv_q8`` against their plain versions
               on the card: the reference's kernel test shapes, full-width
               heads (d = 64), odd T (1, 7, 65), float32 and bfloat16
               inputs; q8 from a random, a zero and a saturated (+-127)
               state.  y within atol = rtol = 5e-5 (float32; from the
               saturated state, within the per-output bound of
               ``y_close``), the int8 state's words and scales equal.
10. rwkv6 reference — a reduced rwkv6-3b on the card against the CPU
               under float32 matmuls (within a tolerance, equal greedy
               tokens), and under ``cordic_kernel`` against its own plain
               version on the card (equal logits).
11. rwkv6 serve — full-width rwkv6-3b (32 layers, d_model 2560, 40 heads
               of 64, d_ff 8960, vocab 65536, bf16, 3.07 B parameters,
               random weights from seed 0) under ``cordic_kernel`` through
               the ``ServeEngine``, twice: with the float32 and with the
               int8 recurrent state (``CacheSpec(dtype="int8")``).  Each:
               257 ``cordic_mac`` launches per forward call and no other
               kernel or plain-version call, one request equal to
               single-stream decode, times, peak memory, a profiled
               decode step; then the reduced model's engine equal to
               single-stream decode.  A second int8 serve records, for
               layers 0 and 31, the prefill's masked r, k, v, w, u and
               recurrence output, and one decode step's inputs with the
               int8 state in and out.
12. wkv path  — ``repro_torch.kernels.wkv`` on the recorded prefill and
               ``wkv_q8`` on the recorded decode step, every count set to
               0 before and read after; each launch against its plain
               version, ``wkv_q8``'s new state against the one the served
               model wrote (equal), y against the model's own recurrence
               (the per-output bound of ``y_close``);
               kernel, plain version and bound timed on them, and (context
               only) one layer of a 4096-token prompt.

13. flash     — kernels 4 and 6 (``flash_attention``,
               ``flash_attention_bwd``): ``repro_torch.kernels.flash_attention``
               forward and backward at glm4-9b's training layout (B 1, S 4096,
               32 q heads, 2 kv heads of 128, bf16, causal), every count set
               to 0 before and read after; then out, lse, dq, dk, dv against
               the plain versions (the reference's gradient test shapes, d =
               64 and 128, float32 and bf16, and that layout; atol = rtol =
               2e-4), the ops-level gradient against the exact attention VJP;
               kernel, plain version, bound and scaled_dot_product_attention
               timed at that layout, and kernel 6's passes (dQ, dK/dV, the
               sum of the dK/dV parts) by device time from torch.profiler.
14. rwkv6 train — full-width rwkv6-3b trained under ``CORDIC_EXEC`` by the
               port's ``Trainer`` (as ``launch/train.py --cordic --batch 2
               --seq 256 --steps 3`` builds it: SyntheticStream, AdamW with
               float32 moments, remat): finite losses and grad norms,
               parameters changed, no plain-version call; step time,
               tokens/s, peak memory, one profiled step; layers 0 and 31's
               recurrence inputs and output gradient recorded.  Then the
               reduced rwkv6 and glm4 trained 3 steps on the card against the
               CPU in float32 (float32 matmuls and ``CORDIC_EXEC``; losses
               within 1e-4), and a ``fault_at`` restart on the reduced rwkv6
               whose resumed losses equal the uninterrupted run's.
15. wkv backward path — ``repro_torch.kernels.wkv`` forward (with
               checkpoints, kernel 7) and backward (kernel 9) through autograd
               on the recorded tensors, every count set to 0 before and read
               after; checkpoints equal to the plain version's, gradients
               within a per-output bar of the plain adjoint sweep and of the
               model's own autograd gradients; kernel 9, plain version and
               bound timed, and (context only) one layer of a 4096-token
               sequence.
16. int8 serve — phase 6's model, parameters and traffic with the int8
               K/V cache (``ServeConfig(cache=CacheSpec(dtype="int8"))``):
               281 ``cordic_mac`` launches per forward call and no other
               kernel or plain-version call, the slot cache int8 with float32
               scales and its bytes against phase 6's bf16 cache, one
               request equal to single-stream decode, times, peak memory, a
               profiled decode step; the reduced model's engine with the int8
               cache equal to single-stream decode; a recorded serve keeps,
               for layers 0 and 39, the prefill's queries and int8 K/V words
               and scales, and one decode step's queries, caches and
               positions.  (Run after phase 8, on phase 6's parameters.)
17. q8 path   — kernel 5 (``flash_attention_q8``) through
               ``repro_torch.kernels.flash_attention_q8`` on the recorded
               cache, every count set to 0 before and read after: the
               prefill bucket (causal) and each slot's decode query over its
               filled prefix (not causal: the mask is aligned top-left);
               every call against the plain version (float32 atol = rtol =
               2e-4; a bf16 output atol 2e-4 and rtol one bf16 step); then
               at glm4-9b's long-context layout (a causal 4096-token prefill,
               a decode of 4 rows over 4096 cached positions, float32 and
               bf16 q) checked, and timed with its bound, the plain version
               and scaled_dot_product_attention on K/V dequantized
               beforehand; kernel 5's plan (block shape, key chunks, grid)
               logged at every shape, and its device time by CUDA kernel
               (the main kernel, the combine of the key chunks).

Each phase prints its seconds.  The last three lines are nvidia-smi's
name and power limit, one JSON object with a record per kernel, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (CORDIC_EXEC, LM_SHAPES,  # noqa: E402
                                 CacheSpec, ExecutionPolicy, get_arch)
from repro_torch.core import activations as acts  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.core import quantization as quant  # noqa: E402
from repro_torch.data.pipeline import stream_for_model  # noqa: E402
from repro_torch.core.quant_cache import quantize_blocked  # noqa: E402
from repro_torch.kernels import (common, cordic_act,  # noqa: E402
                                 cordic_softmax, flash_attention,
                                 flash_attention_q8, wkv, wkv_q8)
from repro_torch.kernels.cordic_act import kernel as act_kernel  # noqa: E402
from repro_torch.kernels.cordic_act.ref import (  # noqa: E402
    EXP_ARG_CLAMP, GUARD_BITS, cordic_act_raw_ref, exp_neg_raw_ref)
from repro_torch.kernels.cordic_mac import kernel as mac_kernel  # noqa: E402
from repro_torch.kernels.cordic_mac.ref import cordic_matmul_raw_ref  # noqa: E402
from repro_torch.kernels.cordic_softmax import kernel as sm_kernel  # noqa: E402
from repro_torch.kernels.cordic_softmax.ref import (  # noqa: E402
    cordic_softmax_raw_ref)
from repro_torch.kernels.flash_attention import \
    kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_bwd_ref, flash_fwd_ref, flash_q8_ref)
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv.ref import (wkv_q8_ref,  # noqa: E402
                                         wkv_recurrence_bwd_ref,
                                         wkv_recurrence_ref)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.spec import to_device  # noqa: E402
from repro_torch.optim.adamw import (BLOCK_SCAN_MIN,  # noqa: E402
                                     AdamWConfig, lr_at)
from repro_torch.optim.adamw import init as adamw_init  # noqa: E402
from repro_torch.runtime.serve_loop import (Request, ServeConfig,  # noqa: E402
                                            ServeEngine)
from repro_torch.runtime.train_loop import TrainConfig, Trainer  # noqa: E402

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

# W8A16 is a float matmul: on the card its sums run in another order.
# Largest |card - CPU| over the largest output; measured 5.0e-7 (float32)
# and 2.0e-3 (bfloat16, half a bf16 ulp of the output) on an H100 80GB
# HBM3 at 700 W.
W8A16_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}

# The DA-VINCI kernels as their float frontends run them by default:
# FXP16, 5 hyperbolic and max(4, frac + guard) = 12 division iterations.
AF_FMT = fxp.FXP16
AF_N_HYP = 5
AF_N_DIV = max(4, AF_FMT.frac_bits + GUARD_BITS)
# Serving shapes of full-width glm4-9b at max_batch 4: gate
# pre-activations of decode and of the 16-token prefill bucket; attention
# score rows of that prefill (4 x 32 heads x 16 queries, 16 keys) and of
# decode (4 x 32 heads, 64 cache positions); one vocabulary-wide block.
DAVINCI_SHAPES = {
    "cordic_act": ((7, 13), (4, 13696), (64, 13696)),
    "cordic_softmax": ((7, 13), (4 * 32 * 16, 16), (4 * 32, 64),
                       (4, 151552)),
}


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


# ---------------------------------------------------------------------------
# DA-VINCI kernels: cordic_act and cordic_softmax
# ---------------------------------------------------------------------------

def exp_neg_ops(n_hyp: int) -> int:
    """int32 operations of one exp_neg in cordic_af.cuh: the k extraction
    and reduction (5), 6 per hyperbolic iteration (two shifts, a sign test,
    three adds), the barrel shift with its clamp (5)."""
    return 10 + 6 * n_hyp


def act_ops(af: str, n_hyp: int, n_div: int) -> int:
    """int32 operations per element of cordic_act.cu's act(): the AF's own
    steps, exp_neg, 4 per division iteration (shift, sign test, two adds)
    and the output latch (2)."""
    own = {"exp": 5, "tanh": 12 + 4 * n_div, "sigmoid": 10 + 4 * n_div}[af]
    return own + exp_neg_ops(n_hyp)


def act_bound(af: str, n: int) -> tuple:
    """(bytes ms, operations ms) of one cordic_act launch on n words: each
    word read and written once, against the int32 operations above."""
    return (8 * n / HBM_BYTES_PER_S * 1e3,
            n * act_ops(af, AF_N_HYP, AF_N_DIV) / INT32_OPS_PER_S * 1e3)


def softmax_bound(raw: torch.Tensor) -> tuple:
    """(bytes ms, operations ms) of the row softmax on these words: each
    word read and written once, against the function's int32 operations.
    Per element the max (2), one exp_neg, the sum and the latch (10); the
    divide only where exp_neg is not 0 (the zero-skip), counted from this
    input.  The kernel's pass 3 recomputes exp_neg instead of keeping a
    row; the function needs it once, so the bound counts it once."""
    fb = AF_FMT.frac_bits + GUARD_BITS
    a = torch.bitwise_left_shift(raw, GUARD_BITS)
    d = torch.clamp(a - a.amax(dim=-1, keepdim=True),
                    min=-fxp.constant_raw(EXP_ARG_CLAMP, fb))
    live = int((exp_neg_raw_ref(d, fb, AF_N_HYP) != 0).sum())
    n = raw.numel()
    ops = n * (12 + exp_neg_ops(AF_N_HYP)) + live * 4 * AF_N_DIV
    return 8 * n / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3


def larger(t_bytes: float, t_ops: float) -> tuple:
    """The bound and what sets it."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plant_ends(x: torch.Tensor, fmt) -> torch.Tensor:
    """Both saturated ends of the format and zero at the front."""
    flat = x.view(-1)
    flat[:3] = torch.tensor([fmt.raw_min, fmt.raw_max, 0], dtype=torch.int32)
    return x


def check_words(name: str, got, want, what: str, errs: list) -> None:
    torch.cuda.synchronize()
    errs.append(int((got.long() - want.long()).abs().max()))
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"{name} {what}: {bad} of {got.numel()} words "
                             f"differ from the plain version")


def phase_davinci(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    errs = {"cordic_act": [], "cordic_softmax": []}
    log("[davinci] bit-exactness against the plain versions")
    for fmt_name, fmt in (("FXP4", fxp.FXP4), ("FXP8", fxp.FXP8),
                          ("FXP16", fxp.FXP16)):
        iters = ((AF_N_HYP, max(4, fmt.frac_bits + GUARD_BITS)), (12, 12))
        for n_hyp, n_div in iters:
            for shape in DAVINCI_SHAPES["cordic_act"]:
                x = plant_ends(raw_words(gen, shape, fmt, dev), fmt)
                for af in ("tanh", "sigmoid", "exp"):
                    kw = dict(af=af, fmt=fmt, n_hyp=n_hyp, n_div=n_div)
                    check_words("cordic_act",
                                act_kernel.cordic_act_raw_cuda(x, **kw),
                                cordic_act_raw_ref(x, **kw),
                                f"{fmt_name} {af} {shape}", errs["cordic_act"])
            for shape in DAVINCI_SHAPES["cordic_softmax"]:
                x = fxp.quantize(torch.randn(shape, generator=gen, device=dev)
                                 * 2 - 3, fmt)
                x = plant_ends(x, fmt)
                x[-1] = fmt.raw_min              # a constant row
                kw = dict(fmt=fmt, n_hyp=n_hyp, n_div=n_div)
                check_words("cordic_softmax",
                            sm_kernel.cordic_softmax_raw_cuda(x, **kw),
                            cordic_softmax_raw_ref(x, **kw),
                            f"{fmt_name} {shape}", errs["cordic_softmax"])
        log(f"  bit-exact: {fmt_name}, (n_hyp, n_div) {iters}: cordic_act x "
            f"{{tanh, sigmoid, exp}} at {DAVINCI_SHAPES['cordic_act']}, "
            f"cordic_softmax at {DAVINCI_SHAPES['cordic_softmax']}, both "
            f"saturated ends")
    x = (torch.rand((32, 64), generator=gen, device=dev) * 12 - 6)
    bands = {}
    for af, exact in (("tanh", torch.tanh), ("sigmoid", torch.sigmoid),
                      ("exp", lambda v: torch.exp(torch.clamp(v, max=0)))):
        bands[af] = ((cordic_act(x, af, n_hyp=12) - exact(x)).abs().max()
                     .item(), (cordic_act(x, af) - exact(x)).abs().max()
                     .item())
    s = torch.randn((16, 64), generator=gen, device=dev) * 2
    bands["softmax"] = tuple(
        (cordic_softmax(s, **kw) - torch.softmax(s, -1)).abs().max().item()
        for kw in ({"n_hyp": 12}, {}))
    log("[davinci] float frontends against the exact functions, max abs err "
        "(n_hyp=12, default): " + ", ".join(
            f"{k} {a:.4f} {b:.4f}" for k, (a, b) in bands.items()))
    if any(a >= 0.02 for a, _ in bands.values()) or any(
            bands[k][1] >= 0.05 for k in ("tanh", "sigmoid", "softmax")):
        raise AssertionError("a DA-VINCI frontend left the reference tests' "
                             "band (0.02 at n_hyp=12, 0.05 at the default)")
    return errs


@contextlib.contextmanager
def kernel_takes_plain(name: str):
    """CUDA tensors take the plain version of kernel ``name`` meanwhile."""
    spec = common.get_kernel(name)
    kernel = spec.kernel
    spec.kernel = spec.plain
    try:
        yield
    finally:
        spec.kernel = kernel


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

    with kernel_takes_plain("cordic_mac"), torch.inference_mode():
        plain = build_model(dataclasses.replace(
            base, exec_policy=ExecutionPolicy(matmul="cordic_kernel")),
            dev).forward(to_device(params, dev),
                         {"tokens": tokens.to(dev)}).cpu()
    got = logits["cordic_kernel", "card"]
    cross = (got - logits["cordic_kernel", "cpu"]).abs().max().item()
    log(f"[reference] reduced glm4-9b, cordic_kernel: kernel vs plain version "
        f"on the card equal: {torch.equal(got, plain)}; (card vs CPU max abs "
        f"err {cross:.3e}, recorded only)")
    if not (torch.isfinite(got).all() and got.shape == (2, 12, 256)
            and torch.equal(got, plain)):
        raise AssertionError("cordic model: kernel and plain version disagree")


def phase_cordic_exec_reference(dev) -> dict:
    """CORDIC_EXEC's modules and the reduced model, card against CPU.

    W8A8 ``quantized_dense`` and ``activate`` must be bit-equal: their float
    ops are the reference's, one rounded operation at a time
    (``core/libm.py``), and the int8 product is exact.  W8A16 is a float
    matmul, summed in another order on the card: recorded, and held to
    W8A16_TOL of the largest output.  The reduced model's logits, float32
    and bfloat16, must be equal: the last-bit float differences of
    attention and rms_norm did not move one int8 activation word on these
    inputs (H100 80GB HBM3, 700 W).
    """
    gen = torch.Generator().manual_seed(2)
    out = {}
    log("[cordic_exec] modules, card against CPU")
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((4, 4096, 256), (64, 4096, 256), (4, 13696, 512)):
            x = torch.randn((m, k), generator=gen).to(dtype)
            w = (torch.randn((k, n), generator=gen) / math.sqrt(k)).to(dtype)
            for name, pol in (("W8A8", quant.QuantPolicy()),
                              ("W8A16", quant.QuantPolicy(act_bits=None))):
                got = quant.quantized_dense(x.to(dev), w.to(dev), pol).cpu()
                want = quant.quantized_dense(x, w, pol)
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                out[name, dtype, m, k, n] = rel
                log(f"  quantized_dense {name} {str(dtype)[6:]} M={m} K={k} "
                    f"N={n}: equal {torch.equal(got, want)}, max abs err "
                    f"{err:.3e} ({rel:.3e} of the largest output)")
                if name == "W8A8" and not torch.equal(got, want):
                    raise AssertionError("W8A8 quantized_dense: card and CPU "
                                         "differ")
                if name == "W8A16" and not rel <= W8A16_TOL[dtype]:
                    raise AssertionError("W8A16 quantized_dense beyond its "
                                         "tolerance")
    x = torch.cat([torch.rand(4000, generator=gen) * 16 - 8,
                   torch.randn(96, generator=gen) * 40]).reshape(-1, 64)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for bits in (8, 16):
            pol = acts.CordicPolicy(bits=bits)
            for name in acts.SUPPORTED_AFS:
                got = acts.activate(xd.to(dev), name, pol).cpu()
                if not torch.equal(got, acts.activate(xd, name, pol)):
                    raise AssertionError(f"activate {name} FXP{bits} "
                                         f"{dtype}: card and CPU differ")
    log(f"  activate: all {len(acts.SUPPORTED_AFS)} AFs at FXP8 and FXP16, "
        f"float32 and bfloat16 inputs: card equals CPU bit for bit")

    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 12)))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(
            get_arch("glm4-9b").reduced().scaled(dtype=dtype),
            exec_policy=CORDIC_EXEC)
        params = build_model(cfg, "cpu").init(seed=0)
        with torch.inference_mode():
            got = build_model(cfg, dev).forward(
                to_device(params, dev), {"tokens": tokens.to(dev)}).cpu()
            want = build_model(cfg, "cpu").forward(params, {"tokens": tokens})
        err = (got.float() - want.float()).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        out[dtype] = (err, agree)
        log(f"[cordic_exec] reduced glm4-9b {dtype}: card vs CPU max abs "
            f"logit err {err:.3e}, greedy agreement {agree:.3f} "
            f"(equal: {torch.equal(got, want)})")
        if not (torch.isfinite(got).all() and got.shape == (2, 12, 256)
                and torch.equal(got, want)):
            raise AssertionError("CORDIC_EXEC reduced model: card and CPU "
                                 "logits differ")
        # the engine on the card and on the CPU: 6 requests of mixed
        # length through 4 slots, equal greedy outputs per request
        rng = np.random.default_rng(3)
        traffic = [(i, rng.integers(0, 256, n).astype(np.int32), k)
                   for i, (n, k) in enumerate(zip((5, 11, 16, 3, 24, 8),
                                                  (4, 9, 2, 12, 1, 6)))]
        served = {}
        for where, p in ((dev, to_device(params, dev)), ("cpu", params)):
            done = ServeEngine(build_model(cfg, where), p, ServeConfig(
                max_batch=4, max_seq=64)).serve(
                [Request(i, prompt, max_new_tokens=k)
                 for i, prompt, k in traffic])
            served[str(where)] = {r.rid: r.output.tolist() for r in done}
        same = served[str(dev)] == served["cpu"]
        log(f"[cordic_exec] reduced glm4-9b {dtype}: engine on the card "
            f"equals the engine on the CPU for all {len(traffic)} requests: "
            f"{same}")
        if not same:
            raise AssertionError("CORDIC_EXEC engine: card and CPU differ")
    return out


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
        f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(n for _, _, n in kernels)} device kernels")
    for key, t, n in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"  {t:8.2f} ms {t / busy:6.1%} x{n:4d}  {key[:90]}")


def serve_traffic(vocab: int):
    """The serving phases' requests: one warm-up request, then 4 of 8-16
    prompt tokens and 8 new tokens each; and the generator, for more."""
    rng = np.random.default_rng(0)
    warm = [Request(100, rng.integers(0, vocab, 8).astype(np.int32),
                    max_new_tokens=2)]
    reqs = [Request(i, rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=8)
            for i, n in enumerate(rng.integers(8, 17, 4))]
    return warm, reqs, rng


def timed_serve(engine, reqs, dev):
    """Serve ``reqs`` with every kernel count set to 0 just before; returns
    the requests and that run's engine metrics, counts and peak memory."""
    keys = ("prefill_s", "decode_s", "decode_steps", "decode_tokens")
    base = {k: engine.metrics[k] for k in keys}
    prefills_before = sum(engine.prefill_counts.values())
    torch.cuda.reset_peak_memory_stats(dev)
    common.reset_counts()
    done = engine.serve(reqs)
    torch.cuda.synchronize()
    run = {k: engine.metrics[k] - base[k] for k in keys}
    run["prefills"] = sum(engine.prefill_counts.values()) - prefills_before
    run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    run["counts"] = {n: (common.get_kernel(n).launches,
                         common.get_kernel(n).plain_calls)
                     for n in common.registered_kernels()}
    if len(done) != len(reqs):
        raise AssertionError("not every request was served")
    vocab = engine.model.cfg.vocab_size
    for r in done:
        if len(r.output) != r.max_new_tokens or not np.all(
                (r.output >= 0) & (r.output < vocab)):
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    return done, run


def log_times(tag: str, run: dict, smi: str) -> None:
    log(f"[{tag}] prefill (4 x 16 tokens, M=64) {run['prefill_s'] * 1e3:.1f} "
        f"ms; decode {run['decode_s'] / run['decode_steps'] * 1e3:.1f} "
        f"ms/step, {run['decode_tokens'] / run['decode_s']:.2f} tok/s; peak "
        f"allocated {run['peak_gb']:.2f} GB [{smi}]")


def full_width(policy: ExecutionPolicy):
    cfg = dataclasses.replace(get_arch("glm4-9b"), exec_policy=policy)
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) != FULL_WIDTH:
        raise AssertionError(f"glm4-9b is not at full width: {cfg}")
    return cfg


def phase_serve(dev, smi: str) -> dict:
    cfg = full_width(ExecutionPolicy(matmul="cordic_kernel"))
    t0 = time.monotonic()
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    log(f"[serve] glm4-9b full width: {model.n_params() / 1e9:.3f} B params "
        f"initialised on the card in {time.monotonic() - t0:.1f} s")
    max_seq = 64
    engine = ServeEngine(model, params, ServeConfig(max_batch=4,
                                                    max_seq=max_seq))
    warm, reqs, rng = serve_traffic(cfg.vocab_size)
    engine.serve(warm)          # first-touch costs (cuBLAS handles etc.)
    done, run = timed_serve(engine, reqs, dev)
    launches, plain = run["counts"]["cordic_mac"]
    forwards = run["prefills"] + run["decode_steps"]
    log(f"[serve] {len(done)} requests, {run['prefills']} prefill(s), "
        f"{run['decode_steps']} decode steps: cordic_mac launches {launches} "
        f"(= {launches / forwards:.1f} per forward call), plain-version calls "
        f"{plain}")
    if launches != LAUNCHES_PER_FORWARD * forwards or plain != 0:
        raise AssertionError(f"expected {LAUNCHES_PER_FORWARD} launches per "
                             f"forward call and no plain call")
    log_times("serve", run, smi)
    profile_step(model, params, engine)
    r0 = min(done, key=lambda r: r.rid)
    ref = single_stream(model, params, r0.prompt, r0.max_new_tokens, max_seq)
    log(f"[serve] request {r0.rid}: engine {r0.output.tolist()} single-stream "
        f"{ref}")
    if r0.output.tolist() != ref:
        raise AssertionError("engine output differs from single-stream decode")
    cache_bytes = state_bytes(engine._state)
    del engine
    torch.cuda.empty_cache()
    # With random fan-in-scaled weights every |w| < 1/16 runs through the
    # 5-stage FXP16 recurrence as +-1/16, activations grow and saturate,
    # and the full-width greedy output is one token repeated.  So the
    # engine is also held to single-stream decode on the reduced model,
    # whose tokens vary: 6 requests of mixed length through 4 slots.
    small = dataclasses.replace(get_arch("glm4-9b").reduced(),
                                exec_policy=ExecutionPolicy(
                                    matmul="cordic_kernel"))
    small_model = build_model(small, dev)
    small_params = small_model.init(seed=0)
    engine = ServeEngine(small_model, small_params,
                         ServeConfig(max_batch=4, max_seq=max_seq))
    reqs = [Request(i, rng.integers(0, small.vocab_size, n).astype(np.int32),
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip((5, 11, 16, 3, 24, 8),
                                           (4, 9, 2, 12, 1, 6)))]
    done = engine.serve(reqs)
    bad = [r.rid for r in done if r.output.tolist() != single_stream(
        small_model, small_params, r.prompt, r.max_new_tokens, max_seq)]
    log(f"[serve] reduced glm4-9b (bf16, cordic_kernel): {len(done)} requests "
        f"through 4 slots, {len({t for r in done for t in r.output})} distinct "
        f"tokens, equal to single-stream decode: {not bad}")
    if bad or len(done) != len(reqs):
        raise AssertionError(f"engine differs from single-stream for {bad}")
    return {"launches": launches, "params": params, "cache_bytes": cache_bytes}


@contextlib.contextmanager
def record_activations(store: dict, vocab: int):
    """Keep the first input of each shape that reaches ``layers.af`` (the
    gate pre-activations) and ``layers.softmax`` (the attention scores),
    and the first vocabulary-wide ``layers.dense`` output (the logits)."""
    af, softmax, dense = L.af, L.softmax, L.dense

    def keep(kind, t):
        if (kind, tuple(t.shape)) not in store:
            store[kind, tuple(t.shape)] = t.detach().clone()

    def rec_af(x, name, policy, axis=-1):
        keep("gate", x)
        return af(x, name, policy, axis)

    def rec_softmax(x, policy, axis=-1):
        keep("scores", x)
        return softmax(x, policy, axis)

    def rec_dense(x, w, policy, bias=None, **kw):
        out = dense(x, w, policy, bias, **kw)
        if w.shape[-1] == vocab:
            keep("logits", out)
        return out

    L.af, L.softmax, L.dense = rec_af, rec_softmax, rec_dense
    try:
        yield store
    finally:
        L.af, L.softmax, L.dense = af, softmax, dense


def phase_cordic_exec_serve(dev, smi: str, params) -> dict:
    """Full-width glm4-9b under CORDIC_EXEC, phase 6's parameters and
    traffic."""
    cfg = full_width(CORDIC_EXEC)
    model = build_model(cfg, dev)
    max_seq = 64
    warm, reqs, _ = serve_traffic(cfg.vocab_size)
    engine = ServeEngine(model, params, ServeConfig(max_batch=4,
                                                    max_seq=max_seq))
    engine.serve(warm)
    done, run = timed_serve(engine, reqs, dev)
    plain = sum(p for _, p in run["counts"].values())
    log(f"[cordic_exec serve] glm4-9b full width under CORDIC_EXEC: "
        f"{len(done)} requests, {run['prefills']} prefill(s), "
        f"{run['decode_steps']} decode steps; kernel launches "
        f"{ {n: c[0] for n, c in run['counts'].items()} }, plain-version "
        f"calls {plain}")
    if plain:
        raise AssertionError("a plain version ran on the card")
    log_times("cordic_exec serve", run, smi)
    profile_step(model, params, engine)
    first = {r.rid: r.output.tolist() for r in done}
    captured: dict = {}
    with record_activations(captured, cfg.vocab_size):
        again = ServeEngine(model, params, ServeConfig(
            max_batch=4, max_seq=max_seq)).serve(
            [Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens)
             for r in reqs])
    second = {r.rid: r.output.tolist() for r in again}
    log(f"[cordic_exec serve] tokens {first}; a second serve on a fresh "
        f"engine gives the same tokens: {second == first}; recorded "
        f"{sorted(captured)}")
    if second != first:
        raise AssertionError("CORDIC_EXEC serving is not deterministic")
    return {"run": run, "captured": captured}


def phase_davinci_path(dev, captured: dict, errs: dict) -> dict:
    """The DA-VINCI kernels through their public entry points on the
    serving run's activations; then every launch's words against the plain
    version, and times and bounds at those inputs."""
    rows = {
        "cordic_act": [v.reshape(-1, v.shape[-1]) for (kind, _), v
                       in sorted(captured.items()) if kind == "gate"],
        "cordic_softmax": [v.reshape(-1, v.shape[-1]) for (kind, _), v
                           in sorted(captured.items())
                           if kind in ("scores", "logits")],
    }
    common.reset_counts()
    outs = ([cordic_act(x, "sigmoid") for x in rows["cordic_act"]]
            + [cordic_softmax(x) for x in rows["cordic_softmax"]])
    torch.cuda.synchronize()
    counts = {n: (common.get_kernel(n).launches,
                  common.get_kernel(n).plain_calls) for n in rows}
    log(f"[davinci path] cordic_act (sigmoid) on "
        f"{[tuple(x.shape) for x in rows['cordic_act']]}, cordic_softmax on "
        f"{[tuple(x.shape) for x in rows['cordic_softmax']]}: (launches, "
        f"plain calls) {counts}")
    for n, xs in rows.items():
        if counts[n] != (len(xs), 0):
            raise AssertionError(f"{n}: expected {len(xs)} launches and no "
                                 f"plain call, got {counts[n]}")
    for o in outs:
        if not (torch.isfinite(o).all() and (o >= 0).all() and (o <= 1).all()):
            raise AssertionError("a DA-VINCI output left [0, 1]")

    kw = dict(fmt=AF_FMT, n_hyp=AF_N_HYP, n_div=AF_N_DIV)
    launch = {
        "cordic_act": lambda r: act_kernel.cordic_act_raw_cuda(
            r, af="sigmoid", **kw),
        "cordic_softmax": lambda r: sm_kernel.cordic_softmax_raw_cuda(r, **kw),
    }
    plain = {
        "cordic_act": lambda r: cordic_act_raw_ref(r, af="sigmoid", **kw),
        "cordic_softmax": lambda r: cordic_softmax_raw_ref(r, **kw),
    }
    library = {"cordic_act": torch.sigmoid,
               "cordic_softmax": lambda v: torch.softmax(v, -1)}
    records = {}
    for n, xs in rows.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
        for x in xs:
            x = x.to(torch.float32)
            if n == "cordic_softmax":       # as the frontend quantizes
                x = x - x.amax(dim=-1, keepdim=True)
            raw = fxp.quantize(x, AF_FMT).contiguous()
            check_words(n, launch[n](raw), plain[n](raw),
                        f"serving input {tuple(raw.shape)}", errs[n])
            ms = time_ms(launch[n], [(raw,)], reps=20)
            plain_ms = time_ms(plain[n], [(raw,)], reps=3)
            t_b, t_o = (act_bound("sigmoid", raw.numel())
                        if n == "cordic_act" else softmax_bound(raw))
            bnd, by = larger(t_b, t_o)
            ctx = time_ms(library[n], [(x,)], reps=20)
            log(f"  {n} {tuple(raw.shape)}: bit-exact; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}), "
                f"kernel/bound {ms / bnd:.2f} [context only: float "
                f"{'torch.sigmoid' if n == 'cordic_act' else 'torch.softmax'}"
                f" {ctx:.4f} ms]")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes"] += t_b
            tot["ops"] += t_o
        bnd, by = larger(tot["bytes"], tot["ops"])
        records[n] = {"launches": counts[n][0], "ms": tot["ms"],
                      "plain_ms": tot["plain_ms"], "bound_ms": bnd,
                      "bound_by": by, "max_abs_err": max(errs[n]),
                      "work": f"the DA-VINCI path: "
                              f"{[tuple(x.shape) for x in xs]}"}
    return records


# ---------------------------------------------------------------------------
# rwkv6-3b and the wkv kernels
# ---------------------------------------------------------------------------

# rwkv6-3b at full width: layers, d_model, heads, head_dim, d_ff, vocab,
# dtype.  Every projection runs through cordic_mac: time-mix wr, wk, wv,
# wg, wo and channel-mix wk, wv, wr in each of 32 layers, and lm_head.
RWKV_FULL_WIDTH = (32, 2560, 40, 64, 8960, 65536, "bfloat16")
RWKV_LAUNCHES_PER_FORWARD = 8 * 32 + 1                     # 257
# wkv's y against the plain version: the reference kernel tests' band,
# atol = rtol = 5e-5, on float32 outputs; a bfloat16 output may also round
# the other way (one bfloat16 step, 2**-7 of the value).
WKV_TOL = 5e-5
# Where y cancels (a saturated state; the served activations, whose |y|
# reaches 6e5) the bar is per output instead.  Kernel and plain version
# share the rounded terms of y_j = sum_i (r_i u_i)(k_i v_j) + r_i S_ij and
# the state (equal word for word); each sums the 2 dk products in its own
# order, so the two lie within 2 gamma_{2dk} M_j <= 2 dk eps M_j of one
# another, M_j = sum_i |r_i u_i k_i v_j| + |r_i S_ij| (eps = 2**-23).  The
# model's own recurrence, r . fma(u, kv, S), sums dk + 1 rounded terms:
# it and the kernel lie within (3 dk + 2) eps/2 M_j, inside the same bar.
# M is the plain version run on |r|, |k|, |v|, w, |u| (and the |words| of
# an int8 state): w > 0, so its state bounds |S| element by element.
# 4 eps more cover M's own rounding.
F32_EPS = 2.0 ** -23
# (B, T, H, d): the reference's kernel test shapes, full-width heads, odd T
WKV_SHAPES = ((4, 64, 16, 16), (2, 128, 32, 32), (8, 32, 8, 8),
              (4, 16, 40, 64), (2, 1, 40, 64), (2, 7, 8, 64), (1, 65, 4, 32))
F32_OPS_PER_S = 67e12     # float32 outside the tensor cores, FMA = 2
# float32 operations of one wkv step: per state element k*v (1), the
# state's multiply-add (2) and r_i S_ij into y (2); the bonus term
# sum_i (r_i u_i)(k_i v_j) = v_j (sum_i r_i u_i k_i) is one dk-long dot per
# row (r*u, then a multiply-add: 3 per i) and a multiply-add per column
WKV_OPS_PER_ELEMENT = 5


def wkv_magnitude(fn, r, k, v, w, u, *state) -> torch.Tensor:
    """M of ``y_close`` for the inputs of ``fn`` (a plain version, or a
    public frontend under ``kernel_takes_plain``): float32, shaped as y."""
    args = (r.float().abs(), k.abs(), v.abs(), w, u.abs())
    if state:
        args += (state[0].abs(), state[1])
    out = fn(*args)
    return out[0] if state else out


def y_close(got, want, what: str, errs: list, mag=None):
    """Hold a wkv output to the plain version's: within atol = rtol =
    WKV_TOL or, given ``mag`` (M, see F32_EPS), within (2 dk + 4) eps M
    per output.  ``errs`` collects the largest |difference| of float32
    outputs (a bfloat16 output's is one bfloat16 step wherever the two
    round apart); returns the largest |difference| / (eps M) of a float32
    output given ``mag``, else None."""
    torch.cuda.synchronize()
    g, w_ = got.float(), want.float()
    if g.shape != w_.shape or not torch.isfinite(g).all():
        raise AssertionError(f"wkv {what}: shape {tuple(g.shape)} or values "
                             f"not finite")
    diff = (g - w_).abs()
    f32 = got.dtype == torch.float32
    if f32 and diff.numel():
        errs.append(diff.max().item())
    rtol = WKV_TOL if f32 else 2 ** -7
    if mag is None:
        bar = WKV_TOL + rtol * w_.abs()
        txt = f"atol {WKV_TOL:.1e} + rtol {rtol:.1e}"
    else:
        ulps = 2 * got.shape[-1] + 4                     # dk == dv
        bar = ulps * F32_EPS * mag
        txt = f"{ulps} eps M"
        if not f32:
            bar = bar + rtol * w_.abs()
            txt += f" + rtol {rtol:.1e}"
    bad = int((diff > bar).sum())
    if bad:
        raise AssertionError(f"wkv {what}: {bad} of {g.numel()} outputs "
                             f"beyond {txt}")
    if mag is None or not f32 or not diff.numel():
        return None
    return (diff / (F32_EPS * mag)).nan_to_num(0.0).max().item()


def check_state(got, want, what: str) -> None:
    """The int8 state's words and scales: equal, word for word."""
    torch.cuda.synchronize()
    for name, a, b in (("words", got[0], want[0]), ("scales", got[1],
                                                   want[1])):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            raise AssertionError(f"wkv_q8 {what}: {bad} state {name} differ")


def wkv_inputs(gen, b, t, h, d, dtype, dev):
    """Raw (B*H, T, d) r, k, v, w in ``dtype`` (w in [0.3, 1)), u float32."""
    shape = (b * h, t, d)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    w = (torch.rand(shape, generator=gen, device=dev) * 0.7 + 0.3).to(dtype)
    return r, k, v, w, torch.randn((b * h, d), generator=gen, device=dev)


def phase_wkv(dev) -> dict:
    """wkv and wkv_q8 against their plain versions on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    errs = {"wkv": [], "wkv_q8": []}
    log("[wkv] the kernels against their plain versions: y within atol = "
        f"rtol = {WKV_TOL} (float32; bfloat16 output rtol 2**-7; from a "
        f"saturated state (2 dk + 4) eps M per output), the int8 state's "
        "words and scales equal")
    readings = []
    for b, t, h, d in WKV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            raw = wkv_inputs(gen, b, t, h, d, dtype, dev)
            what = f"(B, T, H, d) = {(b, t, h, d)} {str(dtype)[6:]}"
            y_close(wkv_kernel.wkv_recurrence_cuda(*raw),
                    wkv_recurrence_ref(*raw), what, errs["wkv"])
            bh = b * h
            states = {
                "random state": (
                    torch.randint(-127, 128, (bh, d, d), generator=gen,
                                  device=dev, dtype=torch.int8),
                    torch.rand((bh, d), generator=gen, device=dev) * 0.1),
                "zero state": (torch.zeros((bh, d, d), dtype=torch.int8,
                                           device=dev),
                               torch.zeros((bh, d), device=dev)),
                "saturated rows": (
                    torch.where(torch.rand((bh, d, d), generator=gen,
                                           device=dev) < 0.5, 127, -127
                                ).to(torch.int8),
                    torch.full((bh, d), 3.0, device=dev)),
            }
            for sname, (s0, sc) in states.items():
                got = wkv_kernel.wkv_recurrence_q8_cuda(*raw, s0, sc)
                want = wkv_q8_ref(*raw, s0, sc)
                # a saturated state (|S| ~ 381) cancels in y: there the
                # bar follows each output's terms
                mag = (wkv_magnitude(wkv_q8_ref, *raw, s0, sc)
                       if sname == "saturated rows" else None)
                reading = y_close(got[0], want[0], f"q8 {what} {sname}",
                                  errs["wkv_q8"], mag)
                if reading is not None:
                    readings.append(reading)
                check_state(got[1:], want[1:], f"{what} {sname}")
                if sname == "saturated rows" and int(
                        got[1].abs().max()) != 127:
                    raise AssertionError("no requantized word at +-127")
        log(f"  within the bars: {(b, t, h, d)}, float32 and bfloat16; q8 "
            f"from a random, a zero and a saturated (+-127) state")
    log(f"[wkv] from the saturated state, largest |y - plain| / (eps M): "
        f"{max(readings):.3f}")
    return errs


def rwkv_params(model, seed: int) -> dict:
    """Random parameters with the zero- and one-initialised mixer leaves
    (token-shift factors, decay base, bonus, group-norm gain) redrawn, so
    every path of the mixers counts."""
    params = model.init(seed=seed)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 1)
    tm, cm = params["blocks"]["tm"], params["blocks"]["cm"]
    for leaf, lo, hi in ((tm["mu"], 0.0, 1.0), (tm["w0"], -1.0, 1.0),
                         (tm["bonus"], -0.5, 0.5), (tm["ln_w"], 0.5, 1.5),
                         (cm["mu_k"], 0.0, 1.0), (cm["mu_r"], 0.0, 1.0)):
        leaf.copy_(torch.rand(leaf.shape, generator=gen, device=model.device)
                   * (hi - lo) + lo)
    return params


def phase_rwkv_reference(dev) -> None:
    """A reduced rwkv6 (float32) on the card against two references.

    1. ``matmul="bf16"`` (float32 matmuls), card vs CPU: logits within
       FLOAT_TOL, equal greedy tokens.
    2. ``matmul="cordic_kernel"``, kernel vs plain version on the card:
       equal logits (card vs CPU only recorded, ROADMAP queue 3).
    """
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 12)))
    base = get_arch("rwkv6-3b").reduced().scaled(dtype="float32")
    params = rwkv_params(build_model(base, "cpu"), seed=0)
    logits = {}
    for matmul in ("bf16", "cordic_kernel"):
        cfg = dataclasses.replace(base,
                                  exec_policy=ExecutionPolicy(matmul=matmul))
        with torch.inference_mode():
            logits[matmul, "cpu"] = build_model(cfg, "cpu").forward(
                params, {"tokens": tokens})
            logits[matmul, "card"] = build_model(cfg, dev).forward(
                to_device(params, dev), {"tokens": tokens.to(dev)}).cpu()
            if matmul == "cordic_kernel":
                with kernel_takes_plain("cordic_mac"):
                    logits[matmul, "plain"] = build_model(cfg, dev).forward(
                        to_device(params, dev),
                        {"tokens": tokens.to(dev)}).cpu()
    got, want = logits["bf16", "card"], logits["bf16", "cpu"]
    err = (got - want).abs().max().item()
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    log(f"[rwkv6 reference] reduced rwkv6-3b, float32 matmuls: card vs CPU "
        f"max abs err {err:.3e} (tolerance {FLOAT_TOL}), equal greedy "
        f"tokens: {same}")
    if not (err <= FLOAT_TOL and same):
        raise AssertionError("float rwkv6 on the card disagrees with the CPU")
    got = logits["cordic_kernel", "card"]
    cross = (got - logits["cordic_kernel", "cpu"]).abs().max().item()
    equal = torch.equal(got, logits["cordic_kernel", "plain"])
    log(f"[rwkv6 reference] reduced rwkv6-3b, cordic_kernel: kernel vs plain "
        f"version on the card equal: {equal}; (card vs CPU max abs err "
        f"{cross:.3e}, recorded only)")
    if not (torch.isfinite(got).all() and got.shape == (2, 12, 256)
            and equal):
        raise AssertionError("cordic rwkv6: kernel and plain version disagree")


@contextlib.contextmanager
def record_wkv(store: dict, n_layers: int, keep: tuple):
    """Record, for the layers in ``keep``: the first prefill's and the first
    decode step's recurrence inputs and outputs (``ssm.wkv_steps``, as
    masked), and that decode step's int8 state in and out."""
    steps, decode = ssm.wkv_steps, T.decode_step
    calls = []

    def rec_steps(r, k, v, w, u, S):
        out, s_new = steps(r, k, v, w, u, S)
        layer = len(calls) % n_layers
        kind = "prefill" if r.shape[1] > 1 else "decode"
        calls.append(kind)
        if layer in keep and layer not in store[kind]:
            store[kind][layer] = {
                "r": r.clone(), "k": k.clone(), "v": v.clone(),
                "w": w.clone(), "u": u.clone(), "out": out.clone()}
        return out, s_new

    def rec_decode(params, state, batch, cfg, pol=None):
        first = not store["state_in"] and state.wkv_scale is not None
        if first:
            store["state_in"] = {i: (state.wkv[i].clone(),
                                     state.wkv_scale[i].clone())
                                 for i in keep}
        res = decode(params, state, batch, cfg, pol)
        if first:
            store["state_out"] = {i: (state.wkv[i].clone(),
                                      state.wkv_scale[i].clone())
                                  for i in keep}
        return res

    ssm.wkv_steps, T.decode_step = rec_steps, rec_decode
    try:
        yield store
    finally:
        ssm.wkv_steps, T.decode_step = steps, decode


def rwkv_full_width():
    cfg = dataclasses.replace(get_arch("rwkv6-3b"), exec_policy=ExecutionPolicy(
        matmul="cordic_kernel"))
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
           cfg.vocab_size, cfg.dtype)
    if got != RWKV_FULL_WIDTH:
        raise AssertionError(f"rwkv6-3b is not at full width: {got}")
    return cfg


def phase_rwkv_serve(dev, smi: str) -> dict:
    """Full-width rwkv6-3b under cordic_kernel, served with the float32
    and with the int8 recurrent state; the int8 serve records the wkv
    path's inputs."""
    cfg = rwkv_full_width()
    t0 = time.monotonic()
    model = build_model(cfg, dev)
    params = rwkv_params(model, seed=0)
    torch.cuda.synchronize()
    log(f"[rwkv6 serve] rwkv6-3b full width: {model.n_params() / 1e9:.3f} B "
        f"params initialised on the card in {time.monotonic() - t0:.1f} s")
    max_seq = 64
    out = {"launches": 0, "runs": {}}
    for state in ("float32", "int8"):
        cache = CacheSpec(dtype="int8") if state == "int8" else None
        engine = ServeEngine(model, params, ServeConfig(
            max_batch=4, max_seq=max_seq, cache=cache))
        served = engine.model
        warm, reqs, rng = serve_traffic(cfg.vocab_size)
        engine.serve(warm)
        done, run = timed_serve(engine, reqs, dev)
        launches, plain = run["counts"]["cordic_mac"]
        forwards = run["prefills"] + run["decode_steps"]
        others = {n: c for n, c in run["counts"].items()
                  if n != "cordic_mac" and c != (0, 0)}
        log(f"[rwkv6 serve] {state} state: {len(done)} requests, "
            f"{run['prefills']} prefill(s), {run['decode_steps']} decode "
            f"steps: cordic_mac launches {launches} (= "
            f"{launches / forwards:.1f} per forward call), plain-version "
            f"calls {plain}, other kernels {others or 'none'}")
        if (launches != RWKV_LAUNCHES_PER_FORWARD * forwards or plain != 0
                or others):
            raise AssertionError(f"expected {RWKV_LAUNCHES_PER_FORWARD} "
                                 f"cordic_mac launches per forward call and "
                                 f"no other kernel or plain call")
        out["launches"] += launches
        out["runs"][state] = run
        log_times(f"rwkv6 serve, {state} state", run, smi)
        profile_step(served, params, engine)
        r0 = min(done, key=lambda r: r.rid)
        ref = single_stream(served, params, r0.prompt, r0.max_new_tokens,
                            max_seq)
        log(f"[rwkv6 serve] {state} state, request {r0.rid}: engine "
            f"{r0.output.tolist()} single-stream {ref}")
        if r0.output.tolist() != ref:
            raise AssertionError("engine output differs from single-stream "
                                 "decode")
        if state == "int8":
            store = {"prefill": {}, "decode": {}, "state_in": {},
                     "state_out": {}}
            with record_wkv(store, cfg.n_layers, (0, cfg.n_layers - 1)):
                again = ServeEngine(model, params, ServeConfig(
                    max_batch=4, max_seq=max_seq, cache=cache)).serve(
                    [Request(r.rid, r.prompt, max_new_tokens=2)
                     for r in reqs])
            want = {r.rid: r.output.tolist()[:2] for r in done}
            if {r.rid: r.output.tolist() for r in again} != want:
                raise AssertionError("the recording serve gave other tokens")
            out["recorded"] = store
            log(f"[rwkv6 serve] int8 state: recorded layers 0 and "
                f"{cfg.n_layers - 1}: prefill r/k/v/w "
                f"{tuple(store['prefill'][0]['r'].shape)}, decode "
                f"{tuple(store['decode'][0]['r'].shape)}, int8 state "
                f"{tuple(store['state_in'][0][0].shape)}")
        del engine
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    # the full-width greedy output can saturate to one token repeated (as
    # glm4-9b's does); so the engine is also held to single-stream decode
    # on the reduced model, whose tokens vary: 6 requests through 4 slots
    small = dataclasses.replace(get_arch("rwkv6-3b").reduced(),
                                exec_policy=ExecutionPolicy(
                                    matmul="cordic_kernel"))
    small_model = build_model(small, dev)
    small_params = rwkv_params(small_model, seed=0)
    for state in ("float32", "int8"):
        cache = CacheSpec(dtype="int8") if state == "int8" else None
        engine = ServeEngine(small_model, small_params,
                             ServeConfig(max_batch=4, max_seq=max_seq,
                                         cache=cache))
        reqs = [Request(i, rng.integers(0, small.vocab_size, n).astype(
            np.int32), max_new_tokens=k) for i, (n, k) in enumerate(
            zip((5, 11, 16, 3, 24, 8), (4, 9, 2, 12, 1, 6)))]
        done = engine.serve(reqs)
        bad = [r.rid for r in done if r.output.tolist() != single_stream(
            engine.model, small_params, r.prompt, r.max_new_tokens,
            max_seq)]
        log(f"[rwkv6 serve] reduced rwkv6-3b (bf16, cordic_kernel, {state} "
            f"state): {len(done)} requests through 4 slots, "
            f"{len({t for r in done for t in r.output})} distinct tokens, "
            f"equal to single-stream decode: {not bad}")
        if bad or len(done) != len(reqs):
            raise AssertionError(f"engine differs from single-stream for "
                                 f"{bad}")
    return out


def wkv_bound(r, k, v, w, u, out, extra: int = 0) -> tuple:
    """(bytes ms, operations ms) of one raw wkv call on these tensors:
    each input read once and each output written once (``extra`` bytes of
    int8 state and scales in and out), against the float32 operations of
    WKV_OPS_PER_ELEMENT."""
    moved = sum(t.numel() * t.element_size() for t in (r, k, v, w, u, out))
    bh, t, dk = r.shape
    dv = v.shape[-1]
    ops = bh * t * (WKV_OPS_PER_ELEMENT * dk * dv + 3 * dk + 2 * dv)
    return ((moved + extra) / HBM_BYTES_PER_S * 1e3,
            ops / F32_OPS_PER_S * 1e3)


def flat(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, d) -> the raw (B*H, T, d) layout, contiguous."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def phase_wkv_path(dev, rec: dict, errs: dict) -> dict:
    """wkv and wkv_q8 through their public entry points on the int8 serve's
    recordings; each launch against its plain version, the new int8 state
    against the one the served model wrote, y against the model's own
    recurrence; then kernel, plain version and bound timed on them."""
    layers = sorted(rec["prefill"])
    common.reset_counts()
    calls = []
    for i in layers:
        p, d = rec["prefill"][i], rec["decode"][i]
        q_in, s_in = rec["state_in"][i]
        calls.append(("wkv", i, wkv(p["r"], p["k"], p["v"], p["w"], p["u"])))
        calls.append(("wkv_q8", i, wkv_q8(d["r"], d["k"], d["v"], d["w"],
                                          d["u"], q_in, s_in[..., 0])))
    torch.cuda.synchronize()
    counts = {n: (common.get_kernel(n).launches,
                  common.get_kernel(n).plain_calls)
              for n in ("wkv", "wkv_q8")}
    log(f"[wkv path] wkv on the prefill's (B, T, H, d) = "
        f"{tuple(rec['prefill'][layers[0]]['r'].shape)} and wkv_q8 on the "
        f"decode step's {tuple(rec['decode'][layers[0]]['r'].shape)}, "
        f"layers {layers}: (launches, plain calls) {counts}")
    for n in counts:
        if counts[n] != (len(layers), 0):
            raise AssertionError(f"{n}: expected {len(layers)} launches and "
                                 f"no plain call, got {counts[n]}")
    # M of each call's inputs (y_close), from the plain version
    mags = {}
    with kernel_takes_plain("wkv"), kernel_takes_plain("wkv_q8"):
        for i in layers:
            p, d = rec["prefill"][i], rec["decode"][i]
            q_in, s_in = rec["state_in"][i]
            mags["wkv", i] = wkv_magnitude(wkv, p["r"], p["k"], p["v"],
                                           p["w"], p["u"])
            mags["wkv_q8", i] = wkv_magnitude(wkv_q8, d["r"], d["k"], d["v"],
                                              d["w"], d["u"], q_in,
                                              s_in[..., 0])
    readings = {"wkv": [], "wkv_q8": [], "model": []}
    for name, i, got in calls:
        fn = wkv if name == "wkv" else wkv_q8
        src = rec["prefill" if name == "wkv" else "decode"][i]
        args = (src["r"], src["k"], src["v"], src["w"], src["u"])
        if name == "wkv_q8":
            args += (rec["state_in"][i][0], rec["state_in"][i][1][..., 0])
        mag = mags[name, i]
        with kernel_takes_plain(name):
            want = fn(*args)
        if name == "wkv_q8":
            check_state(got[1:], want[1:], f"served decode, layer {i}")
            # the model's update is libm.fma, which rounds twice where
            # float64 lands on a float32 midpoint (~2**-29 of updates): a
            # tie that moved a word would show here as a mismatch
            q_out, s_out = rec["state_out"][i]
            check_state(got[1:], (q_out, s_out[..., 0]),
                        f"served decode, layer {i}, against the state the "
                        f"model wrote")
            got, want = got[0], want[0]
        y_close(got, want, f"served {name}, layer {i}", errs[name], mag)
        y_close(got, src["out"], f"served {name}, layer {i}, against the "
                f"model's recurrence", [], mag)
        # the same inputs with float32 r, so y comes out in float32
        args32 = (src["r"].float(), *args[1:])
        with kernel_takes_plain(name):
            want32 = fn(*args32)
        got32 = fn(*args32)
        if name == "wkv_q8":
            got32, want32 = got32[0], want32[0]
        readings[name].append(y_close(got32, want32, f"served {name}, layer "
                                      f"{i}, float32 y", errs[name], mag))
        readings["model"].append(y_close(got32, src["out"], f"served {name}, "
                                         f"layer {i}, float32 y, against the "
                                         f"model's recurrence", [], mag))
    ulps = 2 * rec["prefill"][layers[0]]["r"].shape[-1] + 4
    log(f"[wkv path] every launch within the bars of its plain version "
        f"and of the model's own recurrence (state words and scales equal; "
        f"y within {ulps} eps M per output, + rtol 2**-7 for the bfloat16 "
        f"output); wkv_q8's new int8 state equals the served model's.  With "
        f"float32 r (float32 y), largest |y - plain| / (eps M): wkv "
        f"{max(readings['wkv']):.3f}, wkv_q8 {max(readings['wkv_q8']):.3f}; "
        f"against the model's own recurrence {max(readings['model']):.3f}; "
        f"largest |y - plain| {max(errs['wkv'] + errs['wkv_q8']):.4g}, "
        f"max|y| "
        f"{max(rec['prefill'][i]['out'].abs().max().item() for i in layers):.4g}")

    records = {}
    for name in ("wkv", "wkv_q8"):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
        shapes = []
        for i in layers:
            src = rec["prefill" if name == "wkv" else "decode"][i]
            b, t, h, dd = src["r"].shape
            raw = [flat(src[x]) for x in ("r", "k", "v", "w")]
            raw.append(src["u"][None].expand(b, h, dd).reshape(b * h, dd)
                       .contiguous())
            if name == "wkv":
                args, extra = raw, 0
                launch = wkv_kernel.wkv_recurrence_cuda
                plain = wkv_recurrence_ref
            else:
                q_in, s_in = rec["state_in"][i]
                args = raw + [q_in.reshape(b * h, dd, dd),
                              s_in.reshape(b * h, dd)]
                extra = 2 * (q_in.numel() + s_in.numel() * 4)
                launch = wkv_kernel.wkv_recurrence_q8_cuda
                plain = wkv_q8_ref
            ms = time_ms(launch, [args], reps=50)
            dev_ms = device_ms(launch, [args], reps=50,
                               kernel_name="wkv_kernel")
            plain_ms = time_ms(plain, [args], reps=3)
            y = launch(*args)
            t_b, t_o = wkv_bound(*raw, y[0] if name == "wkv_q8" else y, extra)
            bnd, by = larger(t_b, t_o)
            dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
            log(f"  {name} layer {i} (B, T, H, d) = {(b, t, h, dd)}: kernel "
                f"{ms:.4f} ms (device only {dev_txt}), plain {plain_ms:.4f} "
                f"ms, bound {bnd:.6f} ms ({by}), kernel/bound {ms / bnd:.1f}")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes"] += t_b
            tot["ops"] += t_o
            shapes.append((b, t, h, dd))
        bnd, by = larger(tot["bytes"], tot["ops"])
        records[name] = {"launches": counts[name][0], "ms": tot["ms"],
                         "plain_ms": tot["plain_ms"], "bound_ms": bnd,
                         "bound_by": by, "max_abs_err": max(errs[name]),
                         "work": f"the wkv path on rwkv6-3b's served "
                                 f"activations, layers {layers}: {shapes}"}
    # context only: one layer of a 4096-token prompt
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    raw = wkv_inputs(gen, 1, 4096, 40, 64, torch.bfloat16, dev)
    raw = (*raw[:3], raw[3].float(), raw[4])
    ms = time_ms(wkv_kernel.wkv_recurrence_cuda, [raw], reps=3)
    dev_ms = device_ms(wkv_kernel.wkv_recurrence_cuda, [raw], reps=3,
                       kernel_name="wkv_kernel")
    plain_ms = time_ms(wkv_recurrence_ref, [raw], reps=1)
    y = wkv_kernel.wkv_recurrence_cuda(*raw)
    y_close(y, wkv_recurrence_ref(*raw), "long prompt (context)",
            errs["wkv"], wkv_magnitude(wkv_recurrence_ref, *raw))
    bnd, by = larger(*wkv_bound(*raw, y))
    log(f"  [context only, not the served path] wkv on one layer of a "
        f"4096-token prompt, (B, T, H, d) = (1, 4096, 40, 64), bf16 r/k/v: "
        f"kernel {ms:.3f} ms (device only "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'}), plain "
        f"{plain_ms:.1f} ms, bound {bnd:.6f} ms ({by}), kernel/bound "
        f"{ms / bnd:.0f}")
    return records



# ---------------------------------------------------------------------------
# Training: the flash kernels, full-width rwkv6-3b, the wkv backward
# ---------------------------------------------------------------------------

def fresh_process_passes() -> dict:
    """Kernel 6's passes at glm4-9b's bf16 training layout, measured by
    ``repro_torch.launch.flash_probe passes`` in a process of its own
    (the same seeded inputs and :func:`device_per_launch`'s method)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.flash_probe", "passes"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"flash_probe passes failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def device_per_launch(fn, reps: int, names: tuple) -> dict:
    """Mean device ms per launch of each CUDA kernel whose name contains
    one of ``names``, over ``reps`` calls of ``fn``, read from the trace's
    raw device events as :func:`train_profile` reads them (the profiler's
    per-op summary can leave out kernels launched outside torch, as these
    are).  A name with no device event in the trace is left out."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name():
                t, n = sums.get(name, (0, 0))
                sums[name] = (t + e.duration_ns(), n + 1)
    return {name: t / n / 1e6 for name, (t, n) in sums.items()}


# The flash kernels against their plain versions: float32 within atol =
# rtol = 2e-4, the reference's own band for its flash gradient tests
# (tests/test_kernel_grads.py).  A bfloat16 output may also round the
# other way: atol 2e-4 with rtol one bfloat16 step, 2**-7 of the value.
FLASH_TOL = 2e-4
FLASH_BF16_RTOL = 2 ** -7
# (B, S, Hq, Hkv, d, causal): the reference's gradient test shapes
# (tests/test_kernel_grads.py), then d = 64 and 128.
FLASH_CASES = ((2, 64, 4, 4, 16, True), (2, 64, 4, 4, 16, False),
               (1, 64, 8, 2, 16, True), (1, 64, 4, 1, 8, True),
               (2, 40, 4, 2, 8, True), (1, 96, 2, 2, 16, False),
               (1, 96, 8, 2, 64, True), (2, 40, 4, 1, 64, False),
               (1, 96, 4, 2, 128, True), (1, 40, 2, 2, 128, False))
# glm4-9b's attention at train_4k's length: B = 1, S = 4096, 32 q heads,
# 2 kv heads of 128, bfloat16, causal.
GLM4_TRAIN_ATTN = (1, 4096, 32, 2, 128)
# kernel 6's CUDA kernels (flash_bwd.cu): the bf16 planes of float inputs,
# the dQ pass, the dK/dV pass and the sum of its parts; kernel 5's
# (flash_q8.cu): the main kernel and the combine of the key chunks
BWD_PASSES = ("planes_kernel", "dq_kernel", "dkv_kernel", "sum_parts_kernel")
Q8_KERNELS = ("q8_kernel", "q8_decode_kernel", "q8_combine_kernel")
BF16_TC_OPS_PER_S = 989e12    # dense bf16 tensor-core peak
# Full-width rwkv6-3b training: batch 2 x 256 tokens (train_4k's 4096
# cut: the model runs its recurrence one token at a time), AdamW with
# float32 moments, remat on, under CORDIC_EXEC; 3 steps, the second
# recording layers 0 and 31 for the wkv backward path, the last profiled.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 256, 3
TRAIN_LAYERS = (0, 31)
# Reduced models trained on the card against the CPU: float32 sums in
# another order (forward, backward and the Adam update), 3 steps.
TRAIN_LOSS_TOL = 1e-4
# float32 operations of the wkv backward per state element and step:
# recompute k v and the state's multiply-add (3); S dy for dr, A ⊙ S for
# dw, A v for dk, Aᵀ k for dv (2 each); the adjoint's r dy and
# multiply-add (3).
WKV_BWD_OPS_PER_ELEMENT = 14


def flash_inputs(gen, b, s, hq, hkv, d, dtype, dev):
    """q, k, v, dO on the public (B, S, H, d) layout."""
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(q, k) pairs the kernels' top-left causal mask keeps."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def flash_bound(q, k, v, causal: bool, backward: bool) -> tuple:
    """(bytes ms, operations ms) of the forward (q, k, v in; out and lse
    out: 2 matmuls, 4 flops per live pair and channel) or the backward
    (q, k, v, dO, lse, delta in; dq, dk, dv out: Q Kᵀ, dO Vᵀ, dS K, dSᵀ Q
    and Pᵀ dO, 10 flops per live pair and channel), at the bf16
    tensor-core peak."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    io = sum(t.numel() * t.element_size() for t in (q, k, v))
    rows = b * hq * sq * 4                       # one float32 per q row
    if backward:
        moved = io + q.numel() * q.element_size() + 2 * rows + \
            4 * (q.numel() + k.numel() + v.numel())
        flops = 10
    else:
        moved = io + q.numel() * q.element_size() + rows
        flops = 4
    ops = flops * b * hq * live_pairs(sq, sk, causal) * d
    return moved / HBM_BYTES_PER_S * 1e3, ops / BF16_TC_OPS_PER_S * 1e3


def close(got, want, what: str, tol: float, errs: list,
          rtol: Optional[float] = None) -> None:
    """|got - want| <= tol + rtol |want| everywhere (rtol defaults to
    tol)."""
    rtol = tol if rtol is None else rtol
    torch.cuda.synchronize()
    g, w_ = got.float(), want.float()
    if g.shape != w_.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: shape {tuple(g.shape)} or values not "
                             f"finite")
    diff = (g - w_).abs()
    errs.append(diff.max().item())
    bad = int((diff > tol + rtol * w_.abs()).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {g.numel()} beyond atol = "
                             f"{tol:g}, rtol = {rtol:g}; largest |diff| "
                             f"{diff.max().item():.3e}")


def flash_raw_check(q, k, v, do, causal: bool, what: str, errs: dict
                    ) -> None:
    """Kernels 4 and 6 on the raw layout against their plain versions on
    the same inputs (the backward on the plain forward's lse and delta)."""
    group = q.shape[2] // k.shape[2]
    raw = [fa_ops._to_hsd(x) for x in (q, k, v, do)]
    rtol_out = FLASH_TOL if q.dtype == torch.float32 else FLASH_BF16_RTOL
    out, lse = flash_kernel.flash_attention_nhd_cuda(
        *raw[:3], causal=causal, group=group, return_residuals=True)
    w_out, w_lse = flash_fwd_ref(*raw[:3], causal=causal, group=group)
    close(out, w_out, f"flash forward {what}", FLASH_TOL, errs["fwd"],
          rtol=rtol_out)
    close(lse, w_lse, f"flash lse {what}", FLASH_TOL, errs["fwd"])
    delta = (raw[3].float() * w_out.float()).sum(-1)
    got = flash_kernel.flash_attention_bwd_nhd_cuda(
        *raw, w_lse, delta, causal=causal, group=group)
    want = flash_bwd_ref(*raw, w_lse, delta, causal=causal, group=group)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        close(a, b_, f"flash {name} {what}", FLASH_TOL, errs["bwd"])


def flash_grad_check(q, k, v, do, causal: bool, what: str, errs: dict):
    """The ops-level gradient (kernels 4 and 6 through autograd) against
    the exact attention VJP (Sq == Sk: the two causal masks agree)."""
    args = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*args, causal=causal), args, do)
    ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa_ops.exact_attention(*ref, causal=causal),
                               ref, do)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        close(a, b_, f"flash ops gradient {name} {what}", FLASH_TOL,
              errs["grad"])


def phase_flash(dev) -> dict:
    """Kernels 4 and 6: the path at glm4-9b's training layout, then each
    kernel against its plain version, then times."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    b, s, hq, hkv, d = GLM4_TRAIN_ATTN
    q, k, v, do = flash_inputs(gen, b, s, hq, hkv, d, torch.bfloat16, dev)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    common.reset_counts()
    out = flash_attention(*args, causal=True)
    grads = torch.autograd.grad(out, args, do)
    torch.cuda.synchronize()
    counts = {n: (common.get_kernel(n).launches,
                  common.get_kernel(n).plain_calls)
              for n in ("flash_attention", "flash_attention_bwd")}
    log(f"[flash] repro_torch.kernels.flash_attention forward and backward "
        f"at glm4-9b's training layout (B, S, Hq, Hkv, d) = "
        f"{GLM4_TRAIN_ATTN}, bf16, causal: (launches, plain calls) {counts}")
    if any(c != (1, 0) for c in counts.values()):
        raise AssertionError(f"flash path: expected one launch of each "
                             f"kernel and no plain call, got {counts}")
    if not all(torch.isfinite(g.float()).all() for g in (out, *grads)):
        raise AssertionError("flash path: values not finite")
    del out, grads, args

    errs = {"fwd": [], "bwd": [], "grad": []}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            *shape, causal = case
            what = f"{tuple(shape)} causal={causal} {str(dtype)[6:]}"
            x = flash_inputs(gen, *shape, dtype, dev)
            flash_raw_check(*x, causal, what, errs)
            if dtype == torch.float32:
                flash_grad_check(*x, causal, what, errs)
    flash_raw_check(q, k, v, do, True, f"glm4-9b layout {GLM4_TRAIN_ATTN} "
                    f"bf16 causal", errs)
    x32 = [t.float() for t in (q, k, v, do)]
    flash_grad_check(*x32, True, f"glm4-9b layout {GLM4_TRAIN_ATTN} "
                     f"float32 causal", errs)
    del x32
    torch.cuda.empty_cache()
    log(f"[flash] kernels 4 and 6 within atol = rtol = {FLASH_TOL} of their "
        f"plain versions (bf16 outputs: atol {FLASH_TOL}, rtol one bf16 step "
        f"{FLASH_BF16_RTOL}) at "
        f"{len(FLASH_CASES)} shapes x float32/bf16 and glm4-9b's layout, and "
        f"the ops-level gradient within it of the exact attention VJP; "
        f"largest |diff|: forward {max(errs['fwd']):.3e}, backward "
        f"{max(errs['bwd']):.3e}, ops gradient {max(errs['grad']):.3e}")

    group = hq // hkv
    raw = [fa_ops._to_hsd(x) for x in (q, k, v, do)]
    o_raw, lse = flash_kernel.flash_attention_nhd_cuda(
        *raw[:3], group=group, return_residuals=True)
    delta = (raw[3].float() * o_raw.float()).sum(-1)

    def fwd_kernel():
        return flash_kernel.flash_attention_nhd_cuda(
            *raw[:3], group=group, return_residuals=True)

    def bwd_kernel():
        return flash_kernel.flash_attention_bwd_nhd_cuda(
            *raw, lse, delta, group=group)

    def sdpa_fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v)), is_causal=True,
            enable_gqa=True)

    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (lq, lk, lv), dot)

    times = {"fwd": time_ms(lambda: fwd_kernel(), [()], reps=5),
             "bwd": time_ms(lambda: bwd_kernel(), [()], reps=5),
             "plain_fwd": time_ms(lambda: flash_fwd_ref(
                 *raw[:3], group=group), [()], reps=2),
             "plain_bwd": time_ms(lambda: flash_bwd_ref(
                 *raw, lse, delta, group=group), [()], reps=2),
             "sdpa_fwd": time_ms(sdpa_fwd, [()], reps=10),
             "sdpa_fwd_bwd": time_ms(sdpa_fwd_bwd, [()], reps=10)}
    sdpa_bwd = times["sdpa_fwd_bwd"] - times["sdpa_fwd"]
    passes = device_per_launch(bwd_kernel, 3, BWD_PASSES)
    source = "this process"
    if not passes:
        # the trace of this long process held none of them: a fresh one
        passes, source = fresh_process_passes(), "a fresh process"
    plan = flash_kernel.bwd_plan(hq, hkv, s, d, True, True,
                                 flash_kernel._sms(dev.index))
    log(f"  flash_attention_bwd passes at {GLM4_TRAIN_ATTN} bf16 causal "
        f"(torch.profiler device ms a launch, {source}; the dK/dV pass's "
        f"group cut into {plan['nsplit']} parts): "
        + (", ".join(f"{k} {v:.4f}" for k, v in passes.items())
           or "not measured"))
    records = {}
    for name, key, backward, lib in (
            ("flash_attention", "fwd", False, times["sdpa_fwd"]),
            ("flash_attention_bwd", "bwd", True, sdpa_bwd)):
        t_b, t_o = flash_bound(q, k, v, True, backward)
        bnd, by = larger(t_b, t_o)
        log(f"  {name} at {GLM4_TRAIN_ATTN} bf16 causal: kernel "
            f"{times[key]:.3f} ms, plain {times['plain_' + key]:.3f} ms, "
            f"bound {bnd:.4f} ms ({by}), kernel/bound {times[key] / bnd:.1f}; "
            f"library (scaled_dot_product_attention, is_causal, enable_gqa) "
            f"{lib:.3f} ms" + (f" (forward+backward {times['sdpa_fwd_bwd']:.3f}"
                               f" less forward {times['sdpa_fwd']:.3f})"
                               if backward else ""))
        records[name] = {
            "launches": counts[name][0], "ms": times[key],
            "plain_ms": times["plain_" + key], "bound_ms": bnd,
            "bound_by": by, "library_ms": lib,
            "max_abs_err": max(errs["bwd" if backward else "fwd"]),
            **({"device_ms_by_pass": passes, "nsplit": plan["nsplit"]}
               if backward else {}),
            "work": f"glm4-9b's causal attention at train_4k's length, "
                    f"(B, S, Hq, Hkv, d) = {GLM4_TRAIN_ATTN} bf16; library: "
                    f"scaled_dot_product_attention"
                    + (" forward+backward less forward" if backward else "")}
    return records


@contextlib.contextmanager
def record_train_wkv(store: dict, n_layers: int, keep: tuple):
    """During one training step, record for the layers in ``keep`` the
    r, k, v, w, u the model's recurrence takes and the gradient arriving
    at its output (a tensor hook).  Under remat the block's first forward
    builds the graph the backward runs; its recomputation calls the
    recurrence again, after the first ``n_layers`` calls: not recorded."""
    steps = ssm.wkv_steps
    calls = [0]

    def rec_steps(r, k, v, w, u, S):
        out, s_new = steps(r, k, v, w, u, S)
        layer = calls[0]
        calls[0] += 1
        if layer < n_layers and layer in keep and out.requires_grad:
            entry = {"r": r.detach().clone(), "k": k.detach().clone(),
                     "v": v.detach().clone(), "w": w.detach().clone(),
                     "u": u.detach().clone(), "out": out.detach().clone()}
            store[layer] = entry
            out.register_hook(lambda g, e=entry: e.__setitem__(
                "dy", g.detach().clone()))
        return out, s_new

    ssm.wkv_steps = rec_steps
    try:
        yield store
    finally:
        ssm.wkv_steps = steps


def train_profile(prof, wall_ms: float) -> None:
    """Device busy time, idle share and device kernels of one profiled
    training step, read from the trace's raw events (a step launches
    ~10**6 kernels: building the profiler's per-event summary would take
    minutes)."""
    busy_ns, count, by_name = 0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        busy_ns += e.duration_ns()
        count += 1
        t, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (t + e.duration_ns(), n + 1)
    busy = busy_ns / 1e6
    if not busy:
        log("[profile] the trace holds no device time: not measured")
        return
    log(f"[profile] one training step: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, {count} device "
        f"kernels")
    for key, (t, n) in sorted(by_name.items(), key=lambda k: -k[1][0])[:8]:
        log(f"  {t / 1e6:9.2f} ms {t / busy_ns:6.1%} x{n:6d}  {key[:90]}")


def copy_tree(tree, device):
    """A copy of a parameter tree on ``device`` (never sharing storage)."""
    return {k: (copy_tree(v, device) if isinstance(v, dict) else
                v.to(device, copy=True)) for k, v in tree.items()}


def leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key in tree:
            yield from leaf_paths(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def moments_explain_unchanged(p, m, v, step, ocfg) -> bool:
    """Whether a parameter leaf that did not move was left where it was by
    rounding, not by a missing update: its first moment holds a gradient,
    and the last step's AdamW update, recomputed from the final float32
    moments as ``adamw._update_block`` makes it, rounds back to the same
    words in the leaf's dtype."""
    if not bool((m != 0).any()):
        return False
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(stepf, ocfg.beta1), stepf)
    c2 = 1.0 - torch.pow(torch.full_like(stepf, ocfg.beta2), stepf)
    p32 = p.to(torch.float32)
    delta = (m / c1) / (torch.sqrt(v / c2) + ocfg.eps)
    if p.dim() >= 2:
        delta = delta + ocfg.weight_decay * p32
    return torch.equal((p32 - lr_at(ocfg, step) * delta).to(p.dtype), p)


@torch.no_grad()
def check_leaves_moved(before: dict, params, opt, ocfg) -> None:
    """Every parameter leaf moved, compared whole against its copy from
    before the run.  A leaf that did not move passes only where the final
    moments show its last update is below the rounding of its dtype; the
    leaves that take AdamW's block-wise update (>= BLOCK_SCAN_MIN
    elements, three or more axes) must move, and are named."""
    moved, rounded, blockwise = [], [], []
    m_leaves, v_leaves = dict(leaf_paths(opt.m)), dict(leaf_paths(opt.v))
    for path, leaf in leaf_paths(params):
        name = "/".join(map(str, path))
        if leaf.dim() >= 3 and leaf.numel() >= BLOCK_SCAN_MIN:
            blockwise.append(name)
        if not torch.equal(before[path].to(leaf.device), leaf):
            moved.append(name)
        elif name not in blockwise and moments_explain_unchanged(
                leaf, m_leaves[path], v_leaves[path], opt.step, ocfg):
            rounded.append(name)
        else:
            raise AssertionError(
                f"rwkv6 train: parameter leaf {name} {tuple(leaf.shape)} did "
                f"not move" + (" (the block-wise AdamW update)"
                               if name in blockwise else
                               " and its moments do not explain it"))
    if not blockwise:
        raise AssertionError("rwkv6 train: no leaf took the block-wise AdamW "
                             "update")
    log(f"[rwkv6 train] {len(moved)} of {len(before)} parameter leaves moved, "
        f"the block-wise AdamW update's {blockwise} among them; "
        f"{len(rounded)} below the rounding of bf16 in the last step "
        f"(first moment nonzero, update recomputed from the final moments "
        f"rounds to the same words): {rounded}")


def phase_rwkv_train(dev, smi: str) -> dict:
    """Full-width rwkv6-3b trained under CORDIC_EXEC, as
    ``launch/train.py --cordic --batch 2 --seq 256 --steps 4`` builds it;
    then the reduced rwkv6 and glm4 trained on the card against the CPU,
    and a fault_at restart."""
    cfg = get_arch("rwkv6-3b")
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
           cfg.vocab_size, cfg.dtype)
    if got != RWKV_FULL_WIDTH or not cfg.remat:
        raise AssertionError(f"rwkv6-3b is not at full width with remat: "
                             f"{got}, remat={cfg.remat}")
    model = build_model(cfg, dev)
    shape = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 20, 1)),
        log_every=1)
    trainer = Trainer(model, tcfg, stream_for_model(model, shape, seed=0),
                      pol=CORDIC_EXEC)
    before, times, recorded, last = {}, [], {}, {}
    init_state = trainer.init_state

    def init_and_keep(seed=0):
        state = init_state(seed)
        for path, leaf in leaf_paths(state[0]):      # host copies, whole
            before[path] = leaf.to("cpu", copy=True)
        return state

    inner = trainer.step_fn
    acts = [torch.profiler.ProfilerActivity.CUDA]

    def step(*args):
        i = len(times)
        rec = (record_train_wkv(recorded, cfg.n_layers, TRAIN_LAYERS)
               if i == 1 else contextlib.nullcontext())
        prof = (torch.profiler.profile(activities=acts)
                if i == TRAIN_STEPS - 1 else None)
        torch.cuda.synchronize()
        with rec, (prof or contextlib.nullcontext()):
            t0 = time.monotonic()
            out = inner(*args)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        if prof is not None:
            train_profile(prof, times[-1] * 1e3)
        last["opt"] = out[1]
        return out

    trainer.init_state, trainer.step_fn = init_and_keep, step
    torch.cuda.reset_peak_memory_stats()
    common.reset_counts()
    out = trainer.run(TRAIN_STEPS, seed=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    plain = {n: s.plain_calls for n in common.registered_kernels()
             for s in [common.get_kernel(n)] if s.plain_calls}
    launches = {n: s.launches for n in common.registered_kernels()
                for s in [common.get_kernel(n)] if s.launches}
    metrics = trainer.metrics_log
    log(f"[rwkv6 train] full-width rwkv6-3b ({model.n_params():,} params), "
        f"CORDIC_EXEC, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW float32 "
        f"moments, remat: losses "
        f"{[round(m['loss'], 4) for m in metrics]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in metrics]}; kernel launches "
        f"{launches}, plain-version calls {plain}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = times[1:-1] or times[:1]
    log(f"[rwkv6 train] step times (s) {[round(t, 2) for t in times]} (the "
        f"second recording, the last profiled); "
        f"{tokens / (sum(steady) / len(steady)):.1f} tokens/s over the steps "
        f"between the first and the last; peak allocated "
        f"{peak:.2f} GB; {smi}")
    if len(metrics) != TRAIN_STEPS or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in metrics):
        raise AssertionError("rwkv6 train: a loss or grad norm is not finite")
    if plain:
        raise AssertionError(f"rwkv6 train: plain-version calls {plain}")
    check_leaves_moved(before, out["params"], last["opt"], tcfg.optimizer)
    if set(recorded) != set(TRAIN_LAYERS) or not all(
            "dy" in e for e in recorded.values()):
        raise AssertionError(f"rwkv6 train: recorded layers "
                             f"{sorted(recorded)} without their gradients")
    del out, trainer, model, before, last
    torch.cuda.empty_cache()

    # reduced models: the card against the CPU, 3 steps, float32
    small = dataclasses.replace(shape, seq_len=16)
    for arch in ("rwkv6-3b", "glm4-9b"):
        for pol_name, pol in (("float32 matmuls", None),
                              ("CORDIC_EXEC", CORDIC_EXEC)):
            base = get_arch(arch).reduced().scaled(dtype="float32")
            init = build_model(base, "cpu").init(seed=0)
            losses = {}
            for where in ("cpu", dev):
                m = build_model(base, where)
                tr = Trainer(m, TrainConfig(optimizer=AdamWConfig(
                    lr=1e-3, warmup_steps=1, total_steps=3), log_every=1),
                    stream_for_model(m, small, seed=1), pol=pol)
                tr.init_state = (lambda seed=0, m=m, tr=tr: (
                    copy_tree(init, m.device),
                    adamw_init(tr.tcfg.optimizer, copy_tree(init, m.device)),
                    torch.zeros((), device=m.device)))
                losses[str(where)] = [l for _, l in tr.run(3)["losses"]]
            a, b_ = losses["cpu"], losses[str(dev)]
            err = max(abs(x - y) for x, y in zip(a, b_))
            log(f"[train reference] reduced {arch}, {pol_name}: card losses "
                f"{[round(x, 6) for x in b_]}, CPU {[round(x, 6) for x in a]}, "
                f"largest |diff| {err:.2e} (tolerance {TRAIN_LOSS_TOL})")
            if len(a) != 3 or err > TRAIN_LOSS_TOL:
                raise AssertionError(f"reduced {arch} ({pol_name}): card and "
                                     f"CPU losses disagree")

    # fault_at: a restart from the checkpoint of step 1 resumes on the
    # uninterrupted run's losses
    base = get_arch("rwkv6-3b").reduced()
    m = build_model(base, dev)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        def trainer_at(directory):
            return Trainer(m, TrainConfig(
                optimizer=AdamWConfig(warmup_steps=1, total_steps=4),
                log_every=1, ckpt_every=1,
                ckpt_dir=None if directory is None else str(directory)),
                stream_for_model(m, small, seed=2), pol=CORDIC_EXEC)
        whole = dict(trainer_at(None).run(4)["losses"])
        try:
            trainer_at(ckpt_dir).run(4, fault_at=1)
            raise AssertionError("fault_at did not raise")
        except RuntimeError as e:
            if "injected fault" not in str(e):
                raise
        resumed = dict(trainer_at(ckpt_dir).run(4)["losses"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[train reference] reduced rwkv6-3b under CORDIC_EXEC, bf16: fault "
        f"at step 1, resumed losses {resumed} against the uninterrupted "
        f"run's {whole}")
    if sorted(resumed) != [2, 3] or any(resumed[s] != whole[s]
                                        for s in resumed):
        raise AssertionError("the resumed run's losses differ from the "
                             "uninterrupted run's")
    return {"recorded": recorded, "step_s": times, "peak_gb": peak}


def adjoint_magnitude(r, k, v, w, u, dy) -> tuple:
    """M of each gradient output: the plain backward run on |inputs| (w >
    0, so every term adds), the sum of its terms' magnitudes."""
    bt = common.largest_divisor(r.shape[1], wkv_ops.bwd_block_cap(
        r.shape[-1]))
    args = (r.float().abs(), k.float().abs(), v.float().abs(), w.float(),
            u.float().abs())
    _, ckpt = wkv_recurrence_ref(*args, block_t=bt, return_residuals=True)
    return wkv_recurrence_bwd_ref(*args, dy.float().abs(), ckpt, block_t=bt)


def grad_close(got, want, mag, what: str, errs: list) -> float:
    """Within (2 dk + 2 T + 8) eps M per output: each output sums at most
    2 dk products in its own order in each version, and the state and the
    adjoint each carry one rounding per step over T steps; a bfloat16
    gradient may also round the other way (rtol 2**-7).  Returns the
    largest |diff| / (eps M) of a float32 gradient, else 0."""
    torch.cuda.synchronize()
    g, w_ = got.float(), want.float()
    if g.shape != w_.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: shape {tuple(g.shape)} or values not "
                             f"finite")
    diff = (g - w_).abs()
    f32 = got.dtype == torch.float32 and want.dtype == torch.float32
    if f32:
        errs.append(diff.max().item())
    ulps = 2 * mag[0].shape[-1] + 2 * mag[1] + 8
    bar = ulps * F32_EPS * mag[0]
    if not f32:
        bar = bar + 2 ** -7 * w_.abs()
    bad = int((diff > bar).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {g.numel()} beyond {ulps} "
                             f"eps M; largest |diff| {diff.max().item():.3e}")
    if not f32:
        return 0.0
    return (diff / (F32_EPS * mag[0])).nan_to_num(0.0).max().item()


def phase_wkv_bwd_path(dev, rec: dict, wkv_record: dict) -> dict:
    """wkv forward (with checkpoints) and fused backward through
    ``repro_torch.kernels.wkv`` under autograd on the training step's
    recorded tensors; against the plain versions and the model's own
    autograd gradients; times and bounds."""
    layers = sorted(rec)
    common.reset_counts()
    grads = {}
    for i in layers:
        e = rec[i]
        args = [e[x].detach().clone().requires_grad_(True)
                for x in ("r", "k", "v", "w", "u")]
        out = wkv(*args)
        grads[i] = (out.detach(), torch.autograd.grad(out, args, e["dy"]))
    torch.cuda.synchronize()
    counts = {n: (common.get_kernel(n).launches,
                  common.get_kernel(n).plain_calls)
              for n in ("wkv", "wkv_bwd")}
    shape = tuple(rec[layers[0]]["r"].shape)
    log(f"[wkv bwd path] repro_torch.kernels.wkv forward and backward on the "
        f"training step's recorded (B, T, H, d) = {shape}, layers {layers}: "
        f"(launches, plain calls) {counts}")
    if any(c != (len(layers), 0) for c in counts.values()):
        raise AssertionError(f"wkv backward path: expected {len(layers)} "
                             f"launches of each kernel, no plain call")
    errs, readings = [], {"plain": [], "model": []}
    names = ("dr", "dk", "dv", "dw", "du")
    for i in layers:
        e = rec[i]
        b, t, h, d = e["r"].shape
        # the same values in float32, so every gradient comes out in float32
        e32 = {x: e[x].float() for x in ("r", "k", "v", "w", "u")}
        raw = [flat(e32[x]) for x in ("r", "k", "v", "w")]
        raw.append(e32["u"][None].expand(b, h, d).reshape(b * h, d)
                   .contiguous())
        dy = flat(e["dy"])
        bt = common.largest_divisor(t, wkv_ops.bwd_block_cap(d))
        # checkpoints: the kernel's and the plain version's, word for word
        _, ckpt = wkv_kernel.wkv_recurrence_cuda(*raw, block_t=bt,
                                                 return_residuals=True)
        _, w_ckpt = wkv_recurrence_ref(*raw, block_t=bt,
                                       return_residuals=True)
        if not torch.equal(ckpt, w_ckpt):
            raise AssertionError(f"wkv checkpoints, layer {i}: "
                                 f"{int((ckpt != w_ckpt).sum())} words differ")
        got = wkv_kernel.wkv_recurrence_bwd_cuda(*raw, dy, ckpt, block_t=bt)
        want = wkv_recurrence_bwd_ref(*raw, dy, w_ckpt, block_t=bt)
        mags = adjoint_magnitude(*raw, dy)
        for n, a, b_, mg in zip(names, got, want, mags):
            readings["plain"].append(grad_close(
                a, b_, (mg, t), f"wkv {n}, layer {i}, against the plain "
                f"version", errs))
        # the ops gradient against the model's own autograd gradients
        mag_model = [flat_back(mg, b, h) for mg in mags[:4]] + [
            mags[4].reshape(b, h, d).sum(0)]
        args = [e32[x].clone().requires_grad_(True)
                for x in ("r", "k", "v", "w", "u")]
        ops_g = torch.autograd.grad(wkv(*args), args, e["dy"])
        args = [e32[x].clone().requires_grad_(True)
                for x in ("r", "k", "v", "w", "u")]
        with torch.enable_grad():
            out, _ = ssm.wkv_steps(*args, torch.zeros((b, h, d, d),
                                                      device=dev))
            model_g = torch.autograd.grad(out, args, e["dy"])
        for n, a, b_, mg in zip(names, ops_g, model_g, mag_model):
            readings["model"].append(grad_close(
                a, b_, (mg, t), f"wkv {n}, layer {i}, ops gradient against "
                f"the model's own autograd", errs))
        # the path's gradients, in the recorded tensors' dtypes: its output
        # is in r's dtype, so autograd rounded dy to that dtype first
        args = [e32[x].clone().requires_grad_(True)
                for x in ("r", "k", "v", "w", "u")]
        dy_path = e["dy"].to(grads[i][0].dtype).float()
        seen = torch.autograd.grad(wkv(*args), args, dy_path)
        for n, c, a, mg in zip(names, grads[i][1], seen, mag_model):
            grad_close(c, a, (mg, t), f"wkv {n}, layer {i}, the path's "
                       f"{str(c.dtype)[6:]} gradient", errs)
        y_close(grads[i][0], out.detach(), f"layer {i} y against the model's "
                f"recurrence", [], wkv_magnitude(
                    wkv_recurrence_ref, *raw).reshape(b, h, t, d)
                .transpose(1, 2))
    log(f"[wkv bwd path] checkpoints equal to the plain version's; every "
        f"gradient within (2 dk + 2 T + 8) eps M per output of the plain "
        f"adjoint sweep (largest {max(readings['plain']):.2f} eps M) and of "
        f"the model's own autograd gradients (largest "
        f"{max(readings['model']):.2f} eps M), the path's bf16 gradients "
        f"within one bf16 step more; largest |diff| {max(errs):.3e}")

    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    for i in layers:
        e = rec[i]
        b, t, h, d = e["r"].shape
        raw = [flat(e[x]) for x in ("r", "k", "v", "w")]
        raw.append(e["u"][None].expand(b, h, d).reshape(b * h, d)
                   .contiguous())
        dy = flat(e["dy"])
        bt = common.largest_divisor(t, wkv_ops.bwd_block_cap(d))
        _, ckpt = wkv_kernel.wkv_recurrence_cuda(*raw, block_t=bt,
                                                 return_residuals=True)
        ms, plain_ms, t_b, t_o = time_wkv_bwd(raw, dy, ckpt, bt)
        log(f"  wkv_bwd layer {i} (B, T, H, d) = {(b, t, h, d)}, block_t "
            f"{bt}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{max(t_b, t_o):.5f} ms ({'bytes' if t_b >= t_o else 'operations'}"
            f"), kernel/bound {ms / max(t_b, t_o):.1f}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bytes", t_b),
                         ("ops", t_o)):
            tot[key] += val
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    raw = wkv_inputs(gen, 1, 4096, 40, 64, torch.bfloat16, dev)
    raw = (*raw[:3], raw[3].float(), raw[4])
    dy = torch.randn(raw[2].shape, generator=gen, device=dev).to(
        torch.bfloat16)
    bt = common.largest_divisor(4096, wkv_ops.bwd_block_cap(64))
    _, ckpt = wkv_kernel.wkv_recurrence_cuda(*raw, block_t=bt,
                                             return_residuals=True)
    ms, plain_ms, t_b, t_o = time_wkv_bwd(raw, dy, ckpt, bt, plain_reps=1)
    log(f"  [context only, not the training path] wkv_bwd on one layer of a "
        f"4096-token sequence, (B, T, H, d) = (1, 4096, 40, 64): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {max(t_b, t_o):.5f} ms, "
        f"kernel/bound {ms / max(t_b, t_o):.0f}")
    bnd, by = larger(tot["bytes"], tot["ops"])
    wkv_record["work"] += (f"; the wkv backward path (phase 15) launched it "
                           f"{counts['wkv'][0]} more times with checkpoints")
    return {"wkv_bwd": {
        "launches": counts["wkv_bwd"][0], "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": bnd, "bound_by": by,
        "max_abs_err": max(errs), "library_ms": None,
        "work": f"the wkv backward on rwkv6-3b's training step, layers "
                f"{layers}: (B, T, H, d) = {shape}, block_t "
                f"{common.largest_divisor(shape[1], wkv_ops.bwd_block_cap(shape[3]))}"}}


def flat_back(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """The raw (B*H, T, d) layout back to (B, T, H, d)."""
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def wkv_bwd_bound(raw, dy, ckpt) -> tuple:
    """(bytes ms, operations ms) of one wkv backward: r, k, v, w, u, dy
    and the checkpoints read once, dr, dk, dv, dw (float32) and du
    written once; WKV_BWD_OPS_PER_ELEMENT float32 operations per state
    element and step, plus the per-row terms of each step (v·dy, Σ r u k,
    and the u k vdy, r u vdy, r k vdy products and sums)."""
    r = raw[0]
    bh, t, dk = r.shape
    dv = raw[2].shape[-1]
    moved = sum(x.numel() * x.element_size() for x in (*raw, dy, ckpt))
    moved += 4 * (3 * bh * t * dk + bh * t * dv + bh * dk)
    ops = bh * t * (WKV_BWD_OPS_PER_ELEMENT * dk * dv + 12 * dk + 4 * dv)
    return moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def time_wkv_bwd(raw, dy, ckpt, bt, plain_reps: int = 2) -> tuple:
    def kernel():
        return wkv_kernel.wkv_recurrence_bwd_cuda(*raw, dy, ckpt, block_t=bt)

    def plain():
        return wkv_recurrence_bwd_ref(*raw, dy, ckpt, block_t=bt)

    ms = time_ms(kernel, [()], reps=10)
    plain_ms = time_ms(plain, [()], reps=plain_reps)
    return (ms, plain_ms, *wkv_bwd_bound(raw, dy, ckpt))


# ---------------------------------------------------------------------------
# The int8 K/V cache: full-width glm4-9b served with it, and kernel 5
# ---------------------------------------------------------------------------

KV_LAYERS = (0, 39)            # glm4-9b's first and last layers, recorded
# glm4-9b's long-context layout for kernel 5: a causal prefill of 4096
# tokens (B 1), and a decode step of 4 slots over 4096 cached positions.
GLM4_LONG = (4096, 32, 2, 128)  # S, Hq, Hkv, d
LONG_DECODE_ROWS = 4


def state_bytes(state) -> int:
    """Bytes of a decode state's K/V caches and their scales."""
    return sum(t.numel() * t.element_size() for t in (
        state.cache_k, state.cache_v, state.scale_k, state.scale_v)
        if t is not None)


@contextlib.contextmanager
def record_kv(store: dict, n_layers: int, keep: tuple):
    """Keep, for the layers ``keep``, the first prefill's queries and
    int8 K/V words and scales as the engine inserts them into its slots,
    and the first decode step's queries with the caches as that step
    leaves them (its own K/V written) and the slots' positions."""
    attention, decode_attention = A.attention, A.decode_attention
    slot_update = T.slot_update
    calls = {"prefill": 0, "decode": 0}

    def rec_attention(q, k, v, cfg, pol, q_pos, k_pos, window=None):
        layer = calls["prefill"] % n_layers
        calls["prefill"] += 1
        if layer in keep and ("prefill_q", layer) not in store:
            store["prefill_q", layer] = q.detach().clone()
        return attention(q, k, v, cfg, pol, q_pos, k_pos, window)

    def rec_slot_update(state, sub, slots):
        if "prefill_pos" not in store:
            for name in ("cache_k", "cache_v", "scale_k", "scale_v"):
                for layer in keep:
                    store[name, "prefill", layer] = \
                        getattr(sub, name)[layer].clone()
            store["prefill_pos"] = sub.pos.clone()
        return slot_update(state, sub, slots)

    def rec_decode_attention(q, k_new, v_new, cache_k, cache_v, pos, *args):
        ctx = decode_attention(q, k_new, v_new, cache_k, cache_v, pos, *args)
        layer = calls["decode"] % n_layers
        calls["decode"] += 1
        if layer in keep and ("decode_q", layer) not in store:
            store["decode_q", layer] = q.detach().clone()
            for name, t in zip(("cache_k", "cache_v", "scale_k", "scale_v"),
                               (cache_k, cache_v, *args[-2:])):
                store[name, "decode", layer] = t.clone()
            store["decode_pos"] = pos.clone()
        return ctx

    A.attention, A.decode_attention = rec_attention, rec_decode_attention
    T.slot_update = rec_slot_update
    try:
        yield store
    finally:
        A.attention, A.decode_attention = attention, decode_attention
        T.slot_update = slot_update


def phase_int8_serve(dev, smi: str, params, bf16_cache_bytes: int) -> dict:
    """Full-width glm4-9b under cordic_kernel with the int8 K/V cache:
    phase 6's parameters and traffic, ``ServeConfig(cache=CacheSpec(
    dtype="int8"))``; then the reduced model's engine against
    single-stream decode; then a recorded serve for kernel 5."""
    cfg = full_width(ExecutionPolicy(matmul="cordic_kernel"))
    model = build_model(cfg, dev)
    max_seq = 64
    conf = ServeConfig(max_batch=4, max_seq=max_seq,
                       cache=CacheSpec(dtype="int8"))
    engine = ServeEngine(model, params, conf)
    warm, reqs, rng = serve_traffic(cfg.vocab_size)
    engine.serve(warm)
    done, run = timed_serve(engine, reqs, dev)
    launches, plain = run["counts"]["cordic_mac"]
    others = {n: c for n, c in run["counts"].items()
              if n != "cordic_mac" and any(c)}
    forwards = run["prefills"] + run["decode_steps"]
    st = engine._state
    q_bytes = state_bytes(st)
    log(f"[int8 serve] glm4-9b full width, cordic_kernel, CacheSpec(dtype="
        f"'int8'): {len(done)} requests, {run['prefills']} prefill(s), "
        f"{run['decode_steps']} decode steps: cordic_mac launches {launches} "
        f"(= {launches / forwards:.1f} per forward call), plain-version calls "
        f"{plain}, other kernels {others}")
    if launches != LAUNCHES_PER_FORWARD * forwards or plain or others:
        raise AssertionError(f"expected {LAUNCHES_PER_FORWARD} cordic_mac "
                             f"launches per forward call and nothing else")
    if st.cache_k.dtype != torch.int8 or st.scale_k is None:
        raise AssertionError(f"the slot cache is {st.cache_k.dtype}, not int8 "
                             f"with scales")
    log(f"[int8 serve] slot cache: K/V {st.cache_k.dtype} "
        f"{tuple(st.cache_k.shape)} with float32 scales "
        f"{tuple(st.scale_k.shape)}: {q_bytes / 2 ** 20:.2f} MiB against the "
        f"bf16 cache's {bf16_cache_bytes / 2 ** 20:.2f} MiB (phase 6), "
        f"{bf16_cache_bytes / q_bytes:.3f}x smaller")
    log_times("int8 serve", run, smi)
    profile_step(engine.model, params, engine)
    r0 = min(done, key=lambda r: r.rid)
    ref = single_stream(engine.model, params, r0.prompt, r0.max_new_tokens,
                        max_seq)
    log(f"[int8 serve] request {r0.rid}: engine {r0.output.tolist()} "
        f"single-stream {ref}")
    if r0.output.tolist() != ref:
        raise AssertionError("int8 cache: engine differs from single-stream")
    first = {r.rid: r.output.tolist() for r in done}
    del engine
    torch.cuda.empty_cache()
    small = dataclasses.replace(get_arch("glm4-9b").reduced(),
                                exec_policy=ExecutionPolicy(
                                    matmul="cordic_kernel"),
                                cache=CacheSpec(dtype="int8"))
    small_model = build_model(small, dev)
    small_params = small_model.init(seed=0)
    engine = ServeEngine(small_model, small_params,
                         ServeConfig(max_batch=4, max_seq=max_seq))
    small_reqs = [Request(i, rng.integers(0, small.vocab_size, n).astype(
        np.int32), max_new_tokens=k) for i, (n, k) in enumerate(
            zip((5, 11, 16, 3, 24, 8), (4, 9, 2, 12, 1, 6)))]
    small_done = engine.serve(small_reqs)
    bad = [r.rid for r in small_done if r.output.tolist() != single_stream(
        small_model, small_params, r.prompt, r.max_new_tokens, max_seq)]
    log(f"[int8 serve] reduced glm4-9b (bf16, cordic_kernel, int8 K/V "
        f"cache): {len(small_done)} requests through 4 slots, "
        f"{len({t for r in small_done for t in r.output})} distinct tokens, "
        f"equal to single-stream decode: {not bad}")
    if bad or len(small_done) != len(small_reqs):
        raise AssertionError(f"int8 cache engine differs from single-stream "
                             f"for {bad}")
    recorded: dict = {}
    with record_kv(recorded, cfg.n_layers, KV_LAYERS):
        again = ServeEngine(model, params, conf).serve(
            [Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens)
             for r in reqs])
    second = {r.rid: r.output.tolist() for r in again}
    log(f"[int8 serve] a recorded serve on a fresh engine gives the same "
        f"tokens: {second == first}; recorded layers {KV_LAYERS}: prefill "
        f"q {tuple(recorded['prefill_q', KV_LAYERS[0]].shape)}, cache "
        f"{tuple(recorded['cache_k', 'prefill', KV_LAYERS[0]].shape)}, "
        f"lengths {recorded['prefill_pos'].tolist()}; decode q "
        f"{tuple(recorded['decode_q', KV_LAYERS[0]].shape)}, positions "
        f"{recorded['decode_pos'].tolist()}")
    if second != first:
        raise AssertionError("int8 cache serving is not deterministic")
    return {"run": run, "launches": launches, "recorded": recorded}


def q8_bound(q, k, sk_live: list, causal: bool) -> tuple:
    """(bytes ms, operations ms) of kernel 5 on (B, Sq, Hq, d) q over
    (B, Sk, Hkv, d) int8 K/V: q, the words, their float32 scales and the
    output moved once; 4 flops per live (q, k) pair and channel (Q Kᵀ and
    P V) at the bf16 tensor-core peak.  ``sk_live``: each row's keys."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    moved = 2 * q.numel() * q.element_size()
    ops = 0
    for sk in sk_live:
        moved += 2 * hkv * sk * (d + 4)
        ops += 4 * hq * live_pairs(sq, sk, causal) * d
    return moved / HBM_BYTES_PER_S * 1e3, ops / BF16_TC_OPS_PER_S * 1e3


def q8_calls(rec: dict) -> list:
    """Kernel 5's calls on the recorded serve, layer by layer: the prefill
    shape (the 16-token bucket, Sq = Sk, causal) and the decode shape (one
    query per slot over its filled prefix [0, pos], not causal: the
    kernel's mask is aligned top-left, so a causal Sq = 1 query would see
    key 0 only).  Each: (what, q, k, v, k_scale, v_scale, causal)."""
    calls = []
    for layer in KV_LAYERS:
        kv = [rec[name, "prefill", layer] for name in
              ("cache_k", "cache_v", "scale_k", "scale_v")]
        calls.append((f"layer {layer} prefill", rec["prefill_q", layer],
                      *kv[:2], kv[2][..., 0], kv[3][..., 0], True))
        kv = [rec[name, "decode", layer] for name in
              ("cache_k", "cache_v", "scale_k", "scale_v")]
        q = rec["decode_q", layer]
        for b, pos in enumerate(rec["decode_pos"].tolist()):
            n = pos + 1
            calls.append((f"layer {layer} decode slot {b} (Sk {n})",
                          q[b:b + 1], kv[0][b:b + 1, :n], kv[1][b:b + 1, :n],
                          kv[2][b:b + 1, :n, :, 0], kv[3][b:b + 1, :n, :, 0],
                          False))
    return calls


def q8_raw(q, k, v, ks, vs):
    """The (B, S, H, d) frontend's arguments in kernel 5's raw layout."""
    return ([fa_ops._to_hsd(x) for x in (q, k, v)]
            + [fa_ops._to_hs(ks), fa_ops._to_hs(vs)])


def q8_check(q, k, v, ks, vs, causal: bool, what: str, errs: list):
    """Kernel 5 on the raw layout against its plain version."""
    group = q.shape[2] // k.shape[2]
    raw = q8_raw(q, k, v, ks, vs)
    got = flash_kernel.flash_attention_q8_nhd_cuda(*raw, causal=causal,
                                                   group=group)
    want = flash_q8_ref(*raw, causal=causal, group=group)
    rtol = FLASH_TOL if q.dtype == torch.float32 else FLASH_BF16_RTOL
    close(got, want, f"flash_attention_q8 {what}", FLASH_TOL, errs,
          rtol=rtol)


def q8_plan_of(q, k, sms: int) -> dict:
    """Kernel 5's plan for (B, Sq, Hq, d) q over (B, Sk, Hkv, d) words:
    the decode or the prefill kernel, key chunks and the grid the wrapper
    launches."""
    b, sq, hq, _ = q.shape
    hkv = k.shape[2]
    return flash_kernel.q8_plan(b * hkv, sq, k.shape[1], hq // hkv, sms)


def long_q8_inputs(gen, rows: int, sq: int, dtype, dev):
    """q (rows, sq, 32, 128) in ``dtype`` and an int8 K/V cache of 4096
    positions per row (words and squeezed scales) from seeded normals
    through ``quantize_blocked``."""
    s, hq, hkv, d = GLM4_LONG
    q = torch.randn((rows, sq, hq, d), generator=gen, device=dev).to(dtype)
    kv = []
    for _ in range(2):
        w, sc = quantize_blocked(torch.randn((rows, s, hkv, d), generator=gen,
                                             device=dev))
        kv += [w, sc[..., 0]]
    return q, kv[0], kv[2], kv[1], kv[3]


def phase_q8_path(dev, rec: dict) -> dict:
    """Kernel 5 through ``repro_torch.kernels.flash_attention_q8`` on the
    int8 serve's recorded cache, every count set to 0 before and read
    after; then every call against the plain version; then at glm4-9b's
    long-context layout, checked and timed with its bound, the plain
    version and scaled_dot_product_attention on K/V dequantized
    beforehand."""
    calls = q8_calls(rec)
    common.reset_counts()
    outs = [flash_attention_q8(q, k, v, ks, vs, causal=c)
            for _, q, k, v, ks, vs, c in calls]
    torch.cuda.synchronize()
    counts = {n: (common.get_kernel(n).launches,
                  common.get_kernel(n).plain_calls)
              for n in common.registered_kernels()}
    used = {n: c for n, c in counts.items() if any(c)}
    log(f"[q8 path] repro_torch.kernels.flash_attention_q8 on the int8 "
        f"serve's recorded cache, layers {KV_LAYERS}, {len(calls)} calls "
        f"(per layer: the prefill bucket, causal; each slot's decode query "
        f"over its filled prefix, not causal): (launches, plain calls) "
        f"{used}")
    if used != {"flash_attention_q8": (len(calls), 0)}:
        raise AssertionError(f"q8 path: expected {len(calls)} launches of "
                             f"flash_attention_q8 and nothing else, got "
                             f"{used}")
    errs: list = []
    sms = flash_kernel._sms(dev.index)
    for (what, q, k, v, ks, vs, c), out in zip(calls, outs):
        if out.shape != q.shape or not torch.isfinite(out.float()).all():
            raise AssertionError(f"q8 path {what}: shape or values")
        q8_check(q, k, v, ks, vs, c, what, errs)
        log(f"  {what}: kernel 5's plan {q8_plan_of(q, k, sms)}")
    log(f"[q8 path] every call within atol {FLASH_TOL}, rtol one bf16 step "
        f"{FLASH_BF16_RTOL} of its plain version; largest |diff| "
        f"{max(errs):.3e}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    s = GLM4_LONG[0]
    cases = {"prefill": (1, s, True), "decode": (LONG_DECODE_ROWS, 1, False)}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (rows, sq, causal) in cases.items():
            x = long_q8_inputs(gen, rows, sq, dtype, dev)
            q8_check(*x, causal, f"glm4-9b long context {name} "
                     f"{str(dtype)[6:]}", errs)
    log(f"[q8 path] at glm4-9b's long-context layout (S {s}, 32 q / 2 kv "
        f"heads of 128; a causal prefill and a decode of "
        f"{LONG_DECODE_ROWS} rows), float32 and bf16 q, within the same "
        f"bars; largest |diff| so far {max(errs):.3e}")

    timed = {}
    for name, (rows, sq, causal) in cases.items():
        q, k, v, ks, vs = long_q8_inputs(gen, rows, sq, torch.bfloat16, dev)
        group = q.shape[2] // k.shape[2]
        raw = q8_raw(q, k, v, ks, vs)
        # the library's inputs, dequantized to q's dtype beforehand (not
        # timed): scaled_dot_product_attention reads bf16 K/V
        lk, lv = ((w.float() * sc[..., None]).to(q.dtype).transpose(1, 2)
                  for w, sc in ((k, ks), (v, vs)))
        lq = q.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, enable_gqa=True)

        ms = time_ms(lambda: flash_kernel.flash_attention_q8_nhd_cuda(
            *raw, causal=causal, group=group), [()], reps=10)
        plain_ms = time_ms(lambda: flash_q8_ref(
            *raw, causal=causal, group=group), [()], reps=3)
        lib_ms = time_ms(sdpa, [()], reps=10)
        t_b, t_o = q8_bound(q, k, [s] * rows, causal)
        bnd, by = larger(t_b, t_o)
        plan = q8_plan_of(q, k, sms)
        dev_ms = device_per_launch(
            lambda: flash_kernel.flash_attention_q8_nhd_cuda(
                *raw, causal=causal, group=group), 10, Q8_KERNELS)
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                       "bound_by": by, "library_ms": lib_ms,
                       "device_ms_by_kernel": dev_ms, "plan": plan}
        log(f"  flash_attention_q8 {name}: plan {plan}; device ms a launch "
            f"(torch.profiler) "
            + (", ".join(f"{k_} {v_:.4f}" for k_, v_ in dev_ms.items())
               or "not measured"))
        log(f"  flash_attention_q8 {name}: B {rows}, Sq {sq}, Sk {s}, "
            f"(Hq, Hkv, d) = {GLM4_LONG[1:]}, bf16 q, causal={causal}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.5f} "
            f"ms ({by}), kernel/bound {ms / bnd:.1f}; library "
            f"(scaled_dot_product_attention, enable_gqa, on K/V dequantized "
            f"to bf16 beforehand, the dequantize not timed) {lib_ms:.4f} ms")
        del q, k, v, ks, vs, raw, lk, lv, lq
        torch.cuda.empty_cache()
    dec = timed["decode"]
    return {"flash_attention_q8": {
        "launches": counts["flash_attention_q8"][0], **dec,
        "max_abs_err": max(errs),
        "long_prefill": timed["prefill"],
        "work": f"one decode step of {LONG_DECODE_ROWS} slots over a "
                f"{s}-token int8 cache at glm4-9b's layout (Hq, Hkv, d) = "
                f"{GLM4_LONG[1:]}, bf16 q, not causal; launches: the q8 "
                f"path on the int8 serve's recorded layers {KV_LAYERS}; "
                f"library: scaled_dot_product_attention(enable_gqa) on K/V "
                f"dequantized to bf16 beforehand (not timed); long_prefill: "
                f"the causal {s}-token prefill (B 1)"}}


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

    libraries = {"cordic_mac": mac_kernel.library,
                 "cordic_act": act_kernel.library,
                 "cordic_softmax": sm_kernel.library,
                 "wkv": wkv_kernel.library,
                 "wkv_bwd": wkv_kernel.bwd_library,
                 "flash_fwd": flash_kernel.fwd_library,
                 "flash_bwd": flash_kernel.bwd_library,
                 "flash_q8": flash_kernel.q8_library}
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futures = {n: pool.submit(f) for n, f in libraries.items()}
        built = {n: f.result() for n, f in futures.items()}
    log(f"[build] {len(built)} libraries, nvcc in parallel: "
        f"{time.monotonic() - t0:.1f} s")
    for name, lib in built.items():
        log(f"[build] {name}: {lib.path.name} in {lib.seconds:.1f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    def phase(name, fn, *args):
        t0 = time.monotonic()
        res = fn(*args)
        torch.cuda.synchronize()
        log(f"[time] phase {name}: {time.monotonic() - t0:.1f} s")
        return res

    t_kernel = phase("kernel", phase_kernel, dev)
    davinci_errs = phase("davinci", phase_davinci, dev)
    phase("reference", phase_reference, dev)
    phase("cordic_exec reference", phase_cordic_exec_reference, dev)
    served = phase("serve", phase_serve, dev, smi)
    params = served.pop("params")
    exec_served = phase("cordic_exec serve", phase_cordic_exec_serve, dev,
                        smi, params)
    davinci = phase("davinci path", phase_davinci_path, dev,
                    exec_served.pop("captured"), davinci_errs)
    int8_served = phase("int8 serve", phase_int8_serve, dev, smi, params,
                        served["cache_bytes"])
    del params
    torch.cuda.empty_cache()
    q8_records = phase("q8 path", phase_q8_path, dev,
                       int8_served.pop("recorded"))
    torch.cuda.empty_cache()
    wkv_errs = phase("wkv", phase_wkv, dev)
    phase("rwkv6 reference", phase_rwkv_reference, dev)
    rwkv = phase("rwkv6 serve", phase_rwkv_serve, dev, smi)
    wkv_records = phase("wkv path", phase_wkv_path, dev,
                        rwkv.pop("recorded"), wkv_errs)
    torch.cuda.empty_cache()
    flash_records = phase("flash", phase_flash, dev)
    torch.cuda.empty_cache()
    trained = phase("rwkv6 train", phase_rwkv_train, dev, smi)
    bwd_records = phase("wkv backward path", phase_wkv_bwd_path, dev,
                        trained.pop("recorded"), wkv_records["wkv"])

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
        "replaces": spec.replaces,
        "launches": (served["launches"] + int8_served["launches"]
                     + rwkv["launches"]),
        "max_abs_err": t_kernel["max_abs_err"],
        "ms": sum(r["ms"] * r["count"] for r in decode),
        "plain_ms": sum(r["plain_ms"] * r["count"] for r in decode),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "work": f"one decode forward call of glm4-9b: "
                f"{LAUNCHES_PER_FORWARD} launches at M={m}; launches: the "
                f"glm4-9b serves with the bf16 ({served['launches']}) and "
                f"the int8 K/V cache ({int8_served['launches']}) and the "
                f"two rwkv6-3b serves ({rwkv['launches']}, "
                f"{RWKV_LAUNCHES_PER_FORWARD} per forward call)",
    }
    records = [record]
    for name, rec in {**davinci, **wkv_records, **flash_records,
                      **q8_records, **bwd_records}.items():
        spec = common.get_kernel(name)
        records.append({"name": name, "route": "cuda", "source": spec.source,
                        "replaces": spec.replaces, "library_ms": None,
                        **rec})
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
