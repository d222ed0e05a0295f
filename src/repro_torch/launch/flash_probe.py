"""Probe kernels 5 and 6 (``flash_attention_q8``, ``flash_attention_bwd``)
on one card at glm4-9b's layouts: build them, print ptxas' register
report, hold them to their plain versions, time them by CUDA events and
by torch.profiler's device time per CUDA kernel, beside SDPA.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe \
        [bwd|q8|decode|sweep|passes|all]

``bwd``: kernel 6 at the training layout (1, 4096, 32/2 heads of 128,
causal), bf16 and float32 inputs; ``q8``: kernel 5 at the 4-slot decode
over 4096 int8 positions and the causal 4096-token prefill, bf16 and
float32 q; ``decode``: the decode alone, with the wrapper's host time a
call and SDPA's device time; ``sweep``: the decode's device time as the
plan's ``BLOCKS_PER_SM`` (the key chunks) varies; ``passes``: kernel 6's
passes at the training layout, bf16, by device time a launch, as one
JSON line (``chip_smoke.py`` phase 13 reads it).  Needs a CUDA card;
``chip_smoke.py`` is the full check.
"""
import json
import subprocess
import sys
import time

import torch

from repro_torch.core.quant_cache import quantize_blocked
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref,
                                                     flash_q8_ref)

HQ, HKV, S, D = 32, 2, 4096, 128
TOL = 2e-4


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int) -> dict:
    """Device ms a launch by CUDA kernel, from torch.profiler: each
    kernel's device time over the launches the trace holds (the rows of
    the ``aten::`` ops that launched them left out)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / e.count
            for e in prof.key_averages() if e.device_time_total > 0
            and e.count and not e.key.startswith("aten::")
            and "Buffer" not in e.key}


def per_launch(fn, reps: int, names) -> dict:
    """Device ms per launch of each CUDA kernel whose name contains one of
    ``names``, from the trace's raw device events."""
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
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in e.name():
                    t, n = sums.get(name, (0, 0))
                    sums[name] = (t + e.duration_ns(), n + 1)
    return {name: t / n / 1e6 for name, (t, n) in sums.items()}


def worst(got, want, rtol: float) -> str:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bad = int((d > TOL + rtol * w.abs()).sum())
    return f"largest |diff| {d.max().item():.3e}, {bad} beyond the bar"


def probe_bwd(dev, gen) -> None:
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((HQ, S, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((HKV, S, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        do = torch.randn((HQ, S, D), generator=gen, device=dev).to(dt)
        out, lse = flash_fwd_ref(q, k, v, causal=True, group=HQ // HKV)
        delta = (do.float() * out.float()).sum(-1)

        def run():
            return K.flash_attention_bwd_nhd_cuda(q, k, v, do, lse, delta,
                                                  causal=True,
                                                  group=HQ // HKV)
        want = flash_bwd_ref(q, k, v, do, lse, delta, causal=True,
                             group=HQ // HKV)
        for name, a, b in zip(("dq", "dk", "dv"), run(), want):
            print(f"kernel 6 {dt} {name}: {worst(a, b, TOL)}")
        del want
        print(f"kernel 6 {dt}: {events_ms(run, 5):.3f} ms (events)")
        for key, ms in device_ms(run, 3).items():
            print(f"   {key}: {ms:.4f} ms")


def q8_inputs(dev, gen, rows: int, sq: int, dt):
    q = torch.randn((rows * HQ, sq, D), generator=gen, device=dev).to(dt)
    kv = []
    for _ in range(2):
        w, sc = quantize_blocked(torch.randn((rows * HKV, S, D),
                                             generator=gen, device=dev))
        kv += [w, sc[..., 0].contiguous()]
    return q, kv[0], kv[2], kv[1], kv[3]


def probe_q8(dev, gen, cases) -> None:
    sms = K._sms(dev.index)
    for dt in (torch.bfloat16, torch.float32):
        for name, rows, sq, causal in cases:
            x = q8_inputs(dev, gen, rows, sq, dt)

            def run():
                return K.flash_attention_q8_nhd_cuda(*x, causal=causal,
                                                     group=HQ // HKV)
            want = flash_q8_ref(*x, causal=causal, group=HQ // HKV)
            rtol = TOL if dt == torch.float32 else 2 ** -7
            plan = K.q8_plan(rows * HKV, sq, S, HQ // HKV, sms)
            print(f"kernel 5 {name} {dt}: {worst(run(), want, rtol)}; "
                  f"plan {plan}")
            plain = events_ms(lambda: flash_q8_ref(
                *x, causal=causal, group=HQ // HKV), 3)
            print(f"kernel 5 {name} {dt}: {events_ms(run, 20):.4f} ms "
                  f"(events), plain {plain:.4f} ms")
            for key, ms in device_ms(run, 20).items():
                print(f"   {key}: {ms * 1e3:.2f} us")
            if dt != torch.bfloat16 or name != "decode":
                continue
            t0 = time.perf_counter()
            for _ in range(200):
                run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            print(f"   wrapper host time {(t1 - t0) / 200 * 1e6:.1f} us a "
                  f"call")
            lq = x[0].reshape(rows, HQ, sq, D)
            lk, lv = ((w.float() * sc[..., None]).to(dt).reshape(
                rows, HKV, S, D) for w, sc in ((x[1], x[3]), (x[2], x[4])))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    lq, lk, lv, enable_gqa=True)
            print(f"   SDPA {events_ms(sdpa, 50):.4f} ms (events), device "
                  f"{sum(device_ms(sdpa, 20).values()) * 1e3:.2f} us")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: needs a CUDA card")
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    if what == "passes":
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        q = torch.randn((HQ, S, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((HKV, S, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        do = torch.randn((HQ, S, D), generator=gen, device=dev).bfloat16()
        out, lse = flash_fwd_ref(q, k, v, causal=True, group=HQ // HKV)
        delta = (do.float() * out.float()).sum(-1)
        print(json.dumps(per_launch(
            lambda: K.flash_attention_bwd_nhd_cuda(
                q, k, v, do, lse, delta, causal=True, group=HQ // HKV), 3,
            ("planes_kernel", "dq_kernel", "dkv_kernel",
             "sum_parts_kernel"))))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for lib in (K.bwd_library(), K.q8_library()):
        print(f"{lib.path.name}: built in {lib.seconds:.1f} s")
        print("\n".join(ln for ln in lib.log.splitlines()
                        if "registers" in ln or "spill" in ln))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if what in ("bwd", "all"):
        probe_bwd(dev, gen)
    if what in ("q8", "all"):
        probe_q8(dev, gen, (("decode", 4, 1, False),
                            ("prefill", 1, S, True)))
    if what == "decode":
        probe_q8(dev, gen, (("decode", 4, 1, False),))
    if what == "sweep":
        x = q8_inputs(dev, gen, 4, 1, torch.bfloat16)
        for per_sm in (1, 2, 4, 8, 16):
            K.BLOCKS_PER_SM = per_sm
            plan = K.q8_plan(4 * HKV, 1, S, HQ // HKV, K._sms(dev.index))
            times = device_ms(lambda: K.flash_attention_q8_nhd_cuda(
                *x, causal=False, group=HQ // HKV), 20)
            print(f"BLOCKS_PER_SM {per_sm}: plan {plan}; device "
                  + ", ".join(f"{k[:40]} {v * 1e3:.2f} us"
                              for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
