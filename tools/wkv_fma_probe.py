#!/usr/bin/env python3
"""Time the wkv kernel's state update two ways on one CUDA card.

    python3 tools/wkv_fma_probe.py

``src/repro_torch/kernels/wkv/csrc/wkv.cu`` updates the state with the
hardware ``fmaf`` (one rounding).  This script builds two copies of that
source: one with that update, one with ``fma_f64``, a float64 product
and sum rounded once more to float32 (as ``libm.fma`` does, and as the
kernel did first; it double-rounds in rare ties).  It runs the int8-state
kernel of both on the same inputs in the order fma_f64, fmaf, fmaf,
fma_f64, and prints, per shape, each variant's device time per launch
(torch.profiler) and CUDA-event time per launch, and how many int8 state
words and scales each leaves different from the plain version
(``wkv_q8_ref``, rounded once).  Shapes: rwkv6-3b's served prefill
(4, 16, 40, 64), its decode step (4, 1, 40, 64), and one layer of a
4096-token prompt (1, 4096, 40, 64); bfloat16 r, k, v, float32 w, u.
The last two lines are nvidia-smi's name and power limit and one JSON
object with the readings.
"""
from __future__ import annotations

import concurrent.futures
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv.ref import wkv_q8_ref  # noqa: E402

UPDATE = re.compile(r"S\[i\] = \w+\(s_w\[i\], S\[i\], kv\);")
KERNEL = "template <int DK, int DV, bool Q8>"
FMA_F64 = """__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

"""
VARIANTS = {"fma_f64": "S[i] = fma_f64(s_w[i], S[i], kv);",
            "fmaf": "S[i] = fmaf(s_w[i], S[i], kv);"}
SHAPES = {"served prefill": ((4, 16, 40, 64), 200),
          "served decode step": ((4, 1, 40, 64), 200),
          "4096-token prompt, one layer": ((1, 4096, 40, 64), 5)}


def build(name: str, update: str) -> common.BuiltLibrary:
    text = wkv_kernel.SOURCE.read_text()
    if len(UPDATE.findall(text)) != 1 or text.count(KERNEL) != 1:
        raise SystemExit("wkv_fma_probe: wkv.cu's state update or kernel "
                         "template is not the one line this probe rewrites")
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = common.BUILD_DIR / f"wkv_probe_{name}.cu"
    src.write_text(UPDATE.sub(update, text.replace(KERNEL, FMA_F64 + KERNEL)))
    return common.load_library(f"wkv_probe_{name}", [src],
                               wkv_kernel.SIGNATURES)


def inputs(gen, shape, dev):
    b, t, h, d = shape
    raw = (b * h, t, d)
    r, k, v = (torch.randn(raw, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    w = torch.rand(raw, generator=gen, device=dev) * 0.7 + 0.3
    u = torch.randn((b * h, d), generator=gen, device=dev)
    s0 = torch.randint(-127, 128, (b * h, d, d), generator=gen, device=dev,
                       dtype=torch.int8)
    sc = torch.rand((b * h, d), generator=gen, device=dev) * 0.1
    return r, k, v, w, u, s0, sc


def run(lib, args, reps: int) -> dict:
    """Time ``reps`` launches of the q8 kernel through ``lib``."""
    wkv_kernel.library = lambda: lib
    fn = wkv_kernel.wkv_recurrence_q8_cuda
    out = fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if "wkv_kernel" in e.key)
    return {"event_ms": start.elapsed_time(stop) / reps,
            "device_ms": dev_us / 1e3 / reps if dev_us > 0 else None,
            "out": out}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wkv_fma_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv),
                                           VARIANTS.items())))
    for name, lib in libs.items():
        regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {lib.seconds:.1f} s; {regs}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    readings = []
    for label, (shape, reps) in SHAPES.items():
        args = inputs(gen, shape, dev)
        _, want_q, want_sc = wkv_q8_ref(*args)
        row = {"input": label, "shape": shape, "reps": reps}
        for name in ("fma_f64", "fmaf", "fmaf", "fma_f64"):
            got = run(libs[name], args, reps)
            q, sc = got.pop("out")[1:]
            rec = row.setdefault(name, {"event_ms": [], "device_ms": []})
            rec["event_ms"].append(got["event_ms"])
            rec["device_ms"].append(got["device_ms"])
            rec["words_unequal"] = int((q != want_q).sum())
            rec["scales_unequal"] = int((sc != want_sc).sum())
        print(f"[probe] {label} {shape}: " + "; ".join(
            f"{n} device {row[n]['device_ms']} ms, event {row[n]['event_ms']}"
            f" ms, words/scales unequal to the plain version "
            f"{row[n]['words_unequal']}/{row[n]['scales_unequal']}"
            for n in VARIANTS), flush=True)
        readings.append(row)
    print(smi)
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
