"""Serving launcher: batched requests through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --reduced --requests 8 --max-new 16 --policy cordic_kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --policy cordic_exec --requests 4 --max-new 8 --max-seq 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --policy cordic_kernel --requests 4 --max-new 8 --max-seq 64

``--policy`` picks the execution policy: ``bf16`` (float matmuls),
``cordic_kernel`` (every projection through the cordic_mac kernel) or
``cordic_exec``, the paper's ``CORDIC_EXEC`` (W8A8 matmuls with pow-2
scales, DA-VINCI CORDIC AFs); the config's own policy when omitted.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import CORDIC_EXEC, ExecutionPolicy, get_arch
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve_loop import Request, ServeConfig, ServeEngine

POLICIES = {
    "bf16": ExecutionPolicy(matmul="bf16"),
    "cordic_kernel": ExecutionPolicy(matmul="cordic_kernel"),
    "cordic_exec": CORDIC_EXEC,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default cuda)")
    ap.add_argument("--policy", choices=sorted(POLICIES), default=None,
                    help="execution policy (default: the config's)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.policy is not None:
        cfg = dataclasses.replace(cfg, exec_policy=POLICIES[args.policy])
    model = build_model(cfg, args.device)
    params = model.init(args.seed)
    engine = ServeEngine(model, params, ServeConfig(
        max_batch=args.max_batch, max_seq=args.max_seq))
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        n = int(rng.integers(4, 24))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        reqs.append(Request(i, prompt, max_new_tokens=args.max_new))
    t0 = time.time()
    done = engine.serve(reqs)
    dt = time.time() - t0
    for r in done:
        print(f"req {r.rid}: prompt {len(r.prompt)} toks -> "
              f"{r.output[:8].tolist()}{'...' if len(r.output) > 8 else ''} "
              f"({(r.done_at - r.submitted_at) * 1e3:.0f} ms)")
    tput = sum(len(r.output) for r in done) / dt
    print(f"# {engine.metrics['prefill_tokens']} prefill toks, "
          f"{engine.metrics['decode_tokens']} decode toks, "
          f"{tput:.1f} tok/s on {args.device}")
    print(f"# queue wait {engine.metrics['queue_wait_s'] * 1e3:.0f}ms, "
          f"slot occupancy {engine.metrics['slot_occupancy']:.0%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
