"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --cordic --batch 2 --seq 256 --steps 4

Runs on the CUDA card unless ``--device cpu``.  ``--reduced`` runs the
smoke-scale config of the same family; without it the full config is
built.  ``--cordic`` switches every matmul and AF onto the paper's FxP8 +
DA-VINCI execution policy.  ``--fault-at N`` injects a crash after step N
to exercise checkpoint/restart: the launcher restores and resumes.
``--grad-compression`` is refused (sharding, ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import CORDIC_EXEC, LM_SHAPES, get_arch
from repro_torch.data.pipeline import stream_for_model
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(LM_SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--cordic", action="store_true",
                    help="paper-faithful FxP8 + DA-VINCI execution")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    shape = LM_SHAPES[args.shape]
    if args.batch or args.seq:
        shape = dataclasses.replace(
            shape, global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len)
    stream = stream_for_model(model, shape, seed=args.seed)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(
            lr=args.lr, total_steps=args.steps,
            warmup_steps=max(args.steps // 20, 1),
            moment_dtype="int8" if args.int8_moments else "float32"),
        grad_accum=args.grad_accum,
        grad_compression=args.grad_compression,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=1)
    pol = CORDIC_EXEC if args.cordic else None
    trainer = Trainer(model, tcfg, stream, pol=pol)
    print(f"# {cfg.name}: {model.n_params():,} params on {model.device}, "
          f"batch {shape.global_batch} x seq {shape.seq_len}, exec="
          f"{'cordic_exec' if pol else cfg.exec_policy.matmul}")
    try:
        out = trainer.run(args.steps, seed=args.seed, fault_at=args.fault_at)
    except RuntimeError as e:
        if "injected fault" in str(e) and args.ckpt_dir:
            print(f"# fault: {e}; restarting from checkpoint")
            trainer = Trainer(model, tcfg, stream, pol=pol)
            out = trainer.run(args.steps, seed=args.seed)
        else:
            raise
    tokens = shape.global_batch * shape.seq_len
    for (step, loss), m in zip(out["losses"], trainer.metrics_log):
        print(f"step {step:5d}  loss {loss:.4f}  grad_norm "
              f"{m['grad_norm']:.4f}")
    steps_run = max(len(trainer.metrics_log), 1)
    print(f"# wall {out['wall_s']:.1f}s  {out['wall_s'] / steps_run:.2f} "
          f"s/step  {tokens * steps_run / out['wall_s']:.1f} tokens/s  "
          f"final loss {out['final_loss']:.4f}")
    if model.device.type == "cuda":
        print(f"# peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              f" GB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
