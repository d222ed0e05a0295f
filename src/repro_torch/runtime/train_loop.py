"""Training runtime: the train-step factory and the fault-tolerant
``Trainer``, as the reference's ``repro/runtime/train_loop.py``.

A step: loss (cross entropy) -> gradients by autograd (with
``grad_accum`` micro-batches summed in float32) -> AdamW (optionally int8
moments, pruning masks) -> parameters, updated in place.  The
reference's ``grad_compression`` (error-feedback int8 gradients across
data-parallel replicas) and ``shard_train_state`` belong to the sharding
item of the port (ROADMAP queue 1, item 15); ``TrainConfig`` refuses the
knob by name.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ExecutionPolicy
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    grad_accum: int = 1
    grad_compression: bool = False    # EF-int8 DP compression: not ported
    log_every: int = 10
    ckpt_every: int = 200
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3

    def __post_init__(self):
        if self.grad_compression:
            raise NotImplementedError(
                "TrainConfig.grad_compression (error-feedback int8 gradients "
                "across data-parallel replicas) is not ported yet: it comes "
                "with sharding (ROADMAP queue 1, item 15)")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)
    return build(tree)


def make_train_step(model: Model, tcfg: TrainConfig,
                    pol: Optional[ExecutionPolicy] = None):
    """``step(params, opt_state, resid, batch, masks) -> (params,
    opt_state, resid, metrics)``; ``batch`` holds tensors on the model's
    device.  The parameters and moments are updated in place."""
    ocfg = tcfg.optimizer

    def grads_of(params, batch):
        leaves = _leaves(params)
        args = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(_unflatten(params, args), batch, pol)
            grads = torch.autograd.grad(loss, args)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def step(params, opt_state, resid, batch, masks):
        n = tcfg.grad_accum
        if n > 1:
            # micro-batches along the batch axis; gradients summed in float32
            size = next(iter(batch.values())).shape[0] // n
            gsum, lsum = None, 0.0
            for i in range(n):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                lo, _, g = grads_of(params, mb)
                g = [x.to(torch.float32) for x in g]
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + lo
            grads = [g / n for g in gsum]
            loss = lsum / n
            metrics: Dict[str, Any] = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt_state, om = adamw.update(
            ocfg, _unflatten(params, grads), opt_state, params, masks)
        return params, opt_state, resid, {"loss": loss, **om, **metrics}

    return step


class Trainer:
    """Host-side loop: data, step, checkpointing, failure recovery."""

    def __init__(self, model: Model, tcfg: TrainConfig,
                 stream: SyntheticStream,
                 pol: Optional[ExecutionPolicy] = None, masks=None):
        self.model = model
        self.tcfg = tcfg
        self.stream = stream
        self.pol = pol
        self.masks = masks
        self.step_fn = make_train_step(model, tcfg, pol)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
                     if tcfg.ckpt_dir else None)
        self.metrics_log: List[Dict[str, float]] = []

    def init_state(self, seed: int = 0):
        params = self.model.init(seed)
        opt_state = adamw.init(self.tcfg.optimizer, params)
        resid = torch.zeros((), dtype=torch.float32, device=self.model.device)
        return params, opt_state, resid

    def restore_or_init(self, seed: int = 0):
        params, opt_state, resid = self.init_state(seed)
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore({"params": params, "opt": opt_state,
                                       "resid": resid})
            params, opt_state, resid = (state["params"], state["opt"],
                                        state["resid"])
            start = self.ckpt.metadata()["step"] + 1
        return params, opt_state, resid, start

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        dev = self.model.device
        return {k: torch.from_numpy(np.asarray(v)).to(dev).long()
                if v.dtype.kind in "iu" else torch.from_numpy(v).to(dev)
                for k, v in self.stream.batch_at(step).items()}

    def run(self, steps: int, seed: int = 0,
            fault_at: Optional[int] = None) -> Dict[str, Any]:
        """Train up to step ``steps - 1``, resuming from the latest
        checkpoint if there is one; ``fault_at`` raises after that step
        (after its checkpoint, if it took one) to exercise restart."""
        params, opt_state, resid, start = self.restore_or_init(seed)
        masks = self.masks
        t0 = time.time()
        losses = []
        for step in range(start, steps):
            params, opt_state, resid, m = self.step_fn(
                params, opt_state, resid, self._batch(step), masks)
            if step % self.tcfg.log_every == 0 or step == steps - 1:
                losses.append((step, float(m["loss"])))
            self.metrics_log.append({k: float(v) for k, v in m.items()})
            if self.ckpt and self.tcfg.ckpt_every and \
                    step % self.tcfg.ckpt_every == 0 and step > start:
                self.ckpt.save(step, {"params": params, "opt": opt_state,
                                      "resid": resid})
            if fault_at is not None and step == fault_at:
                if self.ckpt:
                    self.ckpt.wait()
                raise RuntimeError(f"injected fault at step {step}")
        if self.ckpt:
            self.ckpt.save(steps - 1, {"params": params, "opt": opt_state,
                                       "resid": resid})
            self.ckpt.wait()
        return {"losses": losses, "wall_s": time.time() - t0,
                "params": params, "final_loss": losses[-1][1] if losses
                else float("nan")}
