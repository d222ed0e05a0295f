"""Model facade: one object per architecture tying config -> functions."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, CacheSpec, ExecutionPolicy
from repro_torch.models import spec as pspec
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class DenseCacheOps:
    """Per-slot state in the classic unpaged layout: ``max_seq``-long K/V
    caches (dense; native, int8 or fxp8) or the O(1) recurrent state
    (ssm; native or int8)."""
    cfg: ArchConfig
    device: torch.device

    def init_slot_state(self, max_batch: int, max_seq: int) -> T.DecodeState:
        return T.init_slot_state(self.cfg, max_batch, max_seq, self.device)

    def slot_update(self, state, sub, slots) -> T.DecodeState:
        return T.slot_update(state, sub, slots)


@dataclasses.dataclass(frozen=True)
class Model:
    """An architecture on a device.  ``device`` defaults to ``cuda``."""
    cfg: ArchConfig
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        T.check_supported(self.cfg)
        object.__setattr__(self, "device", torch.device(self.device))

    # -- parameters ---------------------------------------------------------
    def params_spec(self):
        return T.params_spec(self.cfg)

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters on the model's device, drawn leaf by leaf from
        a ``torch.Generator`` seeded with ``seed``."""
        return pspec.materialize(self.params_spec(), seed, self.device)

    def n_params(self) -> int:
        return pspec.n_params(self.params_spec())

    # -- cache format --------------------------------------------------------
    def with_cache_dtype(self, cache_dtype) -> "Model":
        """Same architecture with the serving-cache storage format swapped.

        Accepts a :class:`CacheSpec` or the legacy string spelling:
        ``"int8"`` turns on the per-block-scaled quantized K/V cache or
        recurrent state (:mod:`repro_torch.core.quant_cache`); ``None`` or
        a float name keeps full precision.  Parameters are unchanged; only
        the decode state's layout and its read and write paths differ.
        Formats the port does not run yet (paged) raise when the new model
        is built.
        """
        if isinstance(cache_dtype, CacheSpec):
            return self.with_cache_spec(cache_dtype)
        if cache_dtype in (None, "none", "float", "fp32", "fp16", "bf16"):
            return self
        if cache_dtype == "int8":
            if self.cfg.cache_quant == "int8":
                return self
            return Model(dataclasses.replace(self.cfg, cache_quant="int8"),
                         self.device)
        raise ValueError(f"unknown cache_dtype {cache_dtype!r}; expected "
                         f"a CacheSpec, 'int8', a float dtype name, or None")

    def with_cache_spec(self, spec: CacheSpec) -> "Model":
        """Same architecture with ``cfg.cache`` pinned to ``spec`` (the
        legacy ``kv_cache_bits``/``cache_quant`` knobs cleared)."""
        if self.cfg.cache == spec:
            return self
        return Model(dataclasses.replace(self.cfg, cache=spec,
                                         kv_cache_bits=16,
                                         cache_quant="none"), self.device)

    def cache_ops(self) -> DenseCacheOps:
        return DenseCacheOps(self.cfg, self.device)

    # -- compute ------------------------------------------------------------
    def forward(self, params, batch, pol: Optional[ExecutionPolicy] = None):
        return T.forward(params, batch, self.cfg, pol)

    def loss(self, params, batch, pol: Optional[ExecutionPolicy] = None):
        """(loss, metrics) of a training batch; differentiable."""
        return T.loss_fn(params, batch, self.cfg, pol)

    def prefill(self, params, batch, pol: Optional[ExecutionPolicy] = None,
                headroom: int = 64, lengths=None):
        return T.prefill(params, batch, self.cfg, pol, headroom=headroom,
                         lengths=lengths)

    def decode_step(self, params, state, batch,
                    pol: Optional[ExecutionPolicy] = None):
        return T.decode_step(params, state, batch, self.cfg, pol)

    # -- serving slots (continuous batching) --------------------------------
    def init_slot_state(self, max_batch: int, max_seq: int) -> T.DecodeState:
        return T.init_slot_state(self.cfg, max_batch, max_seq, self.device)

    def slot_update(self, state, sub, slots) -> T.DecodeState:
        return T.slot_update(state, sub, slots)


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for the CPU).  Families other than dense and ssm raise."""
    return Model(cfg, torch.device(device))
