"""Model facade: one object per architecture tying config -> functions."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ExecutionPolicy
from repro_torch.models import spec as pspec
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class DenseCacheOps:
    """Per-slot ``max_seq``-long caches (the classic layout)."""
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

    def cache_ops(self) -> DenseCacheOps:
        return DenseCacheOps(self.cfg, self.device)

    # -- compute ------------------------------------------------------------
    def forward(self, params, batch, pol: Optional[ExecutionPolicy] = None):
        return T.forward(params, batch, self.cfg, pol)

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
    asks for the CPU).  Families other than dense raise."""
    return Model(cfg, torch.device(device))
