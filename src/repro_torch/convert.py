"""Carry parameters made as numpy arrays into the port's layout.

The JAX reference's ``Model.init`` returns a nested dict of arrays;
converted leaf by leaf to numpy (``np.asarray``), that tree is what
:func:`params_from_numpy` takes.  The port keeps the reference's layout
(stacked ``layers`` axis, (in, out) weights), so each leaf moves over
bit for bit, bfloat16 included, and is checked against the port's own
declaration of its shape and dtype.  Plain numpy in, tensors out: no
JAX is needed here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.spec import P


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":      # numpy's bfloat16 extension type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device
                      ) -> Dict[str, Any]:
    """The port's parameter tree for ``cfg`` on ``device``, from numpy."""
    device = torch.device(device)

    def walk(spec, leaf, path):
        if isinstance(spec, P):
            t = _tensor(np.asarray(leaf))
            if tuple(t.shape) != spec.shape or t.dtype != spec.dtype:
                raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                                 f"the port declares {spec.shape} "
                                 f"{spec.dtype}")
            return t.to(device)
        if set(spec) != set(leaf):
            raise ValueError(f"{path or 'params'}: keys {sorted(leaf)} differ "
                             f"from the port's {sorted(spec)}")
        return {k: walk(spec[k], leaf[k], f"{path}/{k}") for k in spec}

    return walk(T.params_spec(cfg), tree, "")
