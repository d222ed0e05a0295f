"""Kernel families of the port.  Importing this package registers them and
exports their float frontends."""
from repro_torch.kernels.cordic_act.ops import cordic_act  # noqa: F401
from repro_torch.kernels.cordic_mac.ops import cordic_matmul  # noqa: F401
from repro_torch.kernels.cordic_softmax.ops import cordic_softmax  # noqa: F401
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_q8)
from repro_torch.kernels.wkv.ops import wkv, wkv_q8  # noqa: F401
