"""Kernel families of the port.  Importing this package registers them."""
from repro_torch.kernels.cordic_mac.ops import cordic_matmul  # noqa: F401
