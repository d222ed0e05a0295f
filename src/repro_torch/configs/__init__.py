from repro_torch.configs.base import (ArchConfig, BF16_EXEC, CORDIC_EXEC,  # noqa: F401
                                      CacheSpec, CordicPolicy, ExecutionPolicy,
                                      PruningPolicy, QuantPolicy)
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: F401
