from repro_torch.configs.base import (ArchConfig, BF16_EXEC, CORDIC_EXEC,  # noqa: F401
                                      CacheSpec, CordicPolicy, ExecutionPolicy,
                                      LM_SHAPES, PruningPolicy, QuantPolicy,
                                      ShapeConfig)
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: F401
