"""Config system: architecture and execution descriptors.

Every architecture is an :class:`ArchConfig`; the paper's technique
enters through :class:`ExecutionPolicy` (CORDIC matmul path, DA-VINCI
AFs, CAESAR pruning), which every layer consults.  ``CordicPolicy``,
``QuantPolicy`` and ``PruningPolicy`` come from the modules that consume
them (``core/activations``, ``core/quantization``, ``core/pruning``).
:class:`ShapeConfig` and ``LM_SHAPES`` are the reference's input-shape
cells (``train_4k`` is the training launcher's default).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.activations import CordicPolicy
from repro_torch.core.pruning import PruningPolicy
from repro_torch.core.quantization import QuantPolicy


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How linear algebra and AFs execute (the RPE's runtime configuration).

    matmul:
      "bf16"          — plain matmul in the activations' dtype
      "fxp8"          — CORDIC-equivalent int8 quantized path (W8A8)
      "fxp8_weight"   — W8A16 (weight-only)
      "cordic_kernel" — the bit-exact shift-add kernel (``cordic_mac``)
    af: None => exact float AFs;  CordicPolicy => DA-VINCI CORDIC AFs.
    """

    matmul: str = "bf16"
    af: Optional[CordicPolicy] = None
    pruning: Optional[PruningPolicy] = None
    quant: QuantPolicy = QuantPolicy()
    softmax_cordic: bool = False
    moe_pure_dp: bool = False
    fsdp_int8_gather: bool = False


BF16_EXEC = ExecutionPolicy()
# Paper-faithful production policy: FxP8 MACs + CORDIC AFs + 40% pruning.
CORDIC_EXEC = ExecutionPolicy(matmul="fxp8", af=CordicPolicy(bits=16),
                              pruning=PruningPolicy(rate=0.40))


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """The one description of a serving cache's storage format.

      dtype:      "native" (the model compute dtype), "int8" (per-block
                  f32 scales) or "fxp8" (legacy fixed Q3.4 scale).
      block:      scale-block width in trailing channels for ``int8``.
      paged:      slot K/V in a shared block pool behind block tables.
      page_size:  tokens per pool page when ``paged``.

    The port serves the unpaged formats (``native``, ``int8`` and, for
    the dense family's K/V cache, ``fxp8``); paged caches are validated
    here and refused by the model (``models/transformer.check_supported``).
    """

    dtype: str = "native"
    block: Optional[int] = None
    paged: bool = False
    page_size: int = 16

    def __post_init__(self):
        if self.dtype not in ("native", "int8", "fxp8"):
            raise ValueError(
                f"CacheSpec.dtype must be 'native', 'int8' or 'fxp8', "
                f"got {self.dtype!r}")
        if self.block is not None and self.block < 1:
            raise ValueError(f"CacheSpec.block must be >= 1, got "
                             f"{self.block}")
        if self.paged and self.page_size < 1:
            raise ValueError(f"CacheSpec.page_size must be >= 1, got "
                             f"{self.page_size}")
        if self.paged and self.dtype == "fxp8":
            raise ValueError("paged caches support 'native' and 'int8' "
                             "storage; the legacy fixed-scale 'fxp8' "
                             "format is a single-stream study, not a "
                             "serving format")

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture from the assigned pool."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # transformer details
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    activation: str = "silu"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    sliding_window: int = 0
    global_attn_every: int = 0
    # modality stub ("tokens" | "frames")
    input_kind: str = "tokens"
    n_codebooks: int = 0
    # execution
    exec_policy: ExecutionPolicy = BF16_EXEC
    # attention implementation: "auto" | "naive" | "chunked"
    attn_impl: str = "auto"
    attn_chunk: int = 1024
    # serving-cache format: `cache` is the one spelling; the two legacy
    # knobs it unifies still load, and mixing them with `cache` raises
    cache: Optional[CacheSpec] = None
    kv_cache_bits: int = 16
    cache_quant: str = "none"
    fuse_moe_ffn_ar: bool = False
    remat: bool = True
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def cache_spec(self) -> CacheSpec:
        """The resolved serving-cache format (one source of truth)."""
        legacy = []
        if self.kv_cache_bits == 8:
            legacy.append("kv_cache_bits=8")
        elif self.kv_cache_bits != 16:
            raise ValueError(f"kv_cache_bits must be 8 or 16, got "
                             f"{self.kv_cache_bits}")
        if self.cache_quant == "int8":
            legacy.append("cache_quant='int8'")
        elif self.cache_quant != "none":
            raise ValueError(f"unknown cache_quant {self.cache_quant!r}; "
                             f"expected 'none' or 'int8'")
        if self.cache is not None:
            if legacy:
                raise ValueError(
                    f"ArchConfig.cache={self.cache} conflicts with the "
                    f"legacy spelling {' + '.join(legacy)}: the cache "
                    f"format has exactly one spelling")
            return self.cache
        if len(legacy) == 2:
            raise ValueError(
                "cache_quant='int8' and kv_cache_bits=8 are mutually "
                "exclusive KV-cache formats; use cache=CacheSpec(dtype=...)")
        if self.cache_quant == "int8":
            return CacheSpec(dtype="int8")
        if self.kv_cache_bits == 8:
            return CacheSpec(dtype="fxp8")
        return CacheSpec()

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration of the same family (tiny dims)."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=32,
                      capacity_factor=2.0)
        if self.ssm_state:
            kw.update(ssm_state=8)
        if self.n_codebooks:
            kw.update(n_codebooks=2)
        kw["attn_chunk"] = 16
        kw["remat"] = False
        return self.scaled(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the assigned shape set)."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
