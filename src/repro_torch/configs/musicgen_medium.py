"""musicgen-medium [audio] 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048.  Decoder-only over EnCodec tokens; the EnCodec frontend is a
STUB — input_specs() provides precomputed frame embeddings.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    n_codebooks=4, input_kind="frames", activation="gelu",
)
