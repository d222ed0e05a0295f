"""llava-next-mistral-7b [vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.  Mistral-7B backbone; the anyres-tiling vision frontend is a
STUB — input_specs() provides precomputed patch embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    rope_theta=1000000.0, input_kind="frames", activation="silu",
)
