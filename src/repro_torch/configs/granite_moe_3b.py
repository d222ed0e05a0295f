"""granite-moe-3b-a800m [moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8, moe_d_ff=512, dense_residual=False,
    rope_theta=10000.0, activation="silu",
)
