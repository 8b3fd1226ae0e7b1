"""qwen2-0.5b — dense decoder, GQA kv=2, QKV bias, tied embeddings
[arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family=DENSE,
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen2-0.5b-smoke",
    family=DENSE,
    num_layers=2,
    d_model=56,
    n_heads=7,
    n_kv_heads=1,
    head_dim=8,
    d_ff=128,
    vocab_size=384,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
)
