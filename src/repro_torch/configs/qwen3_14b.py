"""qwen3-14b — dense decoder with QK-Norm and GQA [hf:Qwen/Qwen3 family]."""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="qwen3-14b",
    family=DENSE,
    num_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke",
    family=DENSE,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)
