"""internlm2-1.8b — dense decoder with GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family=DENSE,
    num_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="internlm2-1.8b-smoke",
    family=DENSE,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=384,
    norm="rmsnorm",
    act="silu",
)
