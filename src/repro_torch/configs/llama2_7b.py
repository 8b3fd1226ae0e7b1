"""llama2-7b — the paper's primary validation model [arXiv:2307.09288].

Not one of the ten assigned archs; included because every TokenSim
validation figure (Figs. 4/5/9/10/11/13/14/15) uses it.
"""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="llama2-7b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="llama2-7b-smoke",
    family=DENSE,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=176,
    vocab_size=256,
    norm="rmsnorm",
    act="silu",
)
