"""granite-moe-1b-a400m — token-choice MoE, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

The port's copy of ``repro.configs.granite_moe_1b``, its imports rewritten.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MOE

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family=MOE,
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                 # per-expert hidden (mirrored in moe.d_expert)
    vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke",
    family=MOE,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=384,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)
