"""granite-moe-3b-a800m — token-choice MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base].

Note: the assignment line lists "MoE 40e top-8" in the config field and
"32 experts" in the trailing comment; we follow the config field (40), which
also matches the released granite-3.0-3b-a800m checkpoint.

The port's copy of ``repro.configs.granite_moe_3b``, its imports rewritten.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MOE

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family=MOE,
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="granite-moe-3b-a800m-smoke",
    family=MOE,
    num_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=384,
    moe=MoEConfig(num_experts=5, top_k=2, d_expert=64),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)
