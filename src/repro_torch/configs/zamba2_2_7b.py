"""zamba2-2.7b — Mamba2 backbone with shared attention blocks [arXiv:2411.15242].

54 Mamba2 (SSD) layers; every ``attn_period`` layers a *shared* full
transformer block (attention + MLP, weights shared across applications) is
interleaved, following the Zamba2 design. Decode state is O(1) per request
for the SSD layers plus a small KV cache for the shared-attention
applications, so the arch is sub-quadratic and runs ``long_500k``.

The port's copy of ``repro.configs.zamba2_2_7b``, its imports rewritten.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, HYBRID

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    num_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    attn_period=6,          # shared attention applied every 6 SSD layers
    n_shared_attn=1,
    norm="rmsnorm",
    act="silu",
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke",
    family=HYBRID,
    num_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=32, n_groups=1),
    attn_period=2,
    n_shared_attn=1,
    norm="rmsnorm",
    act="silu",
    subquadratic=True,
)
