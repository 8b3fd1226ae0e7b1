"""stablelm-3b — dense decoder [hf:stabilityai/stablelm-2-1_6b family].

MHA (kv == q heads), LayerNorm (StableLM-2 keeps LayerNorm), SwiGLU MLP.
"""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="stablelm-3b",
    family=DENSE,
    num_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    act="silu",
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="stablelm-3b-smoke",
    family=DENSE,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=384,
    norm="layernorm",
    act="silu",
)
