"""opt-13b — the paper's secondary model for the disaggregation ratio study
(Fig. 11). Learned positions, LayerNorm, GELU, MHA."""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="opt-13b",
    family=DENSE,
    num_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=20480,
    vocab_size=50272,
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    max_seq_len=2048,
)

SMOKE = ArchConfig(
    name="opt-13b-smoke",
    family=DENSE,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=256,
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    max_seq_len=2048,
)
