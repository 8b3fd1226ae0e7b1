"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMConfig, SSM

CONFIG = ArchConfig(
    name="mamba2-130m",
    family=SSM,
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="mamba2-130m-smoke",
    family=SSM,
    num_layers=2,
    d_model=64,
    d_ff=0,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=32, n_groups=1),
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    subquadratic=True,
)
