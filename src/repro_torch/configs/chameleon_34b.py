"""chameleon-34b — early-fusion token-based VLM backbone [arXiv:2405.09818].

Images are VQ-tokenized into the same vocabulary (65536 ids include the
image codebook); the backbone is a llama-style decoder with QK-Norm (which
Chameleon introduced for logit-drift stability). The VQ tokenizer itself is
a stub per the assignment: ``input_specs()`` provides token ids.
"""
from repro_torch.configs.base import ArchConfig, VLM

CONFIG = ArchConfig(
    name="chameleon-34b",
    family=VLM,
    num_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="chameleon-34b-smoke",
    family=VLM,
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=176,
    vocab_size=512,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
)
