"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings of shape (batch, frames, d_model) directly to
the encoder. "6L" means 6 encoder + 6 decoder layers (whisper-base).
Decode shapes use decoder self-attention KV of ``seq_len`` plus a fixed
cross-attention KV of ``enc_seq_len``.

The port's copy of ``repro.configs.whisper_base``, its imports rewritten.
"""
from repro_torch.configs.base import ArchConfig, AUDIO

CONFIG = ArchConfig(
    name="whisper-base",
    family=AUDIO,
    num_layers=12,         # 6 enc + 6 dec
    n_enc_layers=6,
    n_dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    enc_seq_len=1500,
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    frontend="embed",
    qkv_bias=True,
    max_seq_len=1_048_576,
)

SMOKE = ArchConfig(
    name="whisper-base-smoke",
    family=AUDIO,
    num_layers=4,
    n_enc_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=384,
    enc_seq_len=32,
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    frontend="embed",
    qkv_bias=True,
    max_seq_len=4096,
)
