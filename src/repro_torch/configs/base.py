"""Architecture configuration: the port's copy of ``repro.configs.base``.

One ``ArchConfig`` describes the model that ``repro_torch.models.model_zoo``
builds.  Configs are frozen dataclasses, so they are hashable and a
``Model`` holding one can key a cache.  The workload shapes of the
reference module (``ShapeSpec``, ``LM_SHAPES``) belong to the dry run and
are not part of the port yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"
VLM = "vlm"
AUDIO = "audio"

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM, AUDIO)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (granite-style token-choice top-k)."""

    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    jitter_eps: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD sub-config (arXiv:2405.21060)."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1                 # B/C groups (GVA); 1 == multi-value attn

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description."""

    name: str
    family: str

    # Transformer trunk (decoder unless stated otherwise).
    num_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # Attention details.
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"             # rope | learned | sinusoidal | none

    # Block details.
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu (-> SwiGLU MLP) | gelu (-> plain MLP)
    tie_embeddings: bool = False
    mlp_bias: bool = False

    # Sub-family configs.
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # Hybrid (zamba2-style): `attn_period` SSM layers share one attention
    # block; n_shared_attn distinct shared blocks round-robined.
    attn_period: int = 0
    n_shared_attn: int = 1

    # Encoder/decoder (whisper-style).
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_seq_len: int = 0              # fixed encoder length for enc-dec decode shapes

    # Modality frontend stub: "none" (token ids) | "embed" (precomputed
    # frame/patch embeddings are the input).
    frontend: str = "none"

    # Limits / numerics.
    max_seq_len: int = 1_048_576
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # Is decode (autoregressive serve_step) defined for this arch?
    # (encoder-only archs would set False; all assigned archs decode.)
    supports_decode: bool = True
    # Sub-quadratic decode state => long_500k applies.
    subquadratic: bool = False

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def gqa_group(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (logical, unpadded) -------------------------
    def param_count(self) -> int:
        """Logical parameter count (no TP padding)."""
        d = self.d_model
        embed = self.vocab_size * d
        unembed = 0 if self.tie_embeddings else self.vocab_size * d
        if self.frontend == "embed" and self.family == AUDIO:
            embed = 0  # encoder input is an embedding stub

        def attn_params(n_heads, n_kv, head_dim, bias):
            p = d * n_heads * head_dim + 2 * d * n_kv * head_dim \
                + n_heads * head_dim * d
            if bias:
                p += (n_heads + 2 * n_kv) * head_dim
            return p

        def mlp_params(d_ff, gated):
            return d * d_ff * (3 if gated else 2)

        gated = self.act == "silu"
        layers = 0
        if self.family in (DENSE, VLM):
            per = attn_params(self.n_heads, self.n_kv_heads, self.head_dim,
                              self.qkv_bias) + mlp_params(self.d_ff, gated)
            layers = self.num_layers * (per + 2 * d)
        elif self.family == MOE:
            m = self.moe
            per = attn_params(self.n_heads, self.n_kv_heads, self.head_dim,
                              self.qkv_bias)
            per += m.num_experts * self.d_model * m.d_expert * (3 if gated else 2)
            per += d * m.num_experts  # router
            layers = self.num_layers * (per + 2 * d)
        elif self.family in (SSM, HYBRID):
            s = self.ssm
            d_in = s.d_inner(d)
            nheads = s.n_heads(d)
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            per = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
            per += conv_dim * s.conv_width                              # conv1d
            per += nheads * 2                                           # A_log, D
            per += d_in                                                 # dt_bias lives in nheads; norm gate
            per += d_in * d                                             # out_proj
            per += d                                                    # norm
            layers = self.num_layers * per
            if self.family == HYBRID:
                shared = attn_params(self.n_heads, self.n_kv_heads,
                                     self.head_dim, self.qkv_bias)
                shared += mlp_params(self.d_ff, gated) + 2 * d
                layers += self.n_shared_attn * shared
        elif self.family in (ENCDEC, AUDIO):
            enc = self.n_enc_layers * (
                attn_params(self.n_heads, self.n_kv_heads, self.head_dim, True)
                + mlp_params(self.d_ff, False) + 2 * d)
            dec = self.n_dec_layers * (
                2 * attn_params(self.n_heads, self.n_kv_heads, self.head_dim,
                                True)
                + mlp_params(self.d_ff, False) + 3 * d)
            layers = enc + dec
        return embed + unembed + layers + d  # + final norm

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.family != MOE:
            return self.param_count()
        m = self.moe
        gated = self.act == "silu"
        inactive = self.num_layers * (m.num_experts - m.top_k) * \
            self.d_model * m.d_expert * (3 if gated else 2)
        return self.param_count() - inactive


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult
