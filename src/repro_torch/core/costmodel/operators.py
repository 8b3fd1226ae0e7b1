"""Transformer-oriented operator graph, generated from ``ArchConfig``.

This is the piece the paper credits its accuracy to: instead of a single
"model FLOPs" number, every iteration is costed per operator with its own
FLOPs *and* bytes, so MLP tiles are compute-bound while decode attention
is bandwidth-bound within the same iteration (no coarse-grained MLP
approximation).

The same ``ArchConfig`` that builds the real JAX model builds this graph,
so the simulator cannot drift from the runtime.

``BatchMix`` carries the iteration's aggregate workload:
  * ``new_tokens``      — tokens computed this iteration (prefill chunks +
                          one per decode request),
  * ``attn_units``      — Σ (q-token × kv-token) pairs actually attended,
  * ``kv_read_tokens``  — Σ context tokens whose K/V is read,
  * ``n_seqs``          — sequences in the batch,
  * ``enc_tokens``      — encoder tokens (enc-dec archs only).

The port's copy of ``repro.core.costmodel.operators``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Tuple

from repro_torch.configs.base import (ArchConfig, AUDIO, DENSE, ENCDEC, HYBRID,
                                      MOE, SSM, VLM)


def _bucket8(n: int) -> int:
    """Power-of-two padding bucket (>=8) — mirrors the real engine's
    prefill shape bucketing so calibrated backends see the same shapes."""
    return max(8, 1 << (int(n) - 1).bit_length()) if n > 0 else 0


@dataclass(frozen=True)
class BatchMix:
    new_tokens: int = 0
    attn_units: float = 0.0
    kv_read_tokens: float = 0.0
    n_seqs: int = 0
    enc_tokens: int = 0
    padded_tokens: float = 0.0     # Σ bucket(prefill chunk) + decodes

    @staticmethod
    def from_batch(prefill: List[Tuple[int, int]],
                   decode_ctx: List[int],
                   enc_tokens: int = 0) -> "BatchMix":
        """prefill: [(chunk_len, ctx_before)], decode_ctx: [context_len]."""
        new_tokens = sum(c for c, _ in prefill) + len(decode_ctx)
        attn_units = sum(c * (b + (c + 1) / 2.0) for c, b in prefill) \
            + float(sum(decode_ctx))
        kv_read = sum(b + c for c, b in prefill) + float(sum(decode_ctx))
        padded = float(sum(_bucket8(c) for c, _ in prefill)) \
            + len(decode_ctx)
        return BatchMix(new_tokens=new_tokens, attn_units=attn_units,
                        kv_read_tokens=kv_read,
                        n_seqs=len(prefill) + len(decode_ctx),
                        enc_tokens=enc_tokens, padded_tokens=padded)


@dataclass(frozen=True)
class Operator:
    """One op's cost in coefficient form.

    flops(mix) / bytes(mix) are affine in the mix aggregates:
      flops = f_tok*new_tokens + f_attn*attn_units + f_seq*n_seqs + f_enc*enc_tokens
      bytes = b_fixed + b_tok*new_tokens + b_kv*kv_read_tokens + b_seq*n_seqs
              + b_enc*enc_tokens
    b_fixed is the weight traffic (paid once per iteration, batch-amortized).
    """
    name: str
    f_tok: float = 0.0
    f_attn: float = 0.0
    f_seq: float = 0.0
    f_enc: float = 0.0
    b_fixed: float = 0.0
    b_tok: float = 0.0
    b_kv: float = 0.0
    b_seq: float = 0.0
    b_enc: float = 0.0
    count: int = 1          # layers this op repeats over

    def flops(self, m: BatchMix) -> float:
        return self.count * (self.f_tok * m.new_tokens
                             + self.f_attn * m.attn_units
                             + self.f_seq * m.n_seqs
                             + self.f_enc * m.enc_tokens)

    def bytes(self, m: BatchMix) -> float:
        active = (m.new_tokens + m.enc_tokens) > 0
        return self.count * ((self.b_fixed if active else 0.0)
                             + self.b_tok * m.new_tokens
                             + self.b_kv * m.kv_read_tokens
                             + self.b_seq * m.n_seqs
                             + self.b_enc * m.enc_tokens)


@dataclass
class OperatorGraph:
    cfg: ArchConfig
    tp: int
    dtype_bytes: int
    ops: List[Operator] = field(default_factory=list)
    collective_bytes_per_token: float = 0.0   # TP all-reduce traffic
    #: per-layer collective structure (docs/PARALLELISM.md): number of
    #: all-reduces per token-pass and the full activation bytes each one
    #: reduces; the topology-aware backend prices these per ring step
    #: while ``collective_bytes_per_token`` keeps the legacy flat volume
    allreduce_count: int = 0
    allreduce_bytes_per_token: float = 0.0
    #: activation bytes one token carries across a pipeline-stage
    #: boundary (hidden state, d_model * dtype_bytes)
    act_bytes_per_token: float = 0.0

    # ------------------------------------------------------------------
    @staticmethod
    def from_config(cfg: ArchConfig, tp: int = 1,
                    dtype_bytes: int = 2) -> "OperatorGraph":
        g = OperatorGraph(cfg=cfg, tp=tp, dtype_bytes=dtype_bytes)
        d = cfg.d_model
        dt = dtype_bytes
        L = cfg.num_layers

        def linear(name, d_in, d_out, count, tok_attr="tok"):
            w_bytes = d_in * d_out * dt / tp
            op = Operator(
                name=name, count=count,
                **{f"f_{tok_attr}": 2.0 * d_in * d_out / tp},
                b_fixed=w_bytes,
                **({"b_tok": (d_in + d_out) * dt / tp}
                   if tok_attr == "tok" else
                   {"b_enc": (d_in + d_out) * dt / tp}))
            g.ops.append(op)

        def attention(count, n_q, n_kv, hd, tok_attr="tok", self_sq=True):
            """Score + PV flops per attn unit; KV read bytes."""
            # per (q,kv) pair: 2 flops × hd × n_q (QK^T) + same for PV
            f = 4.0 * n_q * hd / tp
            kv_b = 2.0 * n_kv * hd * dt / tp       # K+V read per ctx token
            if self_sq:
                g.ops.append(Operator(name=f"attn_core_x{count}",
                                      count=count, f_attn=f, b_kv=kv_b))
            else:  # encoder self-attention: units = enc_tokens^2 folded
                g.ops.append(Operator(name=f"enc_attn_x{count}", count=count,
                                      f_enc=f * 1.0, b_enc=kv_b))

        hd = cfg.head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads

        if cfg.family in (DENSE, VLM, MOE):
            linear("qkv", d, (nq + 2 * nkv) * hd, L)
            linear("attn_out", nq * hd, d, L)
            attention(L, nq, nkv, hd)
            if cfg.family == MOE:
                m = cfg.moe
                gated = 3 if cfg.act == "silu" else 2
                # router
                linear("router", d, m.num_experts, L)
                # top-k expert FFN: flops scale with top_k; weight bytes
                # stream the touched experts (≈ all of them at batch>=E)
                f_ffn = 2.0 * gated * d * m.d_expert * m.top_k / tp
                w_all = m.num_experts * gated * d * m.d_expert * dt / tp
                g.ops.append(Operator(
                    name="moe_ffn", count=L, f_tok=f_ffn, b_fixed=w_all,
                    b_tok=(gated * m.top_k * (d + m.d_expert)) * dt / tp))
            else:
                gated = 3 if cfg.act == "silu" else 2
                # gate+up fused as one (d -> 2*d_ff) matmul when gated
                linear("mlp_up", d, cfg.d_ff * (2 if gated == 3 else 1), L)
                linear("mlp_down", cfg.d_ff, d, L)
            g.ops.append(Operator(name="norms", count=L, f_tok=8.0 * d,
                                  b_tok=4.0 * d * dt))

        elif cfg.family in (SSM, HYBRID):
            s = cfg.ssm
            d_in = s.d_inner(d)
            nh = s.n_heads(d)
            gn = s.n_groups * s.d_state
            linear("ssm_in_proj", d, 2 * d_in + 2 * gn + nh, L)
            linear("ssm_out_proj", d_in, d, L)
            g.ops.append(Operator(                     # conv + dt + gating
                name="ssm_elementwise", count=L,
                f_tok=2.0 * s.conv_width * (d_in + 2 * gn) + 10.0 * d_in,
                b_tok=4.0 * d_in * dt))
            # SSD core: per token 2*(N*P read+write state) flops ~ 4*H*N*P
            # bytes: fp32 state read+write per seq per iteration (decode)
            state_b = nh * s.d_state * s.head_dim * 4.0
            g.ops.append(Operator(
                name="ssd_core", count=L,
                f_tok=6.0 * nh * s.d_state * s.head_dim / tp,
                b_tok=2.0 * d_in * dt / tp,
                b_seq=2.0 * state_b / tp))
            if cfg.family == HYBRID:
                napp = (cfg.num_layers // cfg.attn_period
                        if cfg.attn_period else 0)
                if napp:
                    linear("shared_qkv", d, (nq + 2 * nkv) * hd, napp)
                    linear("shared_attn_out", nq * hd, d, napp)
                    attention(napp, nq, nkv, hd)
                    gated = 3 if cfg.act == "silu" else 2
                    linear("shared_mlp_up", d,
                           cfg.d_ff * (2 if gated == 3 else 1), napp)
                    linear("shared_mlp_down", cfg.d_ff, d, napp)
            g.ops.append(Operator(name="norms", count=L, f_tok=8.0 * d,
                                  b_tok=4.0 * d * dt))

        elif cfg.family in (ENCDEC, AUDIO):
            Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
            # encoder (runs on enc_tokens)
            linear("enc_qkv", d, (nq + 2 * nkv) * hd, Le, tok_attr="enc")
            linear("enc_out", nq * hd, d, Le, tok_attr="enc")
            g.ops.append(Operator(                      # enc self-attn
                name="enc_attn", count=Le,
                f_enc=4.0 * nq * hd * cfg.enc_seq_len / tp,
                b_enc=2.0 * nkv * hd * dt / tp))
            linear("enc_mlp_up", d, cfg.d_ff, Le, tok_attr="enc")
            linear("enc_mlp_down", cfg.d_ff, d, Le, tok_attr="enc")
            # decoder
            linear("dec_qkv", d, (nq + 2 * nkv) * hd, Ld)
            linear("dec_out", nq * hd, d, Ld)
            attention(Ld, nq, nkv, hd)
            # cross attention reads the fixed encoder KV
            g.ops.append(Operator(
                name="cross_attn", count=Ld,
                f_tok=4.0 * nq * hd * cfg.enc_seq_len / tp,
                b_tok=0.0,
                b_seq=2.0 * nkv * hd * cfg.enc_seq_len * dt / tp))
            linear("dec_mlp_up", d, cfg.d_ff, Ld)
            linear("dec_mlp_down", cfg.d_ff, d, Ld)
            g.ops.append(Operator(name="norms", count=Le + Ld,
                                  f_tok=8.0 * d, b_tok=4.0 * d * dt))
        else:
            raise ValueError(cfg.family)

        # embedding + lm head (all LM families)
        if cfg.vocab_size:
            g.ops.append(Operator(name="embed", count=1,
                                  b_tok=d * dt))
            linear("lm_head", d, cfg.vocab_size, 1)

        # TP all-reduce traffic: 2 per layer (attn out + mlp out),
        # ring: 2*(tp-1)/tp of the activation bytes each.
        g.act_bytes_per_token = float(d * dt)
        if tp > 1:
            g.collective_bytes_per_token = \
                2 * L * 2 * (tp - 1) / tp * d * dt
            g.allreduce_count = 2 * L
            g.allreduce_bytes_per_token = float(d * dt)
        return g

    # ------------------------------------------------------------------
    def split_stages(self, pp: int) -> List["OperatorGraph"]:
        """Partition the graph into ``pp`` pipeline stages
        (docs/PARALLELISM.md).

        Layer-repeated ops (``count > 1``) spread their repeat counts as
        evenly as integer division allows; once-per-model ops pin to the
        pipeline ends (``embed`` on stage 0, the lm head and any other
        singleton on the last stage).  Per-layer collective metadata
        splits proportionally, so each stage's TP all-reduces match its
        layer share.  Invariant (tested): summing any op count, flops or
        bytes over the stages reproduces the unsplit graph exactly.
        """
        if pp <= 1:
            return [self]
        stages = []
        for s in range(pp):
            g = OperatorGraph(cfg=self.cfg, tp=self.tp,
                              dtype_bytes=self.dtype_bytes)
            g.act_bytes_per_token = self.act_bytes_per_token
            for op in self.ops:
                if op.count > 1:
                    c = op.count * (s + 1) // pp - op.count * s // pp
                    if c:
                        g.ops.append(replace(op, count=c))
                elif op.name == "embed":
                    if s == 0:
                        g.ops.append(op)
                elif s == pp - 1:
                    g.ops.append(op)
            if self.allreduce_count:
                n_ar = self.allreduce_count * (s + 1) // pp \
                    - self.allreduce_count * s // pp
                g.allreduce_count = n_ar
                g.allreduce_bytes_per_token = self.allreduce_bytes_per_token
                g.collective_bytes_per_token = \
                    self.collective_bytes_per_token * n_ar \
                    / self.allreduce_count
            elif self.collective_bytes_per_token:
                # hand-built graph carrying only the flat volume: split
                # it evenly so the collective cost survives stage-wise
                # (mirrors the legacy fallback in collective_time)
                g.collective_bytes_per_token = \
                    self.collective_bytes_per_token / pp
            stages.append(g)
        return stages

    # ------------------------------------------------------------------
    def totals(self, m: BatchMix) -> Tuple[float, float]:
        f = sum(op.flops(m) for op in self.ops)
        b = sum(op.bytes(m) for op in self.ops)
        return f, b


# ---------------------------------------------------------------------------
# Derived sizing helpers (shared with mem managers / comm)
# ---------------------------------------------------------------------------
def kv_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2,
                       tp: int = 1) -> float:
    """Bytes of KV cache one context token occupies (per device shard)."""
    if cfg.family == SSM:
        return 0.0                        # constant state, no per-token KV
    if cfg.family == HYBRID:
        napp = cfg.num_layers // cfg.attn_period if cfg.attn_period else 0
        return 2.0 * napp * cfg.n_kv_heads * cfg.head_dim * dtype_bytes / tp
    layers = cfg.n_dec_layers if cfg.family in (ENCDEC, AUDIO) \
        else cfg.num_layers
    return 2.0 * layers * cfg.n_kv_heads * cfg.head_dim * dtype_bytes / tp


def state_bytes_per_seq(cfg: ArchConfig, dtype_bytes: int = 2,
                        tp: int = 1) -> float:
    """Per-request constant state bytes (SSM/hybrid; 0 otherwise)."""
    if cfg.family not in (SSM, HYBRID):
        return 0.0
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    ssd = cfg.num_layers * nh * s.d_state * s.head_dim * 4.0  # fp32
    conv = cfg.num_layers * (s.conv_width - 1) * \
        (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state) * dtype_bytes
    return (ssd + conv) / tp


def param_bytes(cfg: ArchConfig, dtype_bytes: int = 2, tp: int = 1) -> float:
    return cfg.param_count() * dtype_bytes / tp
