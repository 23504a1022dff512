"""Model configuration (a verbatim copy of ``repro.models.config``).

A single ModelConfig describes dense / MoE / SSM / hybrid decoder-only LMs.
Heterogeneous stacks (Jamba) are expressed with a *period* of ``period``
layer descriptors (mixer kind + FFN kind) repeated ``num_layers // period``
times.  The fields that steer the JAX package's XLA compilation (remat,
chunk sizes, ``unroll_scans``, ``act_shard``) are kept so that a config
converts field for field; the port reads none of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Literal

MixerKind = Literal["attn", "mla", "mamba"]
FFNKind = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads

    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 = full attention (danube: 4096)

    # hybrid layout: attention every `attn_every` layers (Jamba 1:7 => 8,
    # offset 3); attn_every=1 => all-attention; attn_every=0 => attention-free
    attn_every: int = 1
    attn_offset: int = 0

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # decode-time weight absorption: score against the compressed latent
    # directly instead of decompressing K/V for the whole cache each step
    # (EXPERIMENTS.md §Perf, deepseek decode cell)
    mla_absorb: bool = False

    # MoE: FFN is MoE every `moe_every` layers (offset `moe_offset`); 0 = none
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_every: int = 0
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # SSM / Mamba2 (SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256

    # modality frontend stub
    input_mode: str = "tokens"       # tokens | embeds (vlm / audio backbones)

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots | full(no remat)
    logits_fp32: bool = True

    # attention chunking (flash-style jnp path)
    q_chunk: int = 1024
    kv_chunk: int = 1024

    # cost-exact mode: unroll every lax.scan so compiled.cost_analysis()
    # counts all trips (XLA prices a while-loop body ONCE).  Used by the
    # dry-run's second compile; production compiles keep rolled scans.
    unroll_scans: bool = False

    # activation sharding constraints: ("dp-axis-or-tuple", "tp-axis").
    # Empty = let XLA SPMD decide (host tests).  The launcher sets this to
    # (("pod","data"), "model") so attention runs head-sharded with
    # replicated KV instead of XLA's replicated-compute fallback
    # (EXPERIMENTS.md §Perf iteration 1).
    act_shard: tuple = ()
    tp_size: int = 1        # model-axis size, for divisibility guards

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def period(self) -> int:
        p = 1
        if self.attn_every > 1:
            p = math.lcm(p, self.attn_every)
        if self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period == 0, (
            f"{self.name}: num_layers {self.num_layers} % period {self.period}")
        return self.num_layers // self.period

    def mixer_kind(self, layer_idx: int) -> MixerKind:
        if self.attn_every == 0:
            return "mamba"
        if self.attn_every == 1 or layer_idx % self.attn_every == self.attn_offset:
            return "mla" if self.use_mla else "attn"
        return "mamba"

    def ffn_kind(self, layer_idx: int) -> FFNKind:
        if self.d_ff == 0 and self.num_experts == 0:
            return "none"
        if self.num_experts > 0 and (
            self.moe_every == 1 or
            (self.moe_every > 1 and layer_idx % self.moe_every == self.moe_offset)
        ):
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    def layer_program(self) -> list[tuple[MixerKind, FFNKind]]:
        """Descriptors for one period of the stack."""
        return [(self.mixer_kind(i), self.ffn_kind(i)) for i in range(self.period)]

    # -- parameter counting (for 6*N*D roofline accounting) ---------------
    def param_counts(self) -> dict[str, float]:
        D, hd = self.d_model, self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        counts = {"embed": self.vocab_size * D,
                  "head": 0 if self.tie_embeddings else D * self.vocab_size}
        attn = mamba = dense_ffn = moe_ffn = moe_active = 0
        for i in range(self.num_layers):
            mk, fk = self.mixer_kind(i), self.ffn_kind(i)
            if mk == "attn":
                attn += D * H * hd + 2 * D * KV * hd + H * hd * D
            elif mk == "mla":
                qdim = self.qk_nope_dim + self.qk_rope_dim
                attn += (D * H * qdim + D * self.kv_lora_rank + D * self.qk_rope_dim
                         + self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim)
                         + H * self.v_head_dim * D)
            else:
                din, G, N = self.d_inner, self.ssm_groups, self.ssm_state
                zdim = 2 * din + 2 * G * N + self.ssm_heads
                mamba += D * zdim + din * D + (din + 2 * G * N) * self.ssm_conv
            if fk == "dense":
                dense_ffn += 3 * D * self.d_ff
            elif fk == "moe":
                moe_ffn += self.num_experts * 3 * D * self.moe_d_ff
                moe_ffn += self.num_shared_experts * 3 * D * self.moe_d_ff
                moe_ffn += D * self.num_experts
                moe_active += (self.num_experts_per_tok + self.num_shared_experts) \
                    * 3 * D * self.moe_d_ff + D * self.num_experts
        counts.update(attn=attn, mamba=mamba, dense_ffn=dense_ffn, moe_ffn=moe_ffn)
        total = sum(counts.values())
        active = total - moe_ffn + moe_active
        counts["total"] = total
        counts["active"] = active
        return counts

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def cost_exact_variant(self, seq_len: int) -> "ModelConfig":
        """Variant whose compiled cost_analysis is trip-count-exact:
        unrolled scans, one-block attention, coarse SSD chunks."""
        return self.with_(
            unroll_scans=True,
            q_chunk=max(seq_len, 1024),
            kv_chunk=max(seq_len, 1024),
            ssm_chunk=1024 if seq_len >= 4096 else self.ssm_chunk,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the evaluation grid."""
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
