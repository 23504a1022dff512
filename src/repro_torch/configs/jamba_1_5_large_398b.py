"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887. 72L d8192 64H (GQA kv=8),
Mamba:attn 1:7 interleave (attention at index 4 of each 8-layer period),
MoE 16e top-2 on every other layer."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "jamba-1.5-large-398b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536, head_dim=128,
        attn_every=8, attn_offset=4,
        num_experts=16, num_experts_per_tok=2, moe_d_ff=24576,
        moe_every=2, moe_offset=1,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_groups=8, ssm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, moe_d_ff=128, vocab_size=128, num_experts=4,
        ssm_state=16, ssm_head_dim=16, ssm_groups=2, ssm_chunk=16)
