"""dbrx-132b [moe] — hf:databricks/dbrx-base. 40L d6144 48H (GQA kv=8),
16 experts top-4, expert d_ff 10752, vocab 100352."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "dbrx-132b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=0, vocab_size=100352, head_dim=128,
        num_experts=16, num_experts_per_tok=4, moe_d_ff=10752, moe_every=1,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=128, num_experts=4, num_experts_per_tok=2, moe_d_ff=64)
