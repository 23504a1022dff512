"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434. 27L d2048 16H, MLA with
kv_lora_rank=512 (qk_nope 128 / qk_rope 64 / v_head 128), 64 routed experts
top-6 + 2 shared, expert d_ff 1408. (Brief's '160 routed' is the published
model's 64; see DESIGN.md deviations.)"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "deepseek-v2-lite-16b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=0, vocab_size=102400, head_dim=128,
        use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
        moe_d_ff=1408, moe_every=1,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, vocab_size=128,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
        moe_d_ff=64)
