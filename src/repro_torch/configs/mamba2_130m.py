"""mamba2-130m [ssm] — SSD, arXiv:2405.21060. 24L d768 attention-free,
vocab 50280, ssm_state=128."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mamba2-130m"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=0, vocab_size=50280,
        attn_every=0,                      # attention-free
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_groups=1, ssm_chunk=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, vocab_size=128,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
