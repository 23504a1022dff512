"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.
88L d12288 96H (GQA kv=8) d_ff 28672 vocab 32768."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mistral-large-123b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=28672, vocab_size=32768, head_dim=128,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128)
