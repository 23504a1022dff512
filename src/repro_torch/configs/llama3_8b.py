"""llama3-8b [dense] — arXiv:2407.21783. 32L d4096 32H (GQA kv=8)
d_ff 14336, 128k vocab, rope_theta 500k."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llama3-8b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256, head_dim=128,
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128)
