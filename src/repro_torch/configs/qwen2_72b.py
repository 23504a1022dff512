"""qwen2-72b [dense] — arXiv:2407.10671. 80L d8192 64H (GQA kv=8)
d_ff 29568 vocab 152064, QKV bias."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-72b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128)
