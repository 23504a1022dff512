"""h2o-danube-3-4b [dense] — arXiv:2401.16818 family. 24L d3840 32H (GQA
kv=8, head_dim 120) d_ff 10240 vocab 32000, sliding-window attention 4096
=> sub-quadratic long-context decode (runs long_500k)."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "h2o-danube-3-4b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        d_ff=10240, vocab_size=32000, head_dim=120,
        sliding_window=4096,
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, sliding_window=32)
