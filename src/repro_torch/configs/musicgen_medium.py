"""musicgen-medium [audio] — arXiv:2306.05284. 48L d1536 24H (MHA kv=24)
d_ff 6144, decoder-only over EnCodec tokens (vocab 2048, 4 codebooks).
The EnCodec frontend is a STUB: input_specs() feeds precomputed summed
codebook embeddings (input_mode='embeds')."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-medium"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        d_ff=6144, vocab_size=2048, head_dim=64,
        input_mode="embeds",
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64)
