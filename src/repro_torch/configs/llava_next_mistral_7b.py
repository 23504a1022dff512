"""llava-next-mistral-7b [vlm] — hf:llava-hf/llava-v1.6-mistral-7b-hf.
Mistral-7B text backbone (32L d4096 32H GQA kv=8 d_ff 14336 vocab 32000);
the anyres vision tower is a STUB: input_specs() feeds precomputed patch
embeddings (input_mode='embeds'), per the assignment brief."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llava-next-mistral-7b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        input_mode="embeds",
    )


def smoke_config() -> ModelConfig:
    return full_config().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128)
