"""pixtral-12b [vlm]: a Pixtral-ViT frontend (stub) + a Mistral-Nemo-style
decoder (the reference's config).

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.

The vision frontend is a stub: ``batch["prefix_embeds"]`` carries
precomputed patch embeddings for the first 64 positions.
"""
from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072,
        rope_theta=1e6, activation="swiglu",
        frontend="vision", n_prefix=64,
    )
