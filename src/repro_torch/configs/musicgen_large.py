"""musicgen-large [audio]: a decoder-only transformer over EnCodec tokens
(the reference's config).

48L d_model=2048 32H (kv=32: full MHA, head_dim=64) d_ff=8192 vocab=2048.

The EnCodec / conditioning frontend is a stub: ``batch["prefix_embeds"]``
carries precomputed conditioning frame embeddings for the first 64
positions; the token stream is a single codebook.
"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=2048,
        activation="gelu",
        frontend="audio", n_prefix=64,
    )
