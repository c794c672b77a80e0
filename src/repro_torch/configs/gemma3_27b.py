"""gemma3-27b [dense]: 5:1 local:global sliding-window attention (the
reference's config).

62L d_model=5376 32H (GQA kv=16, head_dim=128) d_ff=21504 vocab=262144.

Period-6 pattern: 5 sliding-window (1024) layers then 1 global layer;
62 = 6·10 + 2, so ten stacked periods plus a 2-layer local tail.  The
window bounds the decode cache of 52 of the 62 layers to a 1024-slot
ring buffer.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab_size=262144,
        period=6, global_attn_positions=(5,), sliding_window=1024,
        qk_norm=True, rope_theta=1e6, activation="geglu",
    )
