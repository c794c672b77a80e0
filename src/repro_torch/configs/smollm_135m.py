"""smollm-135m [dense]: llama-architecture small model (the reference's
config).

30L d_model=576 9H (GQA kv=3, head_dim=64) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register


@register("smollm-135m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
        d_ff=1536, vocab_size=49152,
        activation="swiglu",
    )
