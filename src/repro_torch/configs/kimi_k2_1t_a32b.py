"""kimi-k2-1t-a32b [moe]: trillion-parameter MoE (the reference's config).

61L d_model=7168 64H (GQA kv=8, head_dim=128) expert d_ff=2048
vocab=163840, MoE 384 experts top-8, swiglu.  One MoE layer's experts
are 384*3*7168*2048 bf16 = 33.8 GB, so a single 80 GB card holds the full
width only at a cut depth (``n_layers=2``: about 72.9 GB of weights).
"""
from repro_torch.configs.base import ModelConfig, register


@register("kimi-k2-1t-a32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=0, vocab_size=163840,
        moe_positions=(0,),          # every layer is MoE
        n_experts=384, moe_k=8, moe_d_ff=2048,
        capacity_factor=1.25, activation="swiglu",
    )
