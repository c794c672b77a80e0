"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE every
2nd layer (the reference's config).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887; hf]

Period-8 pattern: position 4 is attention, the other seven are Mamba
(1 attn : 7 mamba); MoE replaces the dense FFN on odd positions (every
other layer).
"""
from repro_torch.configs.base import ModelConfig, register


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        period=8, attn_positions=(4,), moe_positions=(1, 3, 5, 7),
        n_experts=16, moe_k=2, moe_d_ff=14336,
        ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
        activation="swiglu",
    )
