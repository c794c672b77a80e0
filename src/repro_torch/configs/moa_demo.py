"""moa-demo [moe]: Mixture-of-Attention-Heads demo arch (the reference's
config, widths unchanged).

Alternates plain-attention + MoE-FFN blocks with MoA-mixer blocks: odd
positions route each token through 2 of 8 attention head groups (2 query
heads each) against one shared K/V head (the MoA paper's MQA setting),
through the same Router API and kernel backends as the FFN experts.
"""
from repro_torch.configs.base import ModelConfig, register


@register("moa-demo")
def config() -> ModelConfig:
    return ModelConfig(
        name="moa-demo", family="moe",
        n_layers=4, period=2, d_model=512, vocab_size=32_000,
        n_heads=8, n_kv_heads=1, head_dim=64, d_ff=1024,
        # position 0: plain attention + MoE FFN
        moe_positions=(0,), n_experts=8, moe_k=2, moe_d_ff=1024,
        # position 1: MoA mixer + dense FFN
        moa_positions=(1,), moa_experts=8, moa_k=2, moa_heads_per_expert=2,
        rope_theta=10000.0, activation="swiglu",
    )
