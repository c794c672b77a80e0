"""arctic-480b [moe]: 128 experts top-2 + a parallel dense residual FFN
(the reference's config).

35L d_model=7168 56H (GQA kv=8, head_dim=128) expert d_ff=4864
vocab=32000.  Every layer computes a dense swiglu FFN of width d_model
in parallel with the top-2 MoE and sums both into the residual stream
(``dense_residual=True``, layer kind ``moe+dense``).  One layer holds
14.12 B parameters (13.39 B of experts): 28.2 GB in bf16, 56.5 GB with
its gradients, so one 80 GB card trains the full width at one layer.
"""
from repro_torch.configs.base import ModelConfig, register


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=7168, vocab_size=32000,
        moe_positions=(0,), dense_residual=True,
        n_experts=128, moe_k=2, moe_d_ff=4864,
        capacity_factor=1.25, activation="swiglu",
    )
