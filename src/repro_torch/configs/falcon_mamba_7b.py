"""falcon-mamba-7b [ssm]: pure Mamba-1, attention-free (the reference's
config).

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16.
[arXiv:2410.05355; unverified]

Every layer is a Mamba block (no FFN), so the model runs none of the
port's MoE kernels.  Its decode state is O(1) a token: 64 layers of a
[d_in, 16] f32 scan state and a [3, d_in] conv state a sequence.
"""
from repro_torch.configs.base import ModelConfig, register


@register("falcon-mamba-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, vocab_size=65024,
        d_ff=0,
        ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
    )
