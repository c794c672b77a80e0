"""Architecture registry: importing this package registers every ported
config (arctic-480b, gemma3-27b, kimi-k2-1t-a32b, llama3-8b, moa-demo,
musicgen-large, pixtral-12b, qwen3-1.7b, smollm-135m)."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    gemma3_27b,
    kimi_k2_1t_a32b,
    llama3_8b,
    moa_demo,
    musicgen_large,
    pixtral_12b,
    qwen3_1p7b,
    smollm_135m,
)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    count_params,
    get_config,
    layer_kinds,
)
