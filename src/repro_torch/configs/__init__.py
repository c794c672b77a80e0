"""Architecture registry: importing this package registers every ported
config (kimi-k2-1t-a32b and moa-demo)."""
from repro_torch.configs import kimi_k2_1t_a32b, moa_demo  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    count_params,
    get_config,
    layer_kinds,
)
