"""Public kernel ops (counterpart of ``repro.kernels.ops``): the expert
FFN as fused GMMs, plus re-exports of the kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import combine, dispatch  # noqa: F401
from repro_torch.kernels.gmm import gmm
from repro_torch.kernels.topk_gating import topk_gating  # noqa: F401


def expert_ffn(params, x: torch.Tensor, *,
               activation: str = "relu") -> torch.Tensor:
    """Up-projection GMM (+ fused activation), then the down-projection.

    x: [E, C, d]; params carries w1 [E,d,f], w2 [E,f,d] (w3 for swiglu).
    swiglu is silu(x w1) * (x w3): two GMMs, the product in f32, one
    cast — the reference's order of roundings."""
    dt = x.dtype
    w1 = params["w1"].to(dt)
    w2 = params["w2"].to(dt)
    if activation == "swiglu":
        h = gmm(x, w1, activation="silu")
        g = gmm(x, params["w3"].to(dt), activation="none")
        h = (h.float() * g.float()).to(dt)
    else:
        h = gmm(x, w1, activation="relu")
    return gmm(h, w2, activation="none")
