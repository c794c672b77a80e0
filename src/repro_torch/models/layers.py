"""Shared neural-net layers (counterpart of ``repro.models.layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.param import ParamDef


def rmsnorm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), ("embed",), init="ones",
                              dtype=torch.float32)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def embed_defs(vocab: int, d: int, dtype: torch.dtype) -> dict:
    return {"table": ParamDef((vocab, d), ("vocab", "embed_fsdp"),
                              init="embed", dtype=dtype)}


def embed(params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return params["table"][tokens.long()].to(dtype)


GATED = ("swiglu", "geglu")


def mlp_defs(d: int, d_ff: int, activation: str, dtype: torch.dtype) -> dict:
    defs = {
        "w1": ParamDef((d, d_ff), ("embed_fsdp", "mlp"), dtype=dtype),
        "w2": ParamDef((d_ff, d), ("mlp", "embed_fsdp"), dtype=dtype),
    }
    if activation in GATED:
        defs["w3"] = ParamDef((d, d_ff), ("embed_fsdp", "mlp"), dtype=dtype)
    return defs


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Dense FFN: matmuls in the compute dtype, activation in f32."""
    dt = x.dtype
    h = torch.matmul(x, params["w1"].to(dt)).float()
    if activation == "relu":
        h = torch.relu(h)
    elif activation == "gelu":
        h = F.gelu(h)
    elif activation in GATED:
        g = torch.matmul(x, params["w3"].to(dt)).float()
        h = (F.silu(h) if activation == "swiglu" else F.gelu(h)) * g
    else:
        raise ValueError(activation)
    return torch.matmul(h.to(dt), params["w2"].to(dt))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding.  x: [..., S, n_heads, head_dim];
    positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    angles = positions[..., None].float() * freqs          # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool, *,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout, as the reference's ``layers.dropout``.

    ``keep`` is the boolean keep-mask (``paper_lm.make_draws`` draws it
    from the step's generator; a test draws it with
    ``jax.random.bernoulli`` and passes it in); without one the input
    passes through, as with the reference's ``rng=None``."""
    if not train or rate <= 0.0 or keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)
