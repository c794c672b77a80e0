"""Plain PyTorch oracles for the kernels (counterpart of
``repro.kernels.ref``).  Each loops over expert chunks where it upcasts
weights, so none ever holds an f32 copy of a whole expert tensor."""
from __future__ import annotations

import torch

from repro_torch.core.gating import top_k
from repro_torch.kernels.gmm import expert_chunk, gmm_plain


def gmm_ref(x: torch.Tensor, w: torch.Tensor, *,
            activation: str = "none") -> torch.Tensor:
    """Grouped matmul [E,C,K] x [E,K,N] -> [E,C,N], f32 math, x.dtype out
    (the GMM kernel's plain version)."""
    return gmm_plain(x, w, activation)


def expert_ffn_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   w3: torch.Tensor | None = None) -> torch.Tensor:
    """The one-hidden-layer ReLU expert (§3.2), or gated-SiLU with w3;
    every intermediate in f32.  [E,C,d] -> [E,C,d]."""
    e, c, d = x.shape
    out = torch.empty_like(x)
    step = expert_chunk(d, w1.shape[-1])
    for e0 in range(0, e, step):
        sl = slice(e0, e0 + step)
        xs = x[sl].float()
        h = torch.bmm(xs, w1[sl].float())
        if w3 is None:
            h = torch.relu(h)
        else:
            h = torch.nn.functional.silu(h) * torch.bmm(xs, w3[sl].float())
        out[sl] = torch.bmm(h, w2[sl].float()).to(x.dtype)
    return out


def topk_gating_ref(logits: torch.Tensor, k: int):
    """Softmax over the top k (ties to the lower index, as lax.top_k).
    logits [T, E] f32 -> (w [T,k], idx [T,k] int32, gates [T,E])."""
    vals, idx = top_k(logits.float(), k)
    w = torch.softmax(vals, dim=-1)
    gates = torch.zeros_like(logits, dtype=torch.float32).scatter(
        1, idx.long(), w)
    return w, idx, gates
