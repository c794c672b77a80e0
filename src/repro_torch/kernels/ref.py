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


def fused_decode_ref(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
                     w2: torch.Tensor, w3: torch.Tensor | None = None,
                     valid: torch.Tensor | None = None, *, k: int,
                     capacity: int):
    """Oracle for the fused decode step (``kernels/fused_decode.py``),
    written with the other formulations on purpose: sort-based top-k,
    stable-argsort slot assignment (the ``core.dispatch.plan``
    algorithm), the all-f32 expert FFN and a vectorised gather-combine.
    Returns ``(y [T, d], expert_load [E], overflow [E])``."""
    t, d = x.shape
    e = wg.shape[-1]
    vals, idx = top_k(x.float() @ wg.float(), k)
    w = torch.softmax(vals, dim=-1)
    if valid is not None:
        w = w * valid.float().reshape(t, 1)
    flat_e = idx.reshape(-1).long()
    flat_w = w.reshape(-1)
    assigned = flat_w > 0
    order = torch.argsort(flat_e * 2 + (~assigned).long(), stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x.device) - starts[sorted_e]
    pos_sorted = torch.where(flat_w[order] > 0, rank,
                             torch.full_like(rank, capacity))
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    kept = pos < capacity
    w_eff = torch.where(kept, flat_w, 0.0)
    buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
    buf[flat_e[kept], pos[kept]] = x.repeat_interleave(k, dim=0)[kept]
    out = expert_ffn_ref(buf, w1, w2, w3)
    gathered = out[flat_e, pos.clamp(0, capacity - 1)].float()
    y = (w_eff[:, None] * gathered).reshape(t, k, d).sum(dim=1).to(x.dtype)
    zero = torch.zeros((e,), dtype=torch.float32, device=x.device)
    load = zero.index_add(0, flat_e, assigned.float())
    overflow = zero.index_add(0, flat_e, (assigned & ~kept).float())
    return y, load, overflow
