"""Public kernel ops (counterpart of ``repro.kernels.ops``): the
differentiable forms of the kernel wrappers, and the expert FFN as fused
GMMs.

Each op goes through its kernel's ``torch.autograd.Function``, whose
forward and backward run the CUDA kernels on CUDA tensors and their
plain versions on CPU tensors, so the backend ``"cuda"`` trains on
either device."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import CombineFn, DispatchFn
from repro_torch.kernels.gmm import GMMFn
from repro_torch.kernels.topk_gating import TopKGatingFn


def topk_gating(logits: torch.Tensor, k: int, kk: int | None = None):
    """(w [T,k] f32, idx [T,kk] int32, vals [T,kk] f32); differentiable
    in w and vals."""
    return TopKGatingFn.apply(logits, k, k if kk is None else kk)


def dispatch(x: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor, *,
             n_experts: int, capacity: int,
             e_block: int | None = None) -> torch.Tensor:
    """[T, d] -> [E, C, d]; ``e_block=None`` runs the resident kernel,
    an int the expert-blocked one with that slab."""
    return DispatchFn.apply(x, eidx, pos, n_experts, capacity, e_block)


def combine(buf: torch.Tensor, w: torch.Tensor, eidx: torch.Tensor,
            pos: torch.Tensor, *, out_dtype: torch.dtype | None = None,
            e_block: int | None = None) -> torch.Tensor:
    """[E, C, d] -> [T, d], weighted by w; regime as in :func:`dispatch`."""
    return CombineFn.apply(buf, w, eidx, pos, out_dtype or buf.dtype,
                           e_block)


def gmm(x: torch.Tensor, w: torch.Tensor, *,
        activation: str = "none") -> torch.Tensor:
    return GMMFn.apply(x, w, activation)


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
