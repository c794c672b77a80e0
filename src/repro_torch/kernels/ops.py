"""Public kernel ops (counterpart of ``repro.kernels.ops``): the
differentiable forms of the kernel wrappers, the expert FFN as fused
GMMs, and the two fused decode kernels (forward only).

Each op goes through its kernel's ``torch.autograd.Function``, whose
forward and backward run the CUDA kernels on CUDA tensors and their
plain versions on CPU tensors, so the backend ``"cuda"`` trains on
either device."""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_decode as fused_lib
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


def gmm(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
        rows: torch.Tensor | None = None) -> torch.Tensor:
    return GMMFn.apply(x, w, activation, rows)


def expert_ffn(params, x: torch.Tensor, *, activation: str = "relu",
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """Up-projection GMM (+ fused activation), then the down-projection.

    x: [E, C, d]; params carries w1 [E,d,f], w2 [E,f,d] (w3 for swiglu).
    swiglu is silu(x w1) * (x w3): two GMMs, the product in f32, one
    cast — the reference's order of roundings.  ``rows`` ([E] int32,
    each expert's filled leading rows) goes to all three GMMs: the rest
    come out as zeros without being computed."""
    dt = x.dtype
    w1 = params["w1"].to(dt)
    w2 = params["w2"].to(dt)
    if activation == "swiglu":
        h = gmm(x, w1, activation="silu", rows=rows)
        g = gmm(x, params["w3"].to(dt), activation="none", rows=rows)
        h = (h.float() * g.float()).to(dt)
    else:
        h = gmm(x, w1, activation="relu", rows=rows)
    return gmm(h, w2, activation="none", rows=rows)


def _inference_only(name: str, *tensors) -> None:
    """The fused kernels have no backward pass, as in the reference: a
    call that autograd would record raises instead of detaching."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is inference-only (no backward pass); "
                           "call it under torch.no_grad() or on tensors "
                           "that do not require grad")


def fused_decode_step(x, valid, wg, w1, w2, w3=None, *, k: int,
                      capacity: int, activation: str = "relu"):
    """One MoE decode layer in one launch (routing, scatter, expert FFN,
    combine).  Returns (y, expert_load, overflow)."""
    _inference_only("fused_decode_step", x, wg, w1, w2, w3)
    return fused_lib.decode_step(x, valid, wg, w1, w2, w3, k=k,
                                 capacity=capacity, activation=activation)


def fused_routed_apply(x, plan_in, plan_out, w1, w2=None, w3=None, *,
                       mode: str = "ffn", activation: str = "relu",
                       out_dtype=None):
    """dispatch(plan_in) -> expert FFN or projection -> combine(plan_out)
    in one launch, over ``DispatchPlan``s (MoA's assignment-major views
    included)."""
    _inference_only("fused_routed_apply", x, w1, w2, w3)
    return fused_lib.routed_apply(
        x, plan_in.expert_index, plan_in.position, plan_out.expert_index,
        plan_out.position, plan_out.weight, w1, w2, w3,
        n_experts=plan_in.n_experts, capacity=plan_in.capacity, mode=mode,
        activation=activation, out_dtype=out_dtype)
