"""Noisy top-k gating (Eqs. 3-5) and the Appendix-A load estimator,
counterpart of ``repro.core.gating``.

All gating math runs in float32.  Wg and Wnoise are zero-initialized
(Appendix A: "no signal and some noise").

torch cannot reproduce ``jax.random`` draws, so the Gaussian noise of
Eq. (3) is an optional tensor argument: the caller draws the standard
normals (a test feeds both packages the same draws) and the gate scales
them by Softplus(x Wnoise).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import ParamDef

NOISE_EPSILON = 1e-2  # floor on the noise std-dev, as in the reference.


class GatingInfo(NamedTuple):
    combine_weights: torch.Tensor   # [T, k] f32, the non-zero G(x) values
    expert_index: torch.Tensor      # [T, k] int32
    gates: torch.Tensor             # [T, E] f32 sparse gate matrix G(x)
    load: torch.Tensor              # [E] f32 smooth load estimator
    raw_logits: torch.Tensor        # [T, E] clean logits x @ Wg


def gating_defs(d_model: int, n_experts: int, *, noisy: bool = True,
                dtype: torch.dtype = torch.float32) -> dict:
    """Zero-initialized Wg / Wnoise (Appendix A: balanced initial load)."""
    defs = {"wg": ParamDef((d_model, n_experts), ("embed", "experts"),
                           init="zeros", dtype=dtype)}
    if noisy:
        defs["wnoise"] = ParamDef((d_model, n_experts), ("embed", "experts"),
                                  init="zeros", dtype=dtype)
    return defs


def top_k(v: torch.Tensor, k: int):
    """``lax.top_k`` semantics: descending values, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _normal_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / (2.0 ** 0.5)))


def noisy_topk_gating(params, x: torch.Tensor, k: int, *, train: bool,
                      noise: torch.Tensor | None = None,
                      valid: torch.Tensor | None = None,
                      topk_impl: Callable | None = None) -> GatingInfo:
    """Eqs. (3)-(5) + the Appendix-A load estimator.

    H(x)_i = (x Wg)_i + noise_i * Softplus((x Wnoise)_i)
    G(x)   = Softmax(KeepTopK(H(x), k))

    ``noise`` ([T, E] standard normals) turns the noisy path on when
    ``train`` and the params carry ``wnoise`` (the reference draws it from
    an rng; here the caller does).  ``valid`` ([T] in {0,1}) masks rows
    out of gates, combine weights and load.  ``topk_impl`` swaps in the
    kernel backend's fused KeepTopK+softmax: ``(noisy, k, kk) ->
    (combine [T,k], idx [T,k], raw top values [T,kk])``.
    """
    xf = x.float()
    clean = xf @ params["wg"].float()                               # [T, E]
    n_experts = clean.shape[-1]
    k = min(k, n_experts)

    if train and "wnoise" in params and noise is not None:
        raw_noise = xf @ params["wnoise"].float()
        noise_std = F.softplus(raw_noise) + NOISE_EPSILON
        noisy = clean + noise.float() * noise_std
    else:
        noise_std = None
        noisy = clean

    kk = min(k + 1, n_experts)
    if topk_impl is not None:
        combine, topk_idx, top_vals = topk_impl(noisy.contiguous(), k, kk)
    else:
        top_vals, top_idx = top_k(noisy, kk)
        topk_idx = top_idx[..., :k]
        combine = torch.softmax(top_vals[..., :k], dim=-1)
    if valid is not None:
        combine = combine * valid[:, None]

    gates = torch.zeros_like(clean).scatter(1, topk_idx.long(), combine)

    if noise_std is not None and kk > k:
        in_topk = gates > 0.0
        thresh_if_in = top_vals[..., k:k + 1]        # (k+1)-th noisy value
        thresh_if_out = top_vals[..., k - 1:k]       # k-th noisy value
        threshold = torch.where(in_topk, thresh_if_in, thresh_if_out)
        p = _normal_cdf((clean - threshold) / noise_std)            # Eq. (9)
        if valid is not None:
            p = p * valid[:, None]
        load = torch.sum(p, dim=0)                                  # Eq. (10)
    else:
        hard = (gates > 0.0).float()
        if valid is not None:
            hard = hard * valid[:, None]
        load = torch.sum(hard, dim=0)

    return GatingInfo(combine_weights=combine, expert_index=topk_idx,
                      gates=gates, load=load, raw_logits=clean)
