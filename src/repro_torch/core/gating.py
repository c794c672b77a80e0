"""Gating networks, counterpart of ``repro.core.gating``: noisy top-k
gating (Eqs. 3-5) with the Appendix-A load estimator, and Appendix F's
batchwise gating (Eq. 18), threshold gating (Eq. 19) and the loss that
trains the thresholds (Eq. 20).

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


def threshold_defs(n_experts: int,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Per-expert thresholds T for Appendix-F inference (Eq. 19)."""
    return {"t": ParamDef((n_experts,), ("experts",), init="zeros",
                          dtype=dtype)}


def softmax_gating(params, x: torch.Tensor) -> torch.Tensor:
    """Eq. (2): dense softmax gates [T, E] in float32."""
    return torch.softmax(x.float() @ params["wg"].float(), dim=-1)


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

    ``x`` may carry leading group axes ([G, T, d] with gate leaves
    [G, d, E], noise [G, T, E], valid [G, T]): each group is gated by
    its own slice, as ``vmap`` over the groups would, and every output
    keeps the group axes (load [G, E]); the top-k runs once over all
    G·T rows.
    """
    xf = x.float()
    clean = xf @ params["wg"].float()                           # [..., T, E]
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
        lead = noisy.shape[:-1]
        combine, topk_idx, top_vals = topk_impl(
            noisy.reshape(-1, n_experts).contiguous(), k, kk)
        combine, topk_idx, top_vals = (
            combine.reshape(lead + (k,)), topk_idx.reshape(lead + (k,)),
            top_vals.reshape(lead + (kk,)))
    else:
        top_vals, top_idx = top_k(noisy, kk)
        topk_idx = top_idx[..., :k]
        combine = torch.softmax(top_vals[..., :k], dim=-1)
    if valid is not None:
        combine = combine * valid[..., None]

    gates = torch.zeros_like(clean).scatter(-1, topk_idx.long(), combine)

    if noise_std is not None and kk > k:
        in_topk = gates > 0.0
        thresh_if_in = top_vals[..., k:k + 1]        # (k+1)-th noisy value
        thresh_if_out = top_vals[..., k - 1:k]       # k-th noisy value
        threshold = torch.where(in_topk, thresh_if_in, thresh_if_out)
        p = _normal_cdf((clean - threshold) / noise_std)            # Eq. (9)
        if valid is not None:
            p = p * valid[..., None]
        load = torch.sum(p, dim=-2)                                 # Eq. (10)
    else:
        hard = (gates > 0.0).float()
        if valid is not None:
            hard = hard * valid[..., None]
        load = torch.sum(hard, dim=-2)

    return GatingInfo(combine_weights=combine, expert_index=topk_idx,
                      gates=gates, load=load, raw_logits=clean)


def _column_top_m(g: torch.Tensor, m: int) -> torch.Tensor:
    """[T, E] 0/1 mask of each expert's top-m tokens (Eq. 18)."""
    _, col_idx = top_k(g.T, m)                                     # [E, m]
    return torch.zeros_like(g.T).scatter(1, col_idx.long(), 1.0).T


def batchwise_gating(params, x: torch.Tensor, k: int,
                     valid: torch.Tensor | None = None) -> GatingInfo:
    """Appendix F, Eqs. (16) + (18): each expert keeps its top
    m = k·T/E tokens of the batch.  ``valid`` masks rows out: they are
    never selected and add nothing to gates or load."""
    g_sigma = softmax_gating(params, x)                            # [T, E]
    if valid is not None:
        g_sigma = g_sigma * valid.float()[:, None]
    t, e = g_sigma.shape
    mask = _column_top_m(g_sigma, max((k * t) // e, 1))
    if valid is not None:
        # A masked row may be picked as zero-valued filler when an expert
        # has fewer than m valid tokens; keep it out of load and gates.
        mask = mask * valid.float()[:, None]
    masked = g_sigma * mask
    gates = masked / torch.clamp(masked.sum(dim=-1, keepdim=True), min=1e-9)
    combine, topk_idx = top_k(gates, min(k, e))
    return GatingInfo(combine_weights=combine, expert_index=topk_idx,
                      gates=gates, load=mask.sum(dim=0),
                      raw_logits=torch.log(torch.clamp(g_sigma, min=1e-20)))


def threshold_gating(params, thresholds, x: torch.Tensor, k: int,
                     valid: torch.Tensor | None = None) -> GatingInfo:
    """Appendix F inference, Eq. (19): M_i = 1 if g_i > T_i."""
    g_sigma = softmax_gating(params, x)
    mask = (g_sigma > thresholds["t"].float()[None, :]).float()
    if valid is not None:
        mask = mask * (valid.float()[:, None] > 0).float()
    masked = g_sigma * mask
    gates = masked / torch.clamp(masked.sum(dim=-1, keepdim=True), min=1e-9)
    combine, topk_idx = top_k(gates, min(k, g_sigma.shape[-1]))
    return GatingInfo(combine_weights=combine, expert_index=topk_idx,
                      gates=gates, load=mask.sum(dim=0),
                      raw_logits=torch.log(torch.clamp(g_sigma, min=1e-20)))


def batchwise_threshold_loss(params, thresholds, x: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Eq. (20): aligns the threshold mask with the batchwise one; the
    indicators are constants, the gradient flows through (g - T)."""
    g_sigma = softmax_gating(params, x)                            # [T, E]
    t, e = g_sigma.shape
    m_batch = _column_top_m(g_sigma.detach(), max((k * t) // e, 1))
    tvec = thresholds["t"].float()[None, :]
    m_thresh = (g_sigma > tvec).float()
    return torch.sum((m_thresh - m_batch) * (g_sigma - tvec)) / t
