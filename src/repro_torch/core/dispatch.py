"""Token dispatch / combine for sparse expert computation
(counterpart of ``repro.core.dispatch``).

Capacity-based dispatch: every expert owns a buffer of ``capacity`` token
slots; assignments past capacity are dropped (their combine weight is
zeroed, so the token passes through the residual connection).

Two implementations with identical semantics, as in the reference:

* ``sort``   — scatter by a stable sort on expert id.
* ``einsum`` — GShard-style one-hot ``[T, E, C]`` masks (the oracle).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class DispatchPlan(NamedTuple):
    expert_index: torch.Tensor      # [T, k] int32
    position: torch.Tensor          # [T, k] int32 slot within the buffer
    weight: torch.Tensor            # [T, k] f32 combine weight (0 if dropped)
    n_experts: int
    capacity: int
    fraction_dropped: torch.Tensor  # scalar f32


def capacity_for(n_tokens: int, n_experts: int, k: int,
                 capacity_factor: float, *, multiple: int = 8) -> int:
    """Slots per expert: ceil(k*T/E * factor), rounded up to ``multiple``."""
    raw = (k * n_tokens * capacity_factor) / max(n_experts, 1)
    cap = int(-(-raw // 1))
    cap = max(cap, 1)
    return int(-(-cap // multiple) * multiple)


def plan(expert_index: torch.Tensor, weight: torch.Tensor, n_experts: int,
         capacity: int, *, priority: bool = False) -> DispatchPlan:
    """Assign a buffer slot to every (token, k) pair.

    Slots go in batch order within each expert; zero-weight assignments
    (masked tokens) sort behind every real one and are dropped.
    ``priority=True`` gives over-capacity slots to the highest-weight
    assignments instead.
    """
    t, k = expert_index.shape
    dev = expert_index.device
    flat_e = expert_index.reshape(-1).long()
    flat_w = weight.float().reshape(-1)
    if priority:
        # lexsort((-w, e)): expert id first, then descending weight.
        by_w = torch.argsort(-flat_w, stable=True)
        order = by_w[torch.argsort(flat_e[by_w], stable=True)]
    else:
        order = torch.argsort(flat_e * 2 + (flat_w <= 0).long(), stable=True)
    sorted_e = flat_e[order]
    sorted_w = flat_w[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[sorted_e]
    pos_sorted = torch.where(sorted_w > 0, rank,
                             torch.full_like(rank, capacity))
    position = torch.empty_like(pos_sorted)
    position[order] = pos_sorted
    position = position.reshape(t, k).to(torch.int32)
    kept = position < capacity
    w = torch.where(kept, weight.float(), 0.0)
    assigned = weight > 0
    denom = torch.clamp(assigned.sum().float(), min=1.0)
    frac_dropped = (assigned & ~kept).sum().float() / denom
    return DispatchPlan(expert_index=expert_index.to(torch.int32),
                        position=position, weight=w, n_experts=n_experts,
                        capacity=capacity, fraction_dropped=frac_dropped)


def filled_rows(p: DispatchPlan) -> torch.Tensor:
    """[E] int32: the kept assignments of each expert.  For a plan from
    :func:`plan`, whose slots fill each buffer from slot 0, this is the
    count of filled leading rows that the GMM kernels may stop at.
    Computed on the device with no host sync."""
    flat_e = p.expert_index.reshape(-1).long()
    kept = (p.position.reshape(-1) < p.capacity).to(torch.int32)
    return torch.zeros((p.n_experts,), dtype=torch.int32,
                       device=flat_e.device).scatter_add_(0, flat_e, kept)


# ---------------------------------------------------------------------------
# sort/scatter implementation
# ---------------------------------------------------------------------------

def dispatch(x: torch.Tensor, p: DispatchPlan) -> torch.Tensor:
    """[T, d] -> [E, C, d].  Out-of-capacity assignments are dropped."""
    t, d = x.shape
    k = p.expert_index.shape[1]
    buf = torch.zeros((p.n_experts, p.capacity, d), dtype=x.dtype,
                      device=x.device)
    flat_e = p.expert_index.reshape(-1).long()
    flat_pos = p.position.reshape(-1).long()
    kept = flat_pos < p.capacity
    rows = x.repeat_interleave(k, dim=0)
    buf[flat_e[kept], flat_pos[kept]] = rows[kept]
    return buf


def combine(expert_out: torch.Tensor, p: DispatchPlan,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """[E, C, d] -> [T, d]: weighted gather, y = sum_k w_k * E_{e_k}(x)."""
    pos = torch.clamp(p.position.long(), 0, p.capacity - 1)
    gathered = expert_out[p.expert_index.long(), pos]           # [T, k, d]
    y = torch.sum(gathered.float() * p.weight.float()[..., None], dim=1)
    return y.to(dtype or expert_out.dtype)


# ---------------------------------------------------------------------------
# einsum (GShard-style) reference implementation
# ---------------------------------------------------------------------------

def masks_einsum(p: DispatchPlan):
    """Dense dispatch / combine one-hot tensors ``[T, E, C]``."""
    e_oh = F.one_hot(p.expert_index.long(), p.n_experts).float()
    # Dropped assignments one-hot into an extra column that is cut off.
    pos = torch.clamp(p.position.long(), max=p.capacity)
    c_oh = F.one_hot(pos, p.capacity + 1)[..., :p.capacity].float()
    disp = torch.einsum("tke,tkc->tec", e_oh, c_oh)
    comb = torch.einsum("tke,tkc,tk->tec", e_oh, c_oh, p.weight.float())
    return disp, comb


def dispatch_einsum(x: torch.Tensor, p: DispatchPlan) -> torch.Tensor:
    disp, _ = masks_einsum(p)
    return torch.einsum("tec,td->ecd", disp, x.float()).to(x.dtype)


def combine_einsum(expert_out: torch.Tensor, p: DispatchPlan,
                   dtype: torch.dtype | None = None) -> torch.Tensor:
    _, comb = masks_einsum(p)
    y = torch.einsum("tec,ecd->td", comb, expert_out.float())
    return y.to(dtype or expert_out.dtype)
