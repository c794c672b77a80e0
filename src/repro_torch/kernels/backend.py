"""Kernel backend registry: the one switch between the plain PyTorch
reference path and the CUDA kernel path (counterpart of
``repro.kernels.backend``).

* ``"ref"``  — plain PyTorch: sort-based top-k, index scatter / gather
  dispatch and combine, expert FFN in f32 over expert chunks.
* ``"cuda"`` — the hand-written kernels of ``csrc/`` (the counterpart of
  the reference's ``"pallas"``), through their autograd Functions
  (``kernels/ops.py``), so the path is differentiable on both devices.
  Each wrapper runs its kernel on CUDA tensors and its plain version on
  CPU tensors only; nothing falls back to the ref scatter.

Buffer regime of dispatch / combine (:func:`plan_e_block`): the
reference selects against a 16 MiB VMEM budget by default.  The card
has no VMEM, so here the default (both ``MoEArgs.dispatch_e_block`` and
``dispatch_vmem_limit`` None) keeps the resident kernels; a forced
``dispatch_e_block`` or a named ``dispatch_vmem_limit`` selects the
expert-blocked kernels as the reference would.  This is the one place
where the port's default differs from the reference's.

Resolution is explicit: an unknown backend raises
:class:`KernelBackendError`, never a silent fall-back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch as dsp
from repro_torch.kernels import dispatch as dispatch_lib
from repro_torch.kernels import gmm as gmm_lib
from repro_torch.kernels import ops


class KernelBackendError(RuntimeError):
    """Unknown or mis-configured kernel backend — never swallowed."""


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """One coherent implementation set for the MoE hot path.
    ``topk_impl`` is None for the sort-based top-k, else ``(noisy, k,
    kk) -> (combine [T,k], idx [T,k], raw top values [T,kk])``."""
    name: str
    expert_ffn: Callable     # (params, x, a) -> [E, C, d]
    dispatch: Callable       # (x, plan, a) -> [E, C, d]
    combine: Callable        # (buf, plan, a, *, dtype=None) -> [T, d]
    topk_impl: Callable | None = None


_REGISTRY: dict[str, KernelBackend] = {}


def register(backend: KernelBackend) -> None:
    _REGISTRY[backend.name] = backend


def get(name: str) -> KernelBackend:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KernelBackendError(f"unknown kernel backend {name!r}; "
                                 f"registered: {sorted(_REGISTRY)}")
    return entry


def resolve(a) -> KernelBackend:
    """Backend named by a MoEArgs-like config's ``kernel_backend``."""
    return get(a.kernel_backend)


def _as_plan(p) -> dsp.DispatchPlan:
    """Backends take a router ``RouteDecision`` wherever they take a
    ``DispatchPlan``."""
    return getattr(p, "plan", p)


def _dispatch_impl(a) -> str:
    spec = getattr(a, "router", None)
    if spec is not None:
        return spec.dispatch
    return getattr(a, "dispatch_impl", "sort")


# ---------------------------------------------------------------------------
# "ref" — plain PyTorch
# ---------------------------------------------------------------------------

def _ref_expert_ffn(params, x, a):
    """The reference's order of roundings: f32 up-projections, the gate
    product in f32, one cast, the f32 down-projection, one cast.  Walked
    over expert chunks so weights are upcast a chunk at a time."""
    dt = a.dtype
    e = x.shape[0]
    out = torch.empty((e, x.shape[1], params["w2"].shape[-1]), dtype=dt,
                      device=x.device)
    step = gmm_lib.expert_chunk(params["w1"].shape[1], params["w1"].shape[2])
    for e0 in range(0, e, step):
        sl = slice(e0, e0 + step)
        xs = x[sl].to(dt).float()
        h = torch.bmm(xs, params["w1"][sl].to(dt).float())
        if a.activation == "swiglu":
            g = torch.bmm(xs, params["w3"][sl].to(dt).float())
            h = F.silu(h) * g
        else:
            h = torch.relu(h)
        h = h.to(dt).float()
        out[sl] = torch.bmm(h, params["w2"][sl].to(dt).float()).to(dt)
    return out


def _ref_dispatch(x, p, a):
    p = _as_plan(p)
    if _dispatch_impl(a) == "einsum":
        return dsp.dispatch_einsum(x, p)
    return dsp.dispatch(x, p)


def _ref_combine(buf, p, a, *, dtype=None):
    p = _as_plan(p)
    if _dispatch_impl(a) == "einsum":
        return dsp.combine_einsum(buf, p, dtype=dtype)
    return dsp.combine(buf, p, dtype=dtype)


register(KernelBackend(name="ref", expert_ffn=_ref_expert_ffn,
                       dispatch=_ref_dispatch, combine=_ref_combine,
                       topk_impl=None))


# ---------------------------------------------------------------------------
# "cuda" — the hand-written kernels
# ---------------------------------------------------------------------------

def plan_e_block(a, n_experts: int, capacity: int, d: int, dtype,
                 n_tokens: int) -> int | None:
    """The dispatch / combine regime for a call: ``None`` (resident
    kernels) or the expert slab of the e-blocked kernels.  A forced
    ``a.dispatch_e_block`` wins; a named ``a.dispatch_vmem_limit``
    selects through ``select_e_block`` as the reference does (raising
    ``DispatchVMEMError`` where the reference would fall back to its
    ref scatter); with neither, resident (the card has no VMEM)."""
    forced = getattr(a, "dispatch_e_block", None)
    if forced is not None:
        if forced < 1:
            raise KernelBackendError(
                f"dispatch_e_block must be >= 1, got {forced}")
        return forced
    limit = getattr(a, "dispatch_vmem_limit", None)
    if limit is None:
        return None
    return dispatch_lib.select_e_block(n_experts, capacity, d, dtype,
                                       n_tokens=n_tokens, limit=limit)


def _cuda_expert_ffn(params, x, a):
    return ops.expert_ffn(params, x, activation=a.activation)


def _cuda_dispatch(x, p, a):
    p = _as_plan(p)
    e_block = plan_e_block(a, p.n_experts, p.capacity, x.shape[-1], x.dtype,
                           x.shape[0])
    return ops.dispatch(x.contiguous(), p.expert_index.contiguous(),
                        p.position.contiguous(), n_experts=p.n_experts,
                        capacity=p.capacity, e_block=e_block)


def _cuda_combine(buf, p, a, *, dtype=None):
    p = _as_plan(p)
    # The reference's token-block term for the combine's estimate.
    n_tok = min(dispatch_lib.COMBINE_BLOCK_T, p.expert_index.shape[0])
    e_block = plan_e_block(a, buf.shape[0], buf.shape[1], buf.shape[2],
                           buf.dtype, n_tok)
    return ops.combine(buf.contiguous(), p.weight.contiguous(),
                       p.expert_index.contiguous(), p.position.contiguous(),
                       out_dtype=dtype or buf.dtype, e_block=e_block)


def _cuda_topk(noisy, k, kk):
    w, idx, vals = ops.topk_gating(noisy, k, kk)
    return w, idx[:, :k].contiguous(), vals


register(KernelBackend(name="cuda", expert_ffn=_cuda_expert_ffn,
                       dispatch=_cuda_dispatch, combine=_cuda_combine,
                       topk_impl=_cuda_topk))
