"""Kernel backend registry: the one switch between the plain PyTorch
reference path and the CUDA kernel path (counterpart of
``repro.kernels.backend``).

* ``"ref"``  — plain PyTorch: sort-based top-k, index scatter / gather
  dispatch and combine, expert FFN in f32 over expert chunks.
* ``"cuda"`` — the hand-written kernels of ``csrc/`` (the counterpart of
  the reference's ``"pallas"``).  Each wrapper runs its kernel on CUDA
  tensors and its plain version on CPU tensors only.  There is no VMEM
  budget on the GPU, so no expert-blocked regime and no fallback to the
  ref scatter.

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

def _cuda_expert_ffn(params, x, a):
    return ops.expert_ffn(params, x, activation=a.activation)


def _cuda_dispatch(x, p, a):
    p = _as_plan(p)
    return dispatch_lib.dispatch(x.contiguous(), p.expert_index.contiguous(),
                                 p.position.contiguous(),
                                 n_experts=p.n_experts, capacity=p.capacity)


def _cuda_combine(buf, p, a, *, dtype=None):
    p = _as_plan(p)
    return dispatch_lib.combine(buf.contiguous(), p.weight.contiguous(),
                                p.expert_index.contiguous(),
                                p.position.contiguous(),
                                out_dtype=dtype or buf.dtype)


def _cuda_topk(noisy, k, kk):
    w, idx, vals = ops.topk_gating(noisy, k, kk)
    return w, idx[:, :k], vals


register(KernelBackend(name="cuda", expert_ffn=_cuda_expert_ffn,
                       dispatch=_cuda_dispatch, combine=_cuda_combine,
                       topk_impl=_cuda_topk))
