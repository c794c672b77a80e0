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
reference selects it against a 16 MiB VMEM budget.  The card has no
VMEM, so here the resident kernels run unless ``MoEArgs.dispatch_e_block``
forces the expert-blocked ones with that slab.

Fused decode (``decode_step`` / ``decode_proj`` / ``routed_ffn``,
inference-only): on
``"cuda"`` each MoE decode layer is one launch of kernel 7
(``noisy_topk`` without priority dispatch: routing in the kernel) or of
kernel 8 (any other policy: routing outside as plain tensor ops, then
scatter -> FFN -> combine in one launch); each MoA routed projection is
one launch of kernel 8 in ``"proj"`` mode; ``routed_ffn`` is one
launch of kernel 8 in ``"ffn"`` mode on a plan routed outside (fused
decode on a mesh, ``core/expert_parallel.py``).  The reference guards the
fused slab against its VMEM budget and quietly runs the unfused
pipeline past it; the card has no VMEM, so that guard is not ported and
the fused kernels always run when asked for.  On ``"ref"`` both are the
unfused compositions (:func:`_decode_step_via`, :func:`_decode_proj_via`).

Resolution is explicit: an unknown backend raises
:class:`KernelBackendError`, never a silent fall-back.

Observability: every backend call site runs under a span of the ambient
tracer (``repro_torch.obs.trace.current()``): ``kernel.gmm`` (``shape``)
around the expert FFN and ``gmm``, ``kernel.dispatch`` (``tokens``),
``kernel.combine`` (``shape``), ``kernel.decode_step`` /
``kernel.decode_proj`` (``tokens``), each with ``backend`` "ref" or
"cuda".  Two differences from the reference: its spans record a
``jax.jit`` trace once, at the step that compiled, while the port's
calls are eager, so a span records the host side of *every* call (the
kernel itself runs asynchronously on the card, and its time lands in
the first span that waits for a result); and there is no pallas-style
``fused`` flag, because the port never falls back to the ref scatter.
With no tracer installed each span is the shared no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch as dsp
from repro_torch.core import router as router_lib
from repro_torch.kernels import gmm as gmm_lib
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_lib


class KernelBackendError(RuntimeError):
    """Unknown or mis-configured kernel backend — never swallowed."""


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """One coherent implementation set for the MoE hot path.
    ``topk_impl`` is None for the sort-based top-k, else ``(noisy, k,
    kk) -> (combine [T,k], idx [T,k], raw top values [T,kk])``."""
    name: str
    # (params, x, a, *, rows=None, out_dtype=None) -> [E, C, d]; rows
    # [E] int32: each expert's filled leading rows (core/dispatch.py::
    # filled_rows); out_dtype float32 keeps the down-projection's
    # accumulator (a d_ff slice's partial sums).
    expert_ffn: Callable
    dispatch: Callable       # (x, plan, a) -> [E, C, d]
    combine: Callable        # (buf, plan, a, *, dtype=None) -> [T, d]
    gmm: Callable            # (x [E,C,K], w [E,K,N], a) -> [E, C, N]
    # (params, x [T,d], a, *, mask=None) -> (y [T,d], telemetry with
    # expert_load / overflow [E]): one MoE decode layer.
    decode_step: Callable
    # (x, w [E,K,N], plan_in, plan_out, a, *, dtype=None) -> [T_out, N]:
    # dispatch(plan_in) -> gmm -> combine(plan_out), MoA's projections.
    decode_proj: Callable
    # (params, x [T,d], plan, a, *, dtype=None) -> [T, d]: dispatch ->
    # expert FFN -> combine over one explicit plan (fused decode on a
    # mesh, the plan restricted to a rank's experts).
    routed_ffn: Callable
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
# the unfused decode compositions ("ref"'s decode_step / decode_proj)
# ---------------------------------------------------------------------------

def _decode_step_via(bk: KernelBackend, params, x, a, *, mask=None):
    """Route -> dispatch -> expert FFN -> combine through ``bk``'s ops,
    in ``moe_apply``'s order."""
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    dec = router.route(params, x, train=False, mask=mask)
    buf = bk.dispatch(x, dec, a)
    out = bk.expert_ffn(params, buf, a, rows=dec.rows)
    return bk.combine(out, dec, a, dtype=x.dtype), dec.telemetry


def _decode_proj_via(bk: KernelBackend, x, w, plan_in, plan_out, a, *,
                     dtype=None):
    """dispatch(plan_in) -> gmm -> combine(plan_out) through ``bk``'s
    ops (the MoA routed projections' sequence)."""
    buf = bk.dispatch(x, plan_in, a)
    return bk.combine(bk.gmm(buf, w, a), plan_out, a, dtype=dtype)


def _routed_ffn_via(bk: KernelBackend, params, x, p, a, *, dtype=None):
    """dispatch -> expert FFN -> combine over the plan ``p`` through
    ``bk``'s ops."""
    buf = bk.dispatch(x, p, a)
    out = bk.expert_ffn(params, buf, a, rows=None)
    return bk.combine(out, p, a, dtype=dtype)


# ---------------------------------------------------------------------------
# "ref" — plain PyTorch
# ---------------------------------------------------------------------------

def _ref_expert_ffn(params, x, a, *, rows=None, out_dtype=None):
    """The reference's order of roundings: f32 up-projections, the gate
    product in f32, one cast, the f32 down-projection, one cast (to
    ``out_dtype``, default ``a.dtype``; float32 keeps it).  Walked
    over expert chunks so weights are upcast a chunk at a time.  Rows at
    or beyond ``rows[e]`` come out as zeros, as on the kernel path."""
    with trace_lib.current().span("kernel.gmm", backend="ref",
                                  shape=tuple(x.shape)):
        dt = a.dtype
        e = x.shape[0]
        out = torch.empty((e, x.shape[1], params["w2"].shape[-1]),
                          dtype=out_dtype or dt, device=x.device)
        step = gmm_lib.expert_chunk(params["w1"].shape[1],
                                    params["w1"].shape[2])
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
            out[sl] = torch.bmm(h, params["w2"][sl].to(dt).float()).to(
                out.dtype)
        return gmm_lib.mask_rows(out, rows)


def _ref_dispatch(x, p, a):
    p = _as_plan(p)
    with trace_lib.current().span("kernel.dispatch", backend="ref",
                                  tokens=int(x.shape[0])):
        if _dispatch_impl(a) == "einsum":
            return dsp.dispatch_einsum(x, p)
        return dsp.dispatch(x, p)


def _ref_combine(buf, p, a, *, dtype=None):
    p = _as_plan(p)
    with trace_lib.current().span("kernel.combine", backend="ref",
                                  shape=tuple(buf.shape)):
        if _dispatch_impl(a) == "einsum":
            return dsp.combine_einsum(buf, p, dtype=dtype)
        return dsp.combine(buf, p, dtype=dtype)


def _ref_gmm(x, w, a):
    with trace_lib.current().span("kernel.gmm", backend="ref",
                                  shape=tuple(x.shape)):
        return gmm_lib.gmm_plain(x, w.to(x.dtype))


def _ref_decode_step(params, x, a, *, mask=None):
    with trace_lib.current().span("kernel.decode_step", backend="ref",
                                  tokens=int(x.shape[0])):
        return _decode_step_via(get("ref"), params, x, a, mask=mask)


def _ref_decode_proj(x, w, plan_in, plan_out, a, *, dtype=None):
    with trace_lib.current().span("kernel.decode_proj", backend="ref",
                                  tokens=int(x.shape[0])):
        return _decode_proj_via(get("ref"), x, w, plan_in, plan_out, a,
                                dtype=dtype)


def _ref_routed_ffn(params, x, p, a, *, dtype=None):
    with trace_lib.current().span("kernel.decode_step", backend="ref",
                                  tokens=int(x.shape[0])):
        return _routed_ffn_via(get("ref"), params, x, _as_plan(p), a,
                               dtype=dtype)


register(KernelBackend(name="ref", expert_ffn=_ref_expert_ffn,
                       dispatch=_ref_dispatch, combine=_ref_combine,
                       gmm=_ref_gmm, decode_step=_ref_decode_step,
                       decode_proj=_ref_decode_proj,
                       routed_ffn=_ref_routed_ffn, topk_impl=None))


# ---------------------------------------------------------------------------
# "cuda" — the hand-written kernels
# ---------------------------------------------------------------------------

def plan_e_block(a) -> int | None:
    """The dispatch / combine regime: ``None`` (resident kernels) or the
    expert slab forced by ``a.dispatch_e_block``."""
    forced = getattr(a, "dispatch_e_block", None)
    if forced is not None and forced < 1:
        raise KernelBackendError(
            f"dispatch_e_block must be >= 1, got {forced}")
    return forced


def _cuda_expert_ffn(params, x, a, *, rows=None, out_dtype=None):
    with trace_lib.current().span("kernel.gmm", backend="cuda",
                                  shape=tuple(x.shape)):
        return ops.expert_ffn(params, x, activation=a.activation, rows=rows,
                              out_dtype=out_dtype)


def _cuda_dispatch(x, p, a):
    p = _as_plan(p)
    with trace_lib.current().span("kernel.dispatch", backend="cuda",
                                  tokens=int(x.shape[0])):
        return ops.dispatch(x.contiguous(), p.expert_index.contiguous(),
                            p.position.contiguous(), n_experts=p.n_experts,
                            capacity=p.capacity, e_block=plan_e_block(a))


def _cuda_combine(buf, p, a, *, dtype=None):
    p = _as_plan(p)
    with trace_lib.current().span("kernel.combine", backend="cuda",
                                  shape=tuple(buf.shape)):
        return ops.combine(buf.contiguous(), p.weight.contiguous(),
                           p.expert_index.contiguous(),
                           p.position.contiguous(),
                           out_dtype=dtype or buf.dtype,
                           e_block=plan_e_block(a))


def _cuda_gmm(x, w, a):
    with trace_lib.current().span("kernel.gmm", backend="cuda",
                                  shape=tuple(x.shape)):
        return ops.gmm(x.contiguous(), w.to(x.dtype).contiguous())


def _cuda_topk(noisy, k, kk):
    w, idx, vals = ops.topk_gating(noisy, k, kk)
    return w, idx[:, :k].contiguous(), vals


def _cuda_decode_step(params, x, a, *, mask=None):
    with trace_lib.current().span("kernel.decode_step", backend="cuda",
                                  tokens=int(x.shape[0])):
        spec = router_lib.resolve_spec(a)
        t = x.shape[0]
        gated = a.activation == "swiglu"
        w3 = params["w3"] if gated else None
        x = x.contiguous()
        if spec.policy == "noisy_topk" and not spec.priority_dispatch:
            # Kernel 7: eval routing (clean-logit top-k) inside the
            # launch; the telemetry comes back as its outputs.
            valid = (torch.ones((t,), dtype=torch.float32, device=x.device)
                     if mask is None else mask.float().reshape(-1))
            y, load, overflow = ops.fused_decode_step(
                x, valid, params["gate"]["wg"], params["w1"], params["w2"],
                w3,
                k=min(spec.k, a.n_experts),
                capacity=spec.capacity(t, a.n_experts, train=False),
                activation=a.activation)
            return y, {"expert_load": load, "overflow": overflow}
        # Any other policy (expert_choice's column top-k over the batch,
        # Appendix F's batchwise / threshold, priority dispatch) routes
        # outside as plain tensor ops; kernel 8 fuses the rest.
        dec = router_lib.build(a).route(params, x, train=False, mask=mask)
        p = _as_plan(dec)
        y = ops.fused_routed_apply(x, p, p, params["w1"], params["w2"],
                                   w3, mode="ffn", activation=a.activation,
                                   out_dtype=x.dtype)
        return y, dec.telemetry


def _cuda_decode_proj(x, w, plan_in, plan_out, a, *, dtype=None):
    with trace_lib.current().span("kernel.decode_proj", backend="cuda",
                                  tokens=int(x.shape[0])):
        return ops.fused_routed_apply(x.contiguous(), _as_plan(plan_in),
                                      _as_plan(plan_out), w, mode="proj",
                                      out_dtype=dtype or x.dtype)


def _cuda_routed_ffn(params, x, p, a, *, dtype=None):
    """Kernel 8 in ``ffn`` mode on one plan."""
    with trace_lib.current().span("kernel.decode_step", backend="cuda",
                                  tokens=int(x.shape[0])):
        p = _as_plan(p)
        w3 = params["w3"] if a.activation == "swiglu" else None
        return ops.fused_routed_apply(x.contiguous(), p, p, params["w1"],
                                      params["w2"], w3, mode="ffn",
                                      activation=a.activation,
                                      out_dtype=dtype or x.dtype)


register(KernelBackend(name="cuda", expert_ffn=_cuda_expert_ffn,
                       dispatch=_cuda_dispatch, combine=_cuda_combine,
                       gmm=_cuda_gmm, decode_step=_cuda_decode_step,
                       decode_proj=_cuda_decode_proj,
                       routed_ffn=_cuda_routed_ffn, topk_impl=_cuda_topk))
