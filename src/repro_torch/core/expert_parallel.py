"""Explicit expert-parallel MoE with the paper's Sec. 3.1 communication
schedule, counterpart of ``repro.core.expert_parallel``.

The paper: "We distribute the standard layers ... according to
conventional data-parallel schemes, but keep only one shared copy of each
expert.  Each expert receives a combined batch consisting of the relevant
examples from all of the data-parallel input batches."

Each rank of a :class:`~repro_torch.sharding.context.MeshContext` holds
its tokens ``x_local [T_local, d]`` (the token sharding is over every
mesh axis), the gate in full, and its shard of the experts as
``MeshContext.shard`` cuts them by the plan: the experts dim over the
plan's ``experts`` axes (the *ep* group, ``model`` under ``dp_tp_ep``),
the other dims over theirs (``data``: FSDP).  :func:`moe_apply_ep` then

* routes the rank's tokens through the Router with the backend's top-k
  (gating is data-parallel: "the number of gating parameters is small",
  Sec. 3.2);
* dispatches them into a *global*-E buffer ``[E, C_local, d]``, with
  ``C_local`` the capacity of the rank's own tokens, as the reference;
* exchanges it with one ``all_to_all`` over the ep group, so every rank
  holds ``[E/ep, ep*C_local, d]``: the combined batch of its experts;
* gathers its experts' weights over the other axes on use (FSDP; the
  backward pass reduce-scatters their gradient), runs the expert FFN
  through the backend with ``rows=None`` (the filled rows are a prefix
  of each source's chunk, not of the combined batch), and returns the
  outputs with a second ``all_to_all``, combined locally;
* balances over the combined batch: the raw importance and load vectors
  are summed over every rank (Eqs. 6 and 11 sum over all data-parallel
  shards) and ``cv^2`` re-derived from them; the policy's extra term is
  the ranks' mean.

Each all-to-all moves ``k * T_local * capacity_factor * d`` elements a
rank (``2 * k * T * d`` per layer for the combined batch at factor 1,
independent of E).  Gate noise is the rank's rows of the global ``[T,
E]`` draw (the caller slices it), so a run on a mesh equals a
single-process run of the same global batch wherever no shard drops a
token.

Serving (:func:`moe_apply_serve`, the prefill and decode calls of the
engine on a mesh) runs another schedule.  The reference serves under
GSPMD with the global dispatch plan (capacity from all of the step's
tokens), so the port gives every rank the step's whole token set (an
all-gather over the batch axes where the decode batch is split) and
routes it: the plan is the one process's, identical on every rank.
Each rank then runs only its own experts' GMM on its slab of the
dispatched buffer (with the plan's ``rows``), the expert outputs are
all-gathered over the expert axis, and every rank runs the combine on
the whole ``[E, C, d]`` buffer.  The GMM kernels sum each row in a
fixed order with no split-K (``csrc/gmm.cu``), so a slab's rows come
out bit for bit as in the whole buffer and the MoE output on a mesh is
one process's.  Fused decode on a mesh routes the same way and runs
kernel 8 (``routed_apply``, ``ffn`` mode) on the plan restricted to
the rank's experts (:func:`local_plan`: other ranks' entries dropped,
expert ids renumbered into the slab), then sums the partial outputs
over the expert axis in f32; that sum rounds otherwise than one
launch's, so fused decode on a mesh is held to a tolerance.  Load and
overflow telemetry come from the global plan: one process's.  Weights
arrive in the serving layout (:func:`serve_layout`): every leaf whole
but the experts' FFN weights, which are the rank's slab over the
expert axis, whole over their other dims.
"""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import losses
from repro_torch.core import moe as moe_lib
from repro_torch.core import router as router_lib
from repro_torch.kernels import backend as backend_lib
from repro_torch.sharding.context import MeshContext, zip_map


def _is_expert_leaf(d: ParamDef) -> bool:
    """An expert FFN weight: :func:`moe_apply_ep` gathers it itself."""
    return "expert_embed" in d.axes


def gather_on_use(params, defs, ctx: MeshContext):
    """A model's parameters for one call on a mesh, from this rank's
    slices (``defs``: their ParamDef tree): every leaf gathered whole
    (FSDP's gather on use; the backward pass reduce-scatters its
    gradient) except the experts' FFN weights, which stay this rank's
    shards for :func:`moe_apply_ep` to gather over their non-expert
    dims.  Off-mesh the tree itself."""
    return ctx.gather(params, defs, keep=_is_expert_leaf)


def _expert_specs(a: moe_lib.MoEArgs, ctx: MeshContext) -> dict:
    """The plan's specs of the experts' FFN weights."""
    return {k: ctx.resolve(d.shape, d.axes)
            for k, d in moe_lib.moe_defs(a).items()
            if isinstance(d, ParamDef) and _is_expert_leaf(d)}


def _expert_group(a: moe_lib.MoEArgs, ctx: MeshContext, specs: dict
                  ) -> tuple[str, ...]:
    """The mesh axes that shard the experts dim (at most one), checked:
    the experts must divide over the plan's expert axes."""
    ep_axes = ctx.axes_of("experts")
    if a.n_experts % ctx.size(ep_axes) != 0:
        raise ValueError(f"n_experts={a.n_experts} must divide over "
                         f"ep={ctx.size(ep_axes)} shards ({ep_axes})")
    group = specs["w1"][0]
    if len(group) > 1:
        raise NotImplementedError(
            f"experts sharded over {group}: the schedule exchanges over "
            "one mesh axis")
    return group


@torch.no_grad()
def serve_layout(params, defs, ctx: MeshContext):
    """The serving layout of a model's parameters: every leaf whole
    except the experts' FFN weights, which are this rank's slab over the
    expert axis, whole over their other dims.  ``params`` may hold each
    leaf as this rank's slice by ``ctx``'s plan (``ctx.shard``'s cut),
    which is gathered here, or already in the serving layout, which is
    kept.  Done once when the engine is built, so no serve step gathers
    a weight.  Off-mesh the tree itself."""
    if ctx.mesh is None:
        return params

    def one(t, d):
        spec = ctx.resolve(d.shape, d.axes)
        if _is_expert_leaf(d):
            # The experts dim (after a stacked leaf's layers dim) stays.
            spec = tuple(() if ax == "experts" else s
                         for ax, s in zip(d.axes, spec))
        want = tuple(n // ctx.size(a)
                     if ax == "experts" and _is_expert_leaf(d) else n
                     for n, a, ax in zip(d.shape, ctx.resolve(d.shape,
                                                              d.axes),
                                         d.axes))
        if tuple(t.shape) == want:
            return t
        return ctx.gather_leaf(t, spec)
    return zip_map(one, params, defs)


def local_plan(p, e0: int, e_local: int):
    """The plan restricted to experts [e0, e0 + e_local), renumbered from
    0: other experts' entries are dropped (slot = capacity, weight 0,
    expert 0), which both kernel 8 and the plain ops skip."""
    e = p.expert_index.long()
    mine = (e >= e0) & (e < e0 + e_local)
    return p._replace(
        expert_index=torch.where(mine, e - e0, 0).to(torch.int32),
        position=torch.where(mine, p.position,
                             torch.full_like(p.position, p.capacity)),
        weight=torch.where(mine, p.weight, 0.0), n_experts=e_local)


def moe_apply_serve(params, x: torch.Tensor, a: moe_lib.MoEArgs,
                    ctx: MeshContext, *, mask: torch.Tensor | None = None,
                    rows_axes: tuple[str, ...] = ()
                    ) -> tuple[torch.Tensor, dict]:
    """The serving MoE on a mesh (the module docstring): ``params`` in
    the serving layout (:func:`serve_layout`), ``x`` [T, d] and ``mask``
    [T] the step's whole token set on every rank, or this rank's equal
    share of its rows, split over ``rows_axes`` (a decode step's slots,
    over the plan's ``batch`` axes).  Returns (y [T, d] for the rows given, aux with the
    global plan's telemetry; the losses and metrics of an eval call)."""
    specs = _expert_specs(a, ctx)
    group = _expert_group(a, ctx, specs)
    ep = ctx.size(group)
    e_local = a.n_experts // ep
    e0 = ctx.index(group) * e_local
    t_local = x.shape[0]
    x_all = ctx.all_gather(x, rows_axes, 0)
    if mask is not None:
        mask = ctx.all_gather(mask.reshape(-1), rows_axes, 0)
    bk = backend_lib.resolve(a)
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    dec = router.route(params, x_all, train=False, mask=mask)
    w = {k: params[k] for k in specs}
    if a.fused_decode:
        part = bk.routed_ffn(w, x_all, local_plan(dec.plan, e0, e_local), a,
                             dtype=torch.float32)
        y = ctx.all_reduce(part, group).to(x.dtype)
    else:
        buf = bk.dispatch(x_all, dec, a)                   # [E, C, d]
        rows = None if dec.rows is None else dec.rows[e0:e0 + e_local]
        out = bk.expert_ffn(w, buf[e0:e0 + e_local], a, rows=rows)
        out = ctx.all_gather(out, group, 0)
        y = bk.combine(out, dec, a, dtype=x.dtype)
    if rows_axes:
        y = y.narrow(0, ctx.index(rows_axes) * t_local, t_local)
    if a.sigmoid_output:
        y = torch.sigmoid(y.float()).to(x.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, {"aux_loss": zero,
               "metrics": {k: zero for k in moe_lib.ZERO_METRICS},
               "telemetry": dec.telemetry}


def moe_apply_ep(params, x: torch.Tensor, a: moe_lib.MoEArgs,
                 ctx: MeshContext, *, train: bool = True,
                 noise: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, dict]:
    """Expert-parallel MoE over this rank's tokens ``x`` [T_local, d].

    ``params``: the gate (and an Appendix-F policy's thresholds) in full,
    ``w1`` / ``w2`` (/ ``w3``) as this rank's shards.  ``noise``
    [T_local, E] and ``mask`` [T_local] are the rank's rows of the
    global ones.  Returns (y [T_local, d], aux) with the combined
    batch's ``aux_loss`` and metrics, the same on every rank."""
    specs = _expert_specs(a, ctx)
    ep_group = _expert_group(a, ctx, specs)
    ep = ctx.size(ep_group)
    if a.fused_decode and not train:
        # A decode-shaped eval call: the serving schedule over the
        # tokens of every rank (its fused path), the experts gathered
        # whole over their non-expert dims first.
        w = {k: ctx.gather_leaf(params[k], ((),) + spec[1:])
             for k, spec in specs.items()}
        return moe_apply_serve(dict(params, **w), x, a, ctx, mask=mask,
                               rows_axes=ctx.free_axes)
    e_local = a.n_experts // ep
    bk = backend_lib.resolve(a)
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    dec = router.route(params, x, train=train, noise=noise, mask=mask)
    p = dec.plan
    cap, d = p.capacity, x.shape[-1]

    buf = bk.dispatch(x, dec, a)                       # [E, C, d]
    if ep_group:
        # [E, C, d] -> chunk j (experts of ep-rank j) to ep-rank j; the
        # chunks received, in source order, are [ep, e_local, C, d].
        buf = ctx.all_to_all(buf, ep_group[0])
    buf = buf.reshape(ep, e_local, cap, d).transpose(0, 1).reshape(
        e_local, ep * cap, d)

    # FSDP: the rank's experts gathered whole over their other dims.
    w_local = {k: ctx.gather_leaf(params[k], ((),) + spec[1:])
               for k, spec in specs.items()}
    out = bk.expert_ffn(w_local, buf, a, rows=None)

    out = out.reshape(e_local, ep, cap, d).transpose(0, 1).reshape(
        a.n_experts, cap, d)
    if ep_group:
        out = ctx.all_to_all(out, ep_group[0])
    y = bk.combine(out, dec, a, dtype=x.dtype)
    if a.sigmoid_output:
        y = torch.sigmoid(y.float()).to(x.dtype)
    return y, combined_batch_aux(dec, router.spec, ctx)


def combined_batch_aux(dec: router_lib.RouteDecision,
                       spec: router_lib.RouterSpec,
                       ctx: MeshContext) -> dict:
    """The balancing losses and Table-6 metrics of the combined batch
    from one rank's routing decision: importance, load, the policy's
    extra term and the dropped fraction summed over every rank in one
    all-reduce; ``cv^2`` re-derived from the summed vectors (a mean of
    per-rank CVs is not the batch's: a rank that sends all its tokens to
    one expert is maximally skewed while the combined batch may be
    balanced, and expert_choice's per-rank load is uniform by
    construction)."""
    e = dec.load.shape[-1]
    local_balance = (losses.importance_loss(dec.gates, spec.w_importance)
                     + losses.load_loss(dec.load, spec.w_load))
    extra = dec.aux_loss - local_balance          # exact: same recompute
    packed = torch.cat([losses.importance(dec.gates), dec.load.float(),
                        extra.reshape(1).float(),
                        dec.plan.fraction_dropped.reshape(1).float()])
    total = ctx.all_reduce(packed)
    imp, load = total[:e], total[e:2 * e]
    n = float(ctx.world)
    aux_loss = (spec.w_importance * losses.cv_squared(imp)
                + spec.w_load * losses.cv_squared(load)
                + total[2 * e] / n)
    metrics = {
        "cv_importance": torch.sqrt(losses.cv_squared(imp)),
        "cv_load": torch.sqrt(losses.cv_squared(load)),
        "max_over_mean_load": torch.amax(load) / torch.clamp(
            torch.mean(load), min=1e-9),
        "fraction_dropped": total[2 * e + 1].detach() / n,
    }
    return {"aux_loss": aux_loss, "metrics": metrics}
