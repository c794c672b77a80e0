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
"""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import losses
from repro_torch.core import moe as moe_lib
from repro_torch.core import router as router_lib
from repro_torch.kernels import backend as backend_lib
from repro_torch.sharding.context import MeshContext


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
    defs = moe_lib.moe_defs(a)
    specs = {k: ctx.resolve(d.shape, d.axes) for k, d in defs.items()
             if isinstance(d, ParamDef) and _is_expert_leaf(d)}
    # The plan's expert axes on this mesh; the experts must divide over
    # them (the spec would fall back to replicated experts).
    ep_axes = [ax for ax in ctx.rules.lookup("experts") if ax in ctx.sizes]
    if a.n_experts % ctx.size(ep_axes) != 0:
        raise ValueError(f"n_experts={a.n_experts} must divide over "
                         f"ep={ctx.size(ep_axes)} shards ({ep_axes})")
    ep_group = specs["w1"][0]         # the mesh axes of the experts dim
    if len(ep_group) > 1:
        raise NotImplementedError(
            f"experts sharded over {ep_group}: the schedule exchanges over "
            "one mesh axis")
    ep = ctx.size(ep_group)
    if a.fused_decode and not train:
        raise NotImplementedError(
            "fused decode is not distributed: it runs on one process")
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
