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
independent of E).  Gate noise is the rank's tokens of the global
``[T, E]`` draw (the caller slices it), so a run on a mesh equals a
single-process run of the same global batch wherever no shard drops a
token.  A rank whose rows are whole on several ranks (a microbatch of
fewer rows than ranks: ``MeshContext.split_rows``) routes its
contiguous share of their tokens and all-gathers the output over those
ranks.

Serving (:func:`moe_apply_serve`, the prefill and decode calls of the
engine on a mesh) runs another schedule.  The reference serves under
GSPMD with the global dispatch plan (capacity from all of the step's
tokens), so the port gives every rank the step's whole token set (an
all-gather over the batch axes where the decode batch is split) and
routes it: the plan is the one process's, identical on every rank.
Weights arrive in the serving layout (:func:`serve_layout`): every
leaf whole but the experts' FFN weights, which are the rank's block
over ``experts`` and ``expert_mlp``, as the reference's serving plans
lay them out (``expert_mlp`` over ``data``: tensor parallelism within
each expert).  Each rank then runs its own experts' GMMs on its slab of
the dispatched buffer (with the plan's ``rows``) over its slice of
each expert's d_ff.  Where ``expert_mlp`` splits d_ff, the
down-projection comes out in f32 (kernel 6's ``out_dtype``), that
partial ``[n, C, d]`` is all-reduced over the ``expert_mlp`` axes and
cast once to the buffer's dtype; the expert outputs are then
all-gathered over the expert axis, and every rank runs the combine on
the whole ``[E, C, d]`` buffer.  The GMM kernels sum each row in a
fixed order with no split-K (``csrc/gmm.cuh``), so where d_ff is whole
a slab's rows come out bit for bit as in the whole buffer and the MoE
output on a mesh is one process's; a sum split over d_ff rounds
otherwise, so a mesh with ``data`` > 1 is held to a tolerance.  Fused
decode on a mesh routes the same way and runs kernel 8
(``routed_apply``, ``ffn`` mode) on the plan restricted to the rank's
experts (:func:`local_plan`: other ranks' entries dropped, expert ids
renumbered into the slab) with its d_ff slice of the weights, then sums
the partial outputs over the expert and ``expert_mlp`` axes in f32, in
one all-reduce; that sum rounds otherwise than one launch's, so fused
decode on a mesh is held to a tolerance.  Where ``expert_mlp`` has one
shard every path is the one above with d_ff whole: no f32 output and
no new collective.  Load and overflow telemetry come from the global
plan: one process's.  MoA's routed projections (whose d_ff is the
heads' width, which feeds attention) and the hierarchical MoE's groups
keep the slab over their expert dim, whole over the other dims.

MoA's two routed projections and the hierarchical MoE's groups run the
serving schedule in training too (:class:`GlobalPlan`), where the
reference's mesh run is its one process (GSPMD over the one-process
code, capacity from the global token count): the tokens are
all-gathered over the axes that split them (autograd-aware, so the
backward pass reduce-scatters their gradient), every rank routes the
global plan, runs its slab of the experts on it and all-gathers the
slab outputs over the expert axis before the combine.  The plan, the
drops and the balance statistics are one process's on every rank; a
rank keeps its own rows of the output.  Its wire cost is the tokens
plus the ``[E, C, ·]`` outputs, more than :func:`moe_apply_ep`'s two
all-to-alls, so the flat MoE keeps its per-shard capacity.  Where the
expert dim does not divide over its mesh axis the plan's resolution
falls back to replicated experts (every rank runs them all), as the
reference's ``resolve_spec`` does.

Where a step holds its rows whole over some axes, the dense layers run
tensor-parallel over them (``MeshContext.tp_axes``): :func:`gather_on_use`
with ``tp`` and :func:`serve_layout` on a prefill step's context keep
those dense dims as the rank's slices.
"""
from __future__ import annotations

import dataclasses

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


def gather_on_use(params, defs, ctx: MeshContext, tp: bool = False):
    """A model's parameters for one call on a mesh, from this rank's
    slices (``defs``: their ParamDef tree): every leaf gathered whole
    (FSDP's gather on use; the backward pass reduce-scatters its
    gradient) except the experts' FFN weights, which stay this rank's
    shards for :func:`moe_apply_ep` to gather over their non-expert
    dims.  With ``tp`` (the transformer's loss, whose dense layers run
    tensor-parallel where a step holds its rows whole) the dense dims of
    attention, the dense FFN, the embedding and the unembedding that run
    tensor-parallel (``MeshContext.tp_axes``) stay this rank's slices
    too, gathered over their other dims only.  Off-mesh the tree
    itself."""
    if not tp or ctx.mesh is None:
        return ctx.gather(params, defs, keep=_is_expert_leaf)

    def walk(p, d, layer):      # layer: the key of the dict holding d
        if isinstance(d, dict):
            return {k: walk(p[k], d[k], k if isinstance(d[k], dict)
                            else layer) for k in sorted(d)}
        if _is_expert_leaf(d):
            return p
        return _block(p, d, ctx.resolve(d.shape, d.axes),
                      _tp_dims(d, layer, ctx), ctx)
    return walk(params, defs, None)


# The layers whose dense dims run tensor-parallel where a step holds its
# rows whole (``MeshContext.tp_axes``); MoA's projections, mamba's and
# the experts' keep their own layouts.
_TP_LAYERS = ("attn", "mlp", "embed", "unembed")


def _tp_dims(d: ParamDef, layer: str | None, ctx: MeshContext
             ) -> tuple[str, ...]:
    """The logical axes of a leaf of ``layer`` (the key of the dict that
    holds it) that run tensor-parallel on ``ctx``."""
    if layer not in _TP_LAYERS:
        return ()
    return tuple(a for a, n in zip(d.axes, d.shape) if ctx.tp_axes(a, n))


# The logical axes of an expert leaf's expert dims (the flat MoE's and
# MoA's ``experts``, the hierarchical MoE's ``expert_groups``): serving
# keeps them as this rank's slab.
_EXPERT_DIMS = ("experts", "expert_groups")
# The flat MoE's FFN leaves also keep their ``expert_mlp`` dim (d_ff) as
# this rank's slice: the reference's tensor parallelism within each
# expert.
_TP_DIMS = _EXPERT_DIMS + ("expert_mlp",)


def _block(t: torch.Tensor, d: ParamDef, spec, dims, ctx: MeshContext,
           start: int = 0) -> torch.Tensor:
    """``t`` (each dim whole or this rank's slice by ``spec``, the
    plan's cut) as this rank's block over the dims whose logical axis
    is in ``dims`` and whole over the others, from dim ``start`` on: a
    slice that should be whole is gathered (autograd-aware), a whole dim
    that should be a block is cut to this rank's block."""
    cut = False
    for dim in range(start, len(spec)):
        n, s = d.shape[dim], spec[dim]
        if d.axes[dim] in dims and t.shape[dim] == n and ctx.size(s) > 1:
            m = n // ctx.size(s)
            t, cut = t.narrow(dim, ctx.index(s) * m, m), True
        elif d.axes[dim] not in dims and t.shape[dim] != n:
            t = ctx.all_gather(t, s, dim)
    return t.contiguous() if cut else t


def _expert_specs(defs: dict, ctx: MeshContext) -> dict:
    """The plan's specs of a layer's expert leaves (``defs``: the
    layer's ParamDef dict)."""
    return {k: ctx.resolve(d.shape, d.axes) for k, d in defs.items()
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
    except the expert leaves, which are this rank's block.  The flat
    MoE's FFN leaves (``w1`` / ``w2`` / ``w3`` of a ``moe`` layer
    without ``expert_groups``) are its block over ``experts`` and
    ``expert_mlp`` (the reference's ``expert_mlp`` over ``data``: each
    rank runs a d_ff slice of its experts, :func:`moe_apply_serve`),
    whole over ``expert_embed``; MoA's routed projections (the same
    axes, under ``moa``: their d_ff is the heads' width, which feeds
    attention) and the hierarchical MoE's leaves are the slab over
    their expert dim (``experts``, or ``expert_groups`` where the
    groups take the expert axis), whole over their other dims.  A
    prefill step's context that holds its rows whole over some axes
    (``launch/steps.py::prefill_rows``) also keeps the dense dims that
    run tensor-parallel there as this rank's slices
    (``MeshContext.tp_axes``, as :func:`gather_on_use` with ``tp``); the
    engine's contexts keep them whole.  A dim
    that does not divide over its axes is whole, as the plan's
    resolution falls back.  Each dim of a leaf in ``params`` may be
    whole or this rank's slice by ``ctx``'s plan (``ctx.shard``'s cut):
    a slice the layout keeps whole is gathered, a whole dim the layout
    keeps as a block is cut to this rank's block, the rest is kept (so
    the full tree, the plan's slices and the serving layout all give
    the serving layout).  Done once when the engine is built, so no
    serve step gathers a weight.  Off-mesh the tree itself."""
    if ctx.mesh is None:
        return params

    def one(t, d, layer):
        if not _is_expert_leaf(d):
            dims = _tp_dims(d, layer, ctx)
        elif layer == "moe" and "expert_groups" not in d.axes:
            dims = _TP_DIMS
        else:
            dims = _EXPERT_DIMS
        return _block(t, d, ctx.resolve(d.shape, d.axes), dims, ctx)

    def walk(p, d, layer):      # layer: the key of the dict d
        return {k: walk(p[k], d[k], k) if isinstance(d[k], dict)
                else one(p[k], d[k], layer) for k in sorted(d)}
    return walk(params, defs, None)


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


@dataclasses.dataclass(frozen=True)
class GlobalPlan:
    """A routed layer's global plan on one rank (the module docstring):
    the step's tokens gathered over ``token_axes``, this rank's experts
    ``[e0, e0 + n)`` of the leading expert dim, split over
    ``expert_axes`` (``()``: every rank holds them all), and, for the
    flat MoE served tensor-parallel, its slice of d_ff, split over
    ``mlp_axes`` (``()``: d_ff whole, or on one rank).  ``ctx`` None
    is one process: every method is then the one-process op."""
    ctx: MeshContext | None
    token_axes: tuple[str, ...]
    expert_axes: tuple[str, ...]
    e0: int
    n: int
    # key -> (ParamDef, spec) of the layer's expert leaves
    leaves: dict
    mlp_axes: tuple[str, ...] = ()

    @classmethod
    def build(cls, ctx: MeshContext | None, defs: dict, n_experts: int,
              token_axes=None, tp: bool = False) -> "GlobalPlan":
        """The plan of a layer with ParamDefs ``defs`` whose expert dim
        (dim 0 of its expert leaves) holds ``n_experts``; ``token_axes``
        the mesh axes this rank's rows are split over (None: a training
        step's, ``ctx.rows_over``; a rank that holds its rows whole on
        several ranks gathers them over the row axes only).  ``tp``:
        the layer runs this rank's slice of each expert's d_ff (the flat
        MoE's serving layout, :func:`serve_layout`) where its
        ``expert_mlp`` dim is split over more than one rank."""
        if ctx is None or ctx.mesh is None:
            return cls(None, (), (), 0, n_experts, {})
        specs = _expert_specs(defs, ctx)
        axes = next(iter(specs.values()))[0]
        if len(axes) > 1:
            raise NotImplementedError(
                f"experts sharded over {axes}: the schedule gathers over "
                "one mesh axis")
        mlp: tuple[str, ...] = ()
        if tp:
            mlp = specs["w1"][defs["w1"].axes.index("expert_mlp")]
            mlp = mlp if ctx.size(mlp) > 1 else ()
        n = n_experts // ctx.size(axes)
        return cls(ctx, ctx.rows_over if token_axes is None
                   else tuple(token_axes), axes, ctx.index(axes) * n, n,
                   {k: (defs[k], s) for k, s in specs.items()}, mlp)

    def gather(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """This rank's rows -> the step's rows (in ``ctx.local_rows``'s
        order)."""
        if t is None or self.ctx is None:
            return t
        return self.ctx.all_gather(t, self.token_axes, 0)

    def own(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        """The step's rows -> this rank's ``rows`` of them."""
        if self.ctx is None or t.shape[0] == rows:
            return t
        return t.narrow(0, self.ctx.index(self.token_axes) * rows, rows)

    def weights(self, params: dict) -> dict:
        """The layer's expert leaves as this rank's slab (and d_ff
        slice, where ``mlp_axes`` split it), whole over their other
        dims (:func:`_block` from dim 1): a training shard is gathered
        over them (FSDP; the backward pass reduce-scatters), a leaf
        already in the serving layout kept."""
        out = dict(params)
        dims = ("expert_mlp",) if self.mlp_axes else ()
        for k, (d, spec) in self.leaves.items():
            out[k] = _block(params[k], d, spec, dims, self.ctx, start=1)
        return out

    def slab(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a tensor with a leading expert dim."""
        return t if t.shape[0] == self.n else t.narrow(0, self.e0, self.n)

    def apply(self, x_all: torch.Tensor, plan, a, ffn, *, out_plan=None,
              dtype=None) -> torch.Tensor:
        """dispatch ``x_all`` by ``plan`` into ``[E, C, ·]``, ``ffn`` on
        this rank's slab ``[n, C, ·]`` (a d_ff slice's f32 partial sums,
        summed over ``mlp_axes`` and cast once to the buffer's dtype),
        the slab outputs all-gathered over the expert axis, combined by
        ``out_plan`` (default ``plan``): the step's rows."""
        bk = backend_lib.resolve(a)
        # The slab is a view: no name holds the dispatch buffer past ffn.
        out = ffn(self.slab(bk.dispatch(x_all, plan, a)))
        if self.mlp_axes:
            out = self.ctx.all_reduce(out, self.mlp_axes).to(x_all.dtype)
        if self.ctx is not None:
            out = self.ctx.all_gather(out, self.expert_axes, 0)
        return bk.combine(out, plan if out_plan is None else out_plan, a,
                          dtype=dtype)

    def local(self, p):
        """The plan restricted to this rank's experts (kernel 8's)."""
        return p if self.ctx is None else local_plan(p, self.e0, self.n)

    def reduce(self, part: torch.Tensor) -> torch.Tensor:
        """Sum the ranks' partial outputs over the expert axis and the
        d_ff slices, in one all-reduce."""
        if self.ctx is None:
            return part
        return self.ctx.all_reduce(part, self.expert_axes + self.mlp_axes)

    def gather_experts(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a per-expert statistic -> every
        expert's."""
        if self.ctx is None:
            return t
        return self.ctx.all_gather(t, self.expert_axes, 0)


def moe_apply_serve(params, x: torch.Tensor, a: moe_lib.MoEArgs,
                    ctx: MeshContext, *, mask: torch.Tensor | None = None,
                    rows_axes: tuple[str, ...] = ()
                    ) -> tuple[torch.Tensor, dict]:
    """The serving MoE on a mesh (the module docstring): ``params`` in
    the serving layout (:func:`serve_layout`) or this rank's training
    shards, ``x`` [T, d] and ``mask`` [T] the step's whole token set on
    every rank, or this rank's equal share of its rows, split over
    ``rows_axes`` (a decode step's slots, over the plan's ``batch``
    axes; a prefill step's rows, over the axes ``launch/steps.py::
    prefill_rows`` splits them over).  Returns (y [T, d] for the rows
    given, aux with the global plan's telemetry; the losses and metrics
    of an eval call)."""
    defs = moe_lib.moe_defs(a)
    _expert_group(a, ctx, _expert_specs(defs, ctx))
    gp = GlobalPlan.build(ctx, defs, a.n_experts, rows_axes, tp=True)
    x_all = gp.gather(x)
    mask = gp.gather(None if mask is None else mask.reshape(-1))
    bk = backend_lib.resolve(a)
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    dec = router.route(params, x_all, train=False, mask=mask)
    w = gp.weights(params)
    if a.fused_decode:
        part = bk.routed_ffn(w, x_all, gp.local(dec.plan), a,
                             dtype=torch.float32)
        y = gp.reduce(part).to(x.dtype)
    else:
        rows = None if dec.rows is None else gp.slab(dec.rows)
        # A d_ff slice's partial sums stay f32 until gp.apply sums them.
        out_dtype = torch.float32 if gp.mlp_axes else None
        y = gp.apply(x_all, dec, a, lambda buf: bk.expert_ffn(
            w, buf, a, rows=rows, out_dtype=out_dtype), dtype=x.dtype)
    y = gp.own(y, x.shape[0])
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
    [T_local / M, E] is the rank's share of the global one
    (``ctx.local_tokens``) and ``mask`` [T_local] its rows'.  Where
    ``ctx`` holds the rows whole on M ranks (``ctx.whole_over``), the
    layer runs on this rank's contiguous share of ``x``'s tokens and
    all-gathers its output over those ranks (the reference's ``tokens``
    axis: its entry reshard a slice, its exit one all-gather).
    Returns (y [T_local, d], aux) with the combined batch's
    ``aux_loss`` and metrics, the same on every rank."""
    whole = ctx.whole_over
    if whole:
        m = x.shape[0] // ctx.size(whole)
        i = ctx.index(whole) * m
        y, aux = moe_apply_ep(
            params, x.narrow(0, i, m), a,
            dataclasses.replace(ctx, row_axes=None), train=train,
            noise=noise, mask=None if mask is None else mask.narrow(0, i, m))
        return ctx.all_gather(y, whole, 0), aux
    specs = _expert_specs(moe_lib.moe_defs(a), ctx)
    ep_group = _expert_group(a, ctx, specs)
    ep = ctx.size(ep_group)
    if a.fused_decode and not train:
        # A decode-shaped eval call: the serving schedule over the
        # tokens of every rank (its fused path; it gathers the experts
        # over expert_embed and keeps their d_ff slices).
        return moe_apply_serve(params, x, a, ctx, mask=mask,
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
