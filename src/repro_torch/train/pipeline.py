"""Pipeline parallelism (the GPipe schedule) for the layer stack,
counterpart of ``repro.train.pipeline``, on ``torch.distributed``.

As in the reference:

* mesh axes: the ``data`` axis is the stage ring; ``model`` stays
  expert-parallel inside each stage.  The stage body runs under
  ``ctx.manual(stage_axis)``, so a MoE layer in it runs the
  expert-parallel schedule (``core/expert_parallel.py::moe_apply_ep``)
  over ``model`` and its balance statistics span the stage's ranks;
* layers: stacked ``[n_stages, layers_per_stage, ...]`` with the leading
  dim over the stage axis (each rank holds its stage's ``[1, per, ...]``
  slice).  Ragged depths pad to the next multiple with identity layers
  (:func:`zero_identity_padding`: zero output projections make a
  residual block the identity);
* schedule: ``T = n_micro + n_stages - 1`` ticks; at each tick every
  stage shifts its last output to the next stage and runs one
  microbatch.  The shift (``MeshContext.shift``) is an autograd Function
  whose backward pass is the reverse shift, so the backward pipeline
  comes out of autograd as it does out of ``ppermute``'s transpose;
* embedding and the chunked cross-entropy stay outside the pipelined
  region; the outputs reach every stage by a masked sum over the stage
  axis, and the aux losses are summed over live ticks, summed over the
  stage axis and divided by ``n_micro``.

Where the port differs from the reference's SPMD body:

* The stage axis is held by the pipeline, not by the plan: the plans
  map the ``stage`` and ``layers`` logical axes to nothing (as the
  reference's ``resolve_spec`` does), and :func:`pipeline_context` adds
  ``stage -> stage_axis`` for the pipeline's own trees, so
  ``MeshContext.shard`` / ``gather``, the trainer's replica sums and the
  shard-aware optimizer cut and update them like any other tree.
* Within a stage the rows split by ``MeshContext.split_rows``: each
  ``model`` rank takes its share of every microbatch's rows where they
  divide, else holds them whole and its flat MoE layers take its share
  of their tokens (the reference's body holds the microbatch whole on
  every model rank and lets GSPMD split the MoE's tokens).  The MoE's
  combined batch is the stage's whole microbatch either way, so its
  capacity and balance losses are per microbatch, as the reference's;
  MoA mixers and the hierarchical MoE route the whole microbatch on
  every ``model`` rank (their global plan, gathered over the rows'
  axes of the stage: ``model`` or none).  Where the rows are whole on
  ``model`` the stage's attention and dense FFN run tensor-parallel
  over it (``MeshContext.tp_axes``: the stage's gather keeps those dims
  as the rank's slices), as a training step's do; the embedding and
  the loss outside the pipelined region keep the vocabulary whole.
* Bubble ticks run no layer (the reference computes them and masks the
  result): a stage that is not live passes its input through.  Every
  rank still calls every shift, in the same order, so the collectives
  of the stage ring match; stage 0 adds the zeros it receives to its
  microbatch, so its shift is part of the graph on every rank and the
  reverse shift runs everywhere.
* Gate noise comes in as tensors (the port's convention): per
  (microbatch, stage, layer) ``draws["noise"][mb][stage][layer]``, the
  MoE's ``[B_mb * S, E]`` draw (the hierarchical MoE's two-level dict),
  and ``draws["moa_noise"][mb][stage][layer]``, an MoA mixer's ``[B_mb
  * S, moa_experts]``; the tests pass the reference's ``fold_in(rng, mb
  * n_stages + stage)`` then ``fold_in(layer)`` draws (MoA's from
  ``fold_in(·, 1)`` of the layer's key, the hierarchical MoE's from the
  split of it), and :func:`make_draws` draws them from a generator.
  The flat MoE keeps the rank's tokens of its draw; MoA's and the
  hierarchical MoE's stay whole (``sharding.context.local_draws``).
* ``cfg.remat`` checkpoints each layer (the port's decision of PR 22),
  where the reference checkpoints the stage body.

Loss scale: every rank computes the loss of its rows after the masked
stage sum, and a step back-propagates ``loss / world`` on each rank.
The backward pass of the stage sum adds the ``n_stages`` ranks'
cotangents (``n_stages / world = 1 / model`` of each column's loss
reaches the last stage), and the trainer's replica sums
(``_sum_replicas``) add what the ranks of a replicated leaf computed,
so every gradient is the gradient of the mean loss over the ranks.
Rows held whole on the ``model`` ranks keep the rule, as in the
trainer (``train/trainer.py``'s docstring): each of the M copies of a
row counts 1/world, M / world of it in all, its weight among the
``model / M`` row groups.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import param as pm
from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.models import layers, lm, transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import partition
from repro_torch.sharding.context import MeshContext, local_draws, on_mesh
from repro_torch.train import trainer as trainer_lib


def stages_for(cfg: ModelConfig, n_stages: int) -> tuple[int, int]:
    """(layers_per_stage, padded_total)."""
    per = -(-cfg.n_layers // n_stages)
    return per, per * n_stages


def pipeline_block_defs(cfg: ModelConfig, n_stages: int) -> dict:
    """Stacked [n_stages, layers_per_stage, ...] block params (homogeneous
    stacks only, as in the reference)."""
    if cfg.period != 1:
        raise ValueError(
            f"pipeline stages require homogeneous layers (period=1), got "
            f"period={cfg.period}")
    per, _ = stages_for(cfg, n_stages)
    one = transformer.block_defs(cfg, layer_kinds(cfg)[0])
    return pm.tree_map(
        lambda d: pm.ParamDef((n_stages, per) + d.shape,
                              ("stage", "layers") + d.axes, init=d.init,
                              dtype=d.dtype, fan_in=d.fan_in), one)


# The output projection of each mixer / FFN: zero, it makes the block
# an exact identity (residual + zero update).
_OUT_PROJ = (("attn", "wo"), ("moe", "w2"), ("mlp", "w2"),
             ("mamba", "out_proj"))


def zero_identity_padding(params, cfg: ModelConfig, n_stages: int):
    """Zero the output projections of the padding layers (the layers past
    ``cfg.n_layers`` of the stacked ``[n_stages, per, ...]`` blocks) so
    they are exact identities.  Returns a new tree (the zeroed leaves are
    copies)."""
    per, total = stages_for(cfg, n_stages)
    out = dict(params)
    if total == cfg.n_layers:
        return out
    for sub, name in _OUT_PROJ:
        if sub in params:
            leaf = params[sub][name].clone()
            leaf.reshape((total,) + leaf.shape[2:])[cfg.n_layers:] = 0
            out[sub] = dict(params[sub], **{name: leaf})
    return out


def pipeline_param_defs(cfg: ModelConfig, n_stages: int) -> dict:
    defs = lm.lm_defs(cfg)
    defs["blocks"] = pipeline_block_defs(cfg, n_stages)
    return defs


def pipeline_context(ctx: MeshContext, stage_axis: str = "data"
                     ) -> MeshContext:
    """``ctx`` with the pipeline's stage axis in its plan: the ``stage``
    logical axis (the stacked blocks' leading dim) over ``stage_axis``.
    Its ``shard`` / ``gather`` / ``specs`` cut the pipeline's trees."""
    table = dict(ctx.rules.table, stage=(stage_axis,))
    return ctx.with_plan(partition.ShardingRules(
        table=table, name=f"{ctx.rules.name}+stage"))


def make_draws(cfg: ModelConfig, n_micro: int, n_stages: int,
               micro_batch: int, seq_len: int, generator: torch.Generator,
               device) -> dict:
    """One step's gate noise for the whole microbatches: ``noise[mb]
    [stage][layer]``, an MoE layer's (``transformer.moe_noise``: [T, E],
    or the hierarchical MoE's two-level dict), and ``moa_noise[mb]
    [stage][layer]``, an MoA mixer's [T, moa_experts], T = micro_batch *
    seq_len; None elsewhere.  Drawn layer by layer in that order, the
    MoE's before MoA's (every rank draws them all and keeps its
    share)."""
    per, _ = stages_for(cfg, n_stages)
    kind = layer_kinds(cfg)[0]
    moe = kind.ffn in ("moe", "moe+dense")
    t = micro_batch * seq_len
    noise = [[[None] * per for _ in range(n_stages)] for _ in range(n_micro)]
    moa = [[[None] * per for _ in range(n_stages)] for _ in range(n_micro)]
    for mb in range(n_micro):
        for sid in range(n_stages):
            for i in range(per):
                if moe:
                    noise[mb][sid][i] = transformer.moe_noise(
                        cfg, t, generator, device)
                if kind.mixer == "moa":
                    moa[mb][sid][i] = torch.randn(
                        (t, cfg.moa_experts), generator=generator,
                        device=device)
    return {"noise": noise, "moa_noise": moa}


def _check_mesh(ctx: MeshContext | None, n_stages: int, stage_axis: str):
    if not on_mesh(ctx):
        raise ValueError("the pipeline runs on a mesh (ctx with a mesh)")
    if ctx.sizes.get(stage_axis) != n_stages:
        raise ValueError(f"n_stages={n_stages} must equal the size of the "
                         f"stage axis {stage_axis!r} ({ctx.sizes})")


def pipeline_stack_apply(block_params, x_mb, cfg: ModelConfig, *,
                         ctx: MeshContext, n_stages: int,
                         stage_axis: str = "data", positions, draws=None,
                         train: bool = True, rows: int | None = None):
    """Run the pipelined layer stack on this rank.

    ``block_params``: this rank's ``[1, per, ...]`` stage slice, whole
    but for the experts' FFN weights (this rank's shard over ``model``).
    ``x_mb``: [n_micro, B_local, S, d], this rank's rows of every
    microbatch of ``rows`` rows, split over the stage's ``model`` ranks
    by ``MeshContext.split_rows`` (None: B_local times those ranks, a
    split that divides).  ``draws``: :func:`make_draws`'s (the global
    microbatch's; each rank keeps its share) or None.  Returns (y_mb
    [n_micro, B_local, S, d], aux_loss scalar)."""
    _check_mesh(ctx, n_stages, stage_axis)
    pp = pipeline_context(ctx, stage_axis)
    n_micro, b_local, s = x_mb.shape[:3]
    stage_ctx = pp.manual(stage_axis)
    stage_ctx = stage_ctx.split_rows(
        b_local * stage_ctx.world if rows is None else rows, s)
    kind = layer_kinds(cfg)[0]
    per, _ = stages_for(cfg, n_stages)
    sid = pp.index((stage_axis,))
    last = n_stages - 1
    stage_layers = transformer._unstack(
        pm.tree_map(lambda t: t.squeeze(0), block_params), per)
    # The global plans' noise stays whole (they route the whole
    # microbatch on every model rank); the flat MoE's is the rank's.
    whole = ("moa_noise",) + (("noise",) if cfg.moe_hierarchical else ())
    if (draws is not None and kind.mixer == "moa"
            and "moa_noise" not in draws):
        raise ValueError("draws for a config with MoA mixers need "
                         "'moa_noise' (see make_draws)")

    def layer(x, aux, block, noise, moa_noise):
        x, a = transformer.block_apply(block, x, kind, cfg,
                                       positions=positions, noise=noise,
                                       moa_noise=moa_noise, train=train,
                                       ctx=stage_ctx)
        return x, aux if a is None else aux + a["aux_loss"]

    def stage_body(x, mb):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(stage_layers):
            got = {"noise": None, "moa_noise": None}
            if draws is not None:
                got = local_draws({k: draws[k][mb][sid][i] for k in got
                                   if k in draws}, stage_ctx, whole=whole)
            args = (x, aux, block, got.get("noise"), got.get("moa_noise"))
            if cfg.remat:
                x, aux = checkpoint(layer, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = layer(*args)
        return x, aux

    state = x_mb[0] * 0.0
    aux_total = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    outs = []
    for t in range(n_micro + n_stages - 1):
        recv = pp.shift(state, stage_axis)
        # Stage 0 receives zeros: adding them keeps its shift in the
        # graph, so the reverse shift runs on every rank.
        x_in = recv + x_mb[min(t, n_micro - 1)] if sid == 0 else recv
        mb = t - sid
        if 0 <= mb < n_micro:
            y, aux = stage_body(x_in, mb)
            aux_total = aux_total + aux
        else:
            y = x_in                      # a bubble tick runs no layer
        if t >= last:
            outs.append(y)
        state = y
    y_mb = torch.stack(outs) * (1.0 if sid == last else 0.0)
    y_mb = pp.all_reduce(y_mb, (stage_axis,))
    aux = pp.all_reduce(aux_total.reshape(1), (stage_axis,))[0] / n_micro
    return y_mb, aux


def pipeline_lm_loss(params, batch: dict, cfg: ModelConfig, *,
                     ctx: MeshContext, n_stages: int, n_micro: int,
                     stage_axis: str = "data", draws: dict | None = None,
                     generator: torch.Generator | None = None,
                     train: bool = True):
    """The LM loss with the block stack pipelined.

    ``params``: this rank's slices of the :func:`pipeline_param_defs`
    tree (``pipeline_context(ctx).shard``'s cut), gathered here on use
    (the experts stay shards).  ``batch``: the global tokens / labels
    [B, S]; B splits into ``n_micro`` microbatches of consecutive rows,
    of which each ``model`` rank takes its share where they divide, and
    else holds them whole (``MeshContext.split_rows``).  Gate noise
    comes from ``draws`` (:func:`make_draws`), else from ``generator``;
    with neither the gates are noiseless.  Returns (loss, metrics) with
    this rank's rows' ``xent``, the ``aux_loss`` and ``loss``."""
    _check_mesh(ctx, n_stages, stage_axis)
    pp = pipeline_context(ctx, stage_axis)
    defs = pipeline_param_defs(cfg, n_stages)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    if b % n_micro != 0:
        raise ValueError(
            f"batch size {b} not divisible into {n_micro} microbatches")
    b_mb = b // n_micro
    stage_ctx = pp.manual(stage_axis).split_rows(b_mb, s)
    if train and draws is None and generator is not None:
        draws = make_draws(cfg, n_micro, n_stages, b_mb, s, generator,
                           tokens.device)
    used = ep_lib.gather_on_use(
        {k: v for k, v in params.items() if k != "blocks"},
        {k: v for k, v in defs.items() if k != "blocks"}, pp)
    blocks = ep_lib.gather_on_use(params["blocks"], defs["blocks"],
                                  stage_ctx, tp=True)

    def rows(t):                    # [B, S] -> [n_micro, B_local, S]
        return stage_ctx.local_rows(
            t.reshape(n_micro, b_mb, s).transpose(0, 1)).transpose(0, 1)
    tok, lab = rows(tokens), rows(labels)
    b_local = tok.shape[1]
    x = layers.embed(used["embed"], tok, cfg.compute_dtype)
    positions = torch.arange(s, device=x.device)[None, :].expand(b_local, s)
    y_mb, aux = pipeline_stack_apply(
        blocks, x, cfg, ctx=ctx, n_stages=n_stages, stage_axis=stage_axis,
        positions=positions, draws=draws if train else None, train=train,
        rows=b_mb)
    y = layers.rmsnorm(used["ln_f"], y_mb.reshape(n_micro * b_local, s, -1),
                       cfg.norm_eps)
    xent = lm.chunked_xent(used, y, lab.reshape(n_micro * b_local, s), cfg,
                           chunk=min(512, s))
    loss = xent + aux
    return loss, {"xent": xent, "aux_loss": aux, "loss": loss}


def make_pipeline_train_step(cfg: ModelConfig, oc: opt_lib.OptConfig, *,
                             ctx: MeshContext, n_stages: int, n_micro: int,
                             stage_axis: str = "data"):
    """``step(state, batch, generator) -> (state, metrics)``: the
    pipelined loss of the global ``batch`` back-propagated on this rank
    (``loss / world``, see the module docstring), each gradient summed
    over the ranks that hold replicas of its leaf, then the shard-aware
    update (``apply_updates(ctx=, defs=)``) in place.  ``state =
    {"params", "opt"}`` holds this rank's slices; the metrics are the
    ranks' means, with ``grad_norm`` and ``lr``."""
    _check_mesh(ctx, n_stages, stage_axis)
    pp = pipeline_context(ctx, stage_axis)
    defs = pipeline_param_defs(cfg, n_stages)
    specs = pp.specs(defs)

    def step(state, batch, generator):
        params = state["params"]
        for p in pm.tree_leaves(params):
            p.grad = None
        loss, metrics = pipeline_lm_loss(
            params, batch, cfg, ctx=ctx, n_stages=n_stages,
            n_micro=n_micro, stage_axis=stage_axis, generator=generator)
        (loss / pp.world).backward()
        grads = pm.tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                       else p.grad), params)
        trainer_lib._sum_replicas(pp, grads, specs)
        metrics = trainer_lib._rank_mean(
            pp, {k: v.detach() for k, v in metrics.items()})
        _, _, info = opt_lib.apply_updates(params, grads, state["opt"], oc,
                                           ctx=pp, defs=defs)
        for p in pm.tree_leaves(params):
            p.grad = None
        return state, dict(metrics, **info)

    return step
