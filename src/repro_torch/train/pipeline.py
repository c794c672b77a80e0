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
* Within a stage each ``model`` rank takes its share of every
  microbatch's rows (the reference's body holds the microbatch whole on
  every model rank and lets GSPMD split the MoE); the MoE's combined
  batch is then the stage's whole microbatch, so its capacity and
  balance losses are per microbatch, as the reference's.
* Bubble ticks run no layer (the reference computes them and masks the
  result): a stage that is not live passes its input through.  Every
  rank still calls every shift, in the same order, so the collectives
  of the stage ring match; stage 0 adds the zeros it receives to its
  microbatch, so its shift is part of the graph on every rank and the
  reverse shift runs everywhere.
* Gate noise comes in as tensors (the port's convention): one ``[B_mb
  * S, E]`` draw per (microbatch, stage, layer), ``draws["noise"][mb]
  [stage][layer]``; the tests pass the reference's ``fold_in(rng, mb *
  n_stages + stage)`` then ``fold_in(layer)`` draws, and
  :func:`make_draws` draws them from a generator.
* ``cfg.remat`` checkpoints each layer (the port's decision of PR 22),
  where the reference checkpoints the stage body.

Loss scale: every rank computes the loss of its rows after the masked
stage sum, and a step back-propagates ``loss / world`` on each rank.
The backward pass of the stage sum adds the ``n_stages`` ranks'
cotangents (``n_stages / world = 1 / model`` of each column's loss
reaches the last stage), and the trainer's replica sums
(``_sum_replicas``) add what the ranks of a replicated leaf computed,
so every gradient is the gradient of the mean loss over the ranks.
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
from repro_torch.sharding.context import MeshContext, on_mesh
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
    """One step's gate noise: ``noise[mb][stage][layer]``, a [micro_batch
    * seq_len, E] standard normal for each MoE layer (None elsewhere),
    drawn in that order (every rank draws them all and keeps its own)."""
    per, _ = stages_for(cfg, n_stages)
    kind = layer_kinds(cfg)[0]
    moe = kind.ffn in ("moe", "moe+dense")
    t = micro_batch * seq_len
    return {"noise": [[[transformer.moe_noise(cfg, t, generator, device)
                        if moe else None for _ in range(per)]
                       for _ in range(n_stages)] for _ in range(n_micro)]}


def refuse_routed(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config with MoA mixers or the
    hierarchical MoE: the stage body passes a layer no MoA gate noise,
    and it keeps its rows of each draw, where a global plan needs the
    whole (``expert_parallel.GlobalPlan``)."""
    kinds = layer_kinds(cfg)
    if any(k.mixer == "moa" for k in kinds):
        raise NotImplementedError(
            "MoA is not pipelined: the stage body passes no MoA gate noise")
    if cfg.moe_hierarchical and any(k.ffn in ("moe", "moe+dense")
                                    for k in kinds):
        raise NotImplementedError(
            "the hierarchical MoE is not pipelined: a stage keeps its rows "
            "of each draw, and the global plan needs the whole")


def _check_mesh(ctx: MeshContext | None, n_stages: int, stage_axis: str):
    if not on_mesh(ctx):
        raise ValueError("the pipeline runs on a mesh (ctx with a mesh)")
    if ctx.sizes.get(stage_axis) != n_stages:
        raise ValueError(f"n_stages={n_stages} must equal the size of the "
                         f"stage axis {stage_axis!r} ({ctx.sizes})")


def pipeline_stack_apply(block_params, x_mb, cfg: ModelConfig, *,
                         ctx: MeshContext, n_stages: int,
                         stage_axis: str = "data", positions, draws=None,
                         train: bool = True):
    """Run the pipelined layer stack on this rank.

    ``block_params``: this rank's ``[1, per, ...]`` stage slice, whole
    but for the experts' FFN weights (this rank's shard over ``model``).
    ``x_mb``: [n_micro, B_local, S, d], this rank's rows of every
    microbatch (its ``model`` share).  ``draws``: :func:`make_draws`'s
    (the global microbatch's rows; each rank keeps its own) or None.
    Returns (y_mb [n_micro, B_local, S, d], aux_loss scalar)."""
    _check_mesh(ctx, n_stages, stage_axis)
    pp = pipeline_context(ctx, stage_axis)
    stage_ctx = pp.manual(stage_axis)
    n_micro = x_mb.shape[0]
    kind = layer_kinds(cfg)[0]
    per, _ = stages_for(cfg, n_stages)
    sid = pp.index((stage_axis,))
    last = n_stages - 1
    stage_layers = transformer._unstack(
        pm.tree_map(lambda t: t.squeeze(0), block_params), per)

    def layer(x, aux, block, noise):
        x, a = transformer.block_apply(block, x, kind, cfg,
                                       positions=positions, noise=noise,
                                       train=train, ctx=stage_ctx)
        return x, aux if a is None else aux + a["aux_loss"]

    def stage_body(x, mb):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(stage_layers):
            noise = None
            if draws is not None and draws["noise"][mb][sid][i] is not None:
                noise = stage_ctx.local_rows(draws["noise"][mb][sid][i])
            if cfg.remat:
                x, aux = checkpoint(layer, x, aux, block, noise,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = layer(x, aux, block, noise)
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
    of which each ``model`` rank takes its share.  Gate noise comes from
    ``draws`` (:func:`make_draws`), else from ``generator``; with neither
    the gates are noiseless.  Returns (loss, metrics) with this rank's
    rows' ``xent``, the ``aux_loss`` and ``loss``."""
    _check_mesh(ctx, n_stages, stage_axis)
    refuse_routed(cfg)
    pp = pipeline_context(ctx, stage_axis)
    stage_ctx = pp.manual(stage_axis)
    defs = pipeline_param_defs(cfg, n_stages)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    if b % n_micro != 0:
        raise ValueError(
            f"batch size {b} not divisible into {n_micro} microbatches")
    b_mb = b // n_micro
    if train and draws is None and generator is not None:
        draws = make_draws(cfg, n_micro, n_stages, b_mb, s, generator,
                           tokens.device)
    used = ep_lib.gather_on_use(
        {k: v for k, v in params.items() if k != "blocks"},
        {k: v for k, v in defs.items() if k != "blocks"}, pp)
    blocks = ep_lib.gather_on_use(params["blocks"], defs["blocks"],
                                  stage_ctx)

    def rows(t):                    # [B, S] -> [n_micro, B_local, S]
        return stage_ctx.local_rows(
            t.reshape(n_micro, b_mb, s).transpose(0, 1)).transpose(0, 1)
    tok, lab = rows(tokens), rows(labels)
    b_local = tok.shape[1]
    x = layers.embed(used["embed"], tok, cfg.compute_dtype)
    positions = torch.arange(s, device=x.device)[None, :].expand(b_local, s)
    y_mb, aux = pipeline_stack_apply(
        blocks, x, cfg, ctx=ctx, n_stages=n_stages, stage_axis=stage_axis,
        positions=positions, draws=draws if train else None, train=train)
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
