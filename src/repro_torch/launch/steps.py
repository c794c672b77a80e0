"""The three step functions (train / prefill / decode) and their inputs
as each rank's slices on ``meta``, counterpart of ``repro.launch.steps``.

The steps are the port's own, with no new numerics:
``train/trainer.py::make_train_step`` over ``models/lm.py::lm_loss``,
and ``lm_prefill`` / ``lm_decode``.  :func:`build_step` returns a step
and its arguments for one (arch x shape x mesh) cell as ``meta``
tensors (a kimi-k2 cell describes ~2 TB of parameters without
allocating a byte), laid out as one rank holds them:

* train: the parameters and the optimizer state are the rank's slices
  by the plan (``MeshContext.shard``), the batch the global one (the
  trainer takes each rank's rows of each microbatch); the microbatch
  count is the reference's, ``cfg_microbatches`` of the ranks of the
  ``batch`` axes;
* prefill: the serving layout (``expert_parallel.serve_layout``: every
  weight whole but the experts' block), and the rank's rows of the batch
  and of the cache by :func:`prefill_rows` (``MeshContext.split_rows``,
  the rule training follows; the routed layers' global plans gather the
  rows over the axes that split them, so the plan, the drops and each
  row's logits are one process's); where the rows are whole over some
  axes the dense layers run tensor-parallel over them, so the layout
  keeps those dims as the rank's slices and an attention page holds the
  rank's key / value heads where they split
  (``transformer.tp_cache_defs``);
* decode: the serving layout, the rank's rows of the slots and its
  slice of the cache (the decode plan fitted to the cache, as the
  engine fits it: ``serve/kv_cache.py::fit_decode_plan``).

There is nothing to lower: a "lowering" is one call of the step on
those tensors (``launch/dryrun.py`` runs it under a memory tracker).
With ``mesh=None`` the cell is one process: the single-card path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.common import param as pm
from repro_torch.configs import shapes as shp
from repro_torch.configs.base import ModelConfig
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.launch.analytic import cfg_microbatches
from repro_torch.models import lm, transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.serve.kv_cache import fit_decode_plan
from repro_torch.sharding import partition
from repro_torch.sharding.context import MeshContext, on_mesh
from repro_torch.train import trainer

# The arguments a step updates in place and hands back: the train state
# (parameters and optimizer state) and the prefill / decode cache.  The
# reference donates them to XLA so that their buffers hold the outputs;
# the port's optimizer and cache writes work in place, so no step holds
# a second copy of them.
_DONATE = {"train": (0,), "prefill": (2,), "decode": (2,)}


@dataclasses.dataclass
class StepSpec:
    """One cell's step and its arguments (each rank's slices)."""
    fn: Callable
    args: tuple
    kind: str
    microbatches: int
    fallbacks: list


def make_train_step_fn(cfg: ModelConfig, oc: opt_lib.OptConfig,
                       ctx: MeshContext | None, microbatches: int = 1):
    """``train_step(state, batch, seed, draws=None) -> (state,
    metrics)``: the gradients of ``lm_loss`` over the global ``batch``
    (accumulated over ``microbatches``), then the update, in place.  The
    gate noise comes from a generator seeded with ``seed`` (a CPU
    generator for ``meta`` tensors), or from ``draws``: one
    ``lm.make_draws`` tree a microbatch, in order."""
    mesh = on_mesh(ctx)
    feed: dict = {}

    def loss_fn(params, batch, generator):
        draws = next(feed["draws"]) if feed.get("draws") else None
        return lm.lm_loss(params, batch, cfg, generator=generator,
                          draws=draws, train=True,
                          ctx=ctx if mesh else None)

    step = trainer.make_train_step(
        loss_fn, oc, microbatches=microbatches, ctx=ctx if mesh else None,
        defs=lm.lm_defs(cfg) if mesh else None)

    def train_step(state, batch, seed, draws=None):
        dev = batch["tokens"].device
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(int(seed))
        feed["draws"] = None if draws is None else iter(draws)
        try:
            return step(state, batch, gen)
        finally:
            feed.clear()
    return train_step


def make_prefill_step_fn(cfg: ModelConfig, ctx: MeshContext | None):
    def prefill_step(params, batch, cache):
        return lm.lm_prefill(params, batch, cache, cfg,
                             ctx=ctx if on_mesh(ctx) else None)
    return prefill_step


def make_decode_step_fn(cfg: ModelConfig, ctx: MeshContext | None):
    def serve_step(params, tokens, cache, cur_index):
        return lm.lm_decode(params, tokens, cache, cur_index, cfg,
                            ctx=ctx if on_mesh(ctx) else None)
    return serve_step


def prefill_rows(ctx: MeshContext, rows: int, seq: int) -> MeshContext:
    """The row split of a prefill step of ``rows`` rows of ``seq``
    tokens: :meth:`MeshContext.split_rows`, with the axes named even
    where the rows split over every free axis, so the model reads them
    as split (``models/transformer.py::_token_axes``); the engine's
    prefill context, whose ``row_axes`` is None, holds its rows whole."""
    split = ctx.split_rows(rows, seq)
    return dataclasses.replace(split, row_axes=split.rows_over)


def build_step(cfg: ModelConfig, shape: shp.ShapeSpec, mesh=None,
               oc: opt_lib.OptConfig | None = None,
               plan: str | None = None) -> StepSpec:
    """The step of ``shape``'s kind and its ``meta`` arguments as a rank
    of ``mesh`` (a ``DeviceMesh`` over an initialized process group, or
    None for one process) holds them, under ``plan`` (default:
    ``partition.plan_for``); ``fallbacks`` lists the sharding fallbacks
    ``partition.resolve_spec`` recorded for the parameters, the state,
    the batch and the cache."""
    plan = plan or partition.plan_for(shape.name)
    ctx = (MeshContext.for_mesh(mesh, plan) if mesh is not None
           else MeshContext.null(plan))
    fallbacks: list = []
    oc = oc or opt_lib.OptConfig(kind="factored")
    defs = lm.lm_defs(cfg)
    batch = shp.batch_inputs(cfg, shape)
    if mesh is not None:
        ctx.specs(defs, fallbacks)
        axes = shp.logical_batch_axes(cfg, shape)
        for k, v in batch.items():
            ctx.resolve(v.shape, axes[k], fallbacks)

    if shape.kind == "train":
        opt_defs = opt_lib.state_defs(defs, oc)
        params, opt = pm.abstract(defs), pm.abstract(opt_defs)
        if mesh is not None:
            ctx.specs(opt_defs, fallbacks)
            params, opt = ctx.shard(params, defs), ctx.shard(opt, opt_defs)
        for p in pm.tree_leaves(params):
            if p.is_floating_point():
                p.requires_grad_(True)
        # The reference's depth: by the ranks of the ``batch`` axes the
        # global batch resolves to (the trainer then splits each
        # microbatch's rows by ``MeshContext.split_rows``).
        n_bsh = (ctx.size(ctx.resolve((shape.global_batch,),
                                      ("batch",))[0])
                 if mesh is not None else 1)
        mb = cfg_microbatches(cfg, shape, n_bsh)
        fn = make_train_step_fn(cfg, oc, ctx, microbatches=mb)
        return StepSpec(fn=fn, args=({"params": params, "opt": opt}, batch,
                                     0), kind="train", microbatches=mb,
                        fallbacks=fallbacks)

    cache, cache_defs = shp.cache_specs(cfg, shape)
    if mesh is not None and shape.kind == "decode":
        ctx = fit_decode_plan(ctx, cache_defs)
    if mesh is not None and shape.kind == "prefill":
        ctx = prefill_rows(ctx, shape.global_batch, shape.seq_len)
    params = ep_lib.serve_layout(ctx.shard(pm.abstract(defs), defs), defs,
                                 ctx)
    if shape.kind == "prefill":
        if mesh is not None:
            mine = dataclasses.replace(shape, global_batch=(
                shape.global_batch // ctx.size(ctx.rows_over)))
            batch = shp.batch_inputs(cfg, mine)
            cache = pm.abstract(transformer.tp_cache_defs(
                cfg, mine.global_batch, mine.seq_len, ctx))
        return StepSpec(fn=make_prefill_step_fn(cfg, ctx),
                        args=(params, batch, cache), kind="prefill",
                        microbatches=1, fallbacks=fallbacks)
    tokens = batch["tokens"]
    if mesh is not None:
        ctx.specs(cache_defs, fallbacks)
        cache = ctx.shard(cache, cache_defs)
        tokens = ctx.shard_leaf(tokens, ctx.resolve(tokens.shape,
                                                    ("batch",)))
    cur = torch.full((), shape.seq_len - 1, dtype=torch.int32)
    return StepSpec(fn=make_decode_step_fn(cfg, ctx),
                    args=(params, tokens, cache, cur), kind="decode",
                    microbatches=1, fallbacks=fallbacks)
