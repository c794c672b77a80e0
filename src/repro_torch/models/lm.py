"""Top-level language model (counterpart of ``repro.models.lm``):
embedding -> layer stack -> norm -> logits / loss.

* ``lm_loss``    — training forward: mean token cross-entropy (chunked
  over the sequence) + the §4 balancing losses summed over MoE layers.
* ``lm_prefill`` — prompt ingestion: last-position logits, K/V written
  into the given cache page.
* ``lm_decode``  — one-token decode step against the slot cache.

Randomness: torch cannot reproduce ``jax.random``, so ``lm_loss`` takes
its gate noise from a ``torch.Generator`` (the trainer) or as tensors
(``draws=``, see :func:`make_draws`; the tests pass the JAX draws).

Modality frontends (vlm / audio) are stubs, as in the reference:
``batch["prefix_embeds"]`` ([B, n_prefix, d], precomputed patch or
frame embeddings) overwrites the first ``n_prefix`` token embeddings.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import param as pm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.models import layers, transformer
from repro_torch.sharding.context import (MeshContext, local_draws,
                                         on_mesh, with_step_rows)


def lm_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embed_defs(cfg.vocab_size, cfg.d_model,
                                   cfg.param_dtype),
        "blocks": transformer.stack_defs(cfg),
        "ln_f": layers.rmsnorm_defs(cfg.d_model),
        "unembed": {"w": pm.ParamDef((cfg.d_model, cfg.vocab_size),
                                     ("embed_fsdp", "vocab"),
                                     dtype=cfg.param_dtype,
                                     fan_in=cfg.d_model)},
    }


def _embed_with_prefix(params, tokens, cfg: ModelConfig,
                       prefix_embeds=None, ctx=None) -> torch.Tensor:
    """Token embeddings in the compute dtype, the first positions
    overwritten by the stub frontend's ``prefix_embeds`` when the
    config has a prefix (vocab-parallel where ``ctx`` runs the
    vocabulary tensor-parallel)."""
    x = layers.embed(params["embed"], tokens, cfg.compute_dtype, ctx=ctx,
                     axes=transformer.dense_tp(cfg, ctx)["vocab"])
    if cfg.n_prefix and prefix_embeds is not None:
        n = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x[:, n:]], dim=1)
    return x


def logits_fn(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[..., d] -> [..., V] f32: the matmul runs in the compute dtype and
    only the result is widened (the [d, V] weight is never upcast)."""
    return torch.matmul(x, params["unembed"]["w"].to(x.dtype)).float()


def make_draws(cfg: ModelConfig, batch_size: int, seq_len: int,
               generator: torch.Generator, device) -> dict:
    """One step's random draws, two lists with one entry per layer
    number (``transformer.layer_index``), drawn in that order:
    ``noise``, [B*S, E] standard normals for an MoE layer (the
    reference's ``normal(fold_in(rng, layer), [T, E])``), the two-level
    dict of ``hierarchical.make_noise`` for a hierarchical one (the
    reference splits ``fold_in(rng, layer)`` into the two levels' keys)
    and None elsewhere; ``moa_noise``, [B*S, moa_experts] for an MoA
    mixer (the reference's ``normal(fold_in(fold_in(rng, layer), 1),
    [T, E])``) and None elsewhere."""
    t = batch_size * seq_len
    noise: list = [None] * cfg.n_layers
    moa_noise: list = [None] * cfg.n_layers
    for layer, kind in transformer.layer_index(cfg):
        if kind.ffn in ("moe", "moe+dense"):
            noise[layer] = transformer.moe_noise(cfg, t, generator, device)
        if kind.mixer == "moa":
            moa_noise[layer] = torch.randn((t, cfg.moa_experts),
                                           generator=generator,
                                           device=device)
    return {"noise": noise, "moa_noise": moa_noise}


def _xent_sum(params, x, labels, cfg: ModelConfig, ctx=None,
              axes: tuple = ()):
    """Summed token cross-entropy of one chunk: x [B, c, d] -> the
    [B, c, V] f32 logits, their log-sum-exp minus the gold logit (a
    gather, exact where the reference takes a one-hot product).

    Vocab-parallel over the mesh ``axes`` of ``ctx``: the rank's [B, c,
    V / M] logits; the max over the ranks (no gradient) shifts them; the
    sums of their exponentials and the gold logit (from the rank that
    holds the label, zero elsewhere) are summed over the ranks in one
    all-reduce."""
    logits = logits_fn(params, x, cfg)
    if not axes:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.sum(lse - gold)
    n = logits.shape[-1]
    m = ctx.all_max(torch.amax(logits, dim=-1), axes)
    local = labels.long() - ctx.index(axes) * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    part = torch.stack([torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                        torch.where(mine, gold, 0.0)])
    total = ctx.all_reduce(part, axes)
    return torch.sum(m + torch.log(total[0]) - total[1])


def chunked_xent(params, x: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, chunk: int = 512, ctx=None
                 ) -> torch.Tensor:
    """Mean cross-entropy without materializing [B, S, V]: each chunk of
    the sequence runs under ``torch.utils.checkpoint``, so one chunk's
    logits exist at a time, forward and backward (vocab-parallel where
    ``ctx`` runs the vocabulary tensor-parallel: :func:`_xent_sum`)."""
    axes = transformer.dense_tp(cfg, ctx)["vocab"]
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk != 0:
        raise ValueError(
            f"sequence length {s} not divisible by loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_xent_sum, params, x[:, c0:c0 + chunk],
                                   labels[:, c0:c0 + chunk], cfg, ctx, axes,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def lm_loss(params, batch: dict, cfg: ModelConfig, *,
            generator: torch.Generator | None = None,
            draws: dict | None = None, train: bool = True,
            ctx: MeshContext | None = None):
    """batch: tokens / labels [B, S] (+ ``prefix_embeds`` [B, n_prefix,
    d] for the frontend stubs).  Returns (loss, metrics) with the
    reference's keys: ``xent``, ``aux_loss``, ``loss`` and the balancing
    metrics averaged over the routed sublayers (MoE FFNs and MoA
    mixers).

    Gate noise comes from ``draws`` (:func:`make_draws`) or, when that is
    None, from ``generator``; with neither the gates are noiseless, as
    with the reference's ``rng=None``.

    On a mesh (``ctx``) ``params`` are this rank's slices, gathered
    here on use (``expert_parallel.gather_on_use``), ``batch`` is this
    rank's rows of the global batch, the flat MoE layers run the
    expert-parallel schedule, MoA mixers and the hierarchical MoE their
    global plan, and where the step holds the rows whole over some axes
    (``model``) the embedding, attention, the dense FFN and the loss run
    tensor-parallel over them (``MeshContext.tp_axes``: the gather keeps
    those dims as this rank's slices).  The draws are those of the
    global batch (``draws``,
    or drawn from ``generator`` at the global size) of which the rank
    keeps the flat MoE's tokens (``sharding.context.local_draws``); a
    global plan's noise stays whole.  The rows split as the enclosing
    training step split them (``sharding.context.with_step_rows``; over
    every rank outside one).  ``xent`` is then the rank's own mean,
    while ``aux_loss`` and the balancing metrics are the combined
    batch's (a global plan's: one process's)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    mesh = on_mesh(ctx)
    if mesh:
        ctx = with_step_rows(ctx)
        params = ep_lib.gather_on_use(params, lm_defs(cfg), ctx, tp=True)
    if train and draws is None and generator is not None:
        draws = make_draws(cfg, b * (ctx.size(ctx.rows_over) if mesh
                                     else 1), s, generator, tokens.device)
    if train and draws is not None and mesh:
        whole = ("moa_noise",) + (("noise",) if cfg.moe_hierarchical
                                  else ())
        draws = local_draws(draws, ctx, whole=whole)
    x = _embed_with_prefix(params, tokens, cfg, batch.get("prefix_embeds"),
                           ctx)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, aux = transformer.stack_apply(params["blocks"], x, cfg,
                                     positions=positions,
                                     draws=draws if train else None,
                                     train=train, ctx=ctx)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    xent = chunked_xent(params, x, batch["labels"], cfg, ctx=ctx)
    loss = xent + aux["aux_loss"]
    n_moe = torch.clamp(aux["n_moe"], min=1.0)
    metrics = {"xent": xent, "aux_loss": aux["aux_loss"], "loss": loss,
               **{k: v / n_moe for k, v in aux["metrics"].items()}}
    return loss, metrics


def lm_prefill(params, batch: dict, cache, cfg: ModelConfig, *,
               last_index=None, valid=None, start_pos: int | None = None,
               ctx: MeshContext | None = None):
    """Prompt ingestion.  batch: tokens [B, S] (+ ``prefix_embeds``, as
    in :func:`lm_loss`).  Writes K/V for
    positions [0, S) into ``cache``; returns (last_logits [B, V], cache).

    Bucketed prefill: ``last_index`` (scalar or [B], one per row of a
    cross-slot batched chunk call) picks the logits position — the true
    final prompt token of a right-padded prompt — and ``valid`` ([B, S])
    masks the padded tail out of MoE routing.

    Chunked prefill: ``start_pos`` ingests the prompt slice at absolute
    positions [start_pos, start_pos + S) against a cache already holding
    [0, start_pos); RoPE, the K/V writes and the causal mask use the
    absolute positions, ``last_index`` stays chunk-local.

    On a mesh (``ctx``, the prefill plan) ``params`` are the serving
    layout (``expert_parallel.serve_layout``) and the MoE's expert work
    is split over the expert axis (the flat MoE's also over its d_ff).  With the engine's context every rank
    prefills the same rows into a whole page, and the logits are the
    same on every rank.  A context whose ``row_axes`` split the rows
    (``launch/steps.py::prefill_rows``) gives ``batch`` and ``cache`` as
    this rank's rows, and the logits are theirs (one process's rows:
    the routed layers route every rank's rows).  Where such a context
    holds the rows whole over some axes, the dense layers run
    tensor-parallel over them (as in :func:`lm_loss`; ``params`` then
    hold those dims as this rank's slices, ``serve_layout``'s, and
    ``cache`` this rank's key / value heads where they split), and the
    last logits are all-gathered over the vocabulary's axes."""
    tokens = batch["tokens"]
    x = _embed_with_prefix(params, tokens, cfg, batch.get("prefix_embeds"),
                           ctx)
    b, s = tokens.shape
    positions = (start_pos or 0) + torch.arange(s, device=x.device)
    positions = positions[None, :].expand(b, s)
    x = transformer.stack_prefill(params["blocks"], x, cfg, cache,
                                  positions, valid=valid,
                                  start_pos=start_pos, ctx=ctx)
    if last_index is None:
        x = x[:, -1:, :]
    else:
        li = torch.as_tensor(last_index, device=x.device).long()
        li = li.reshape(-1).expand(b)
        x = x[torch.arange(b, device=x.device), li][:, None, :]
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_fn(params, x, cfg)[:, 0, :]
    vocab = transformer.dense_tp(cfg, ctx)["vocab"]
    if vocab:
        logits = ctx.all_gather(logits, vocab, 1)
    return logits, cache


def lm_decode(params, tokens, cache, cur_index, cfg: ModelConfig, *,
              valid=None, return_telemetry: bool = False,
              ctx: MeshContext | None = None):
    """One decode step.  tokens: [B]; ``cur_index``: scalar or [B]
    per-row positions of the new token; ``valid`` ([B] in {0,1}) is slot
    occupancy (dead slots route nowhere and take no expert capacity).
    Returns (logits [B, V], cache) plus, with ``return_telemetry``, the
    per-expert load / overflow counters summed over MoE layers.

    On a mesh (``ctx``, the decode plan) ``params`` are the serving
    layout, the rows are this rank's slots (the plan's ``batch`` axes)
    and ``cache`` is this rank's slice of the pool on the plan fitted to
    it (``serve/kv_cache.py::fit_decode_plan``: positions over
    ``kv_seq``, mamba states whole); the logits are this rank's rows,
    the telemetry every slot's."""
    x = layers.embed(params["embed"], tokens[:, None], cfg.compute_dtype)
    x, telem = transformer.stack_decode(params["blocks"], x, cfg, cache,
                                        cur_index, valid=valid, ctx=ctx)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_fn(params, x, cfg)[:, 0, :]
    if return_telemetry:
        return logits, cache, telem
    return logits, cache
