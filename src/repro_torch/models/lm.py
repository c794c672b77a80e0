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
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import param as pm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer


def lm_defs(cfg: ModelConfig) -> dict:
    if cfg.n_prefix or cfg.frontend != "none":
        raise NotImplementedError(
            "modality frontend stubs are not ported yet (the zoo slice)")
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


def logits_fn(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[..., d] -> [..., V] f32: the matmul runs in the compute dtype and
    only the result is widened (the [d, V] weight is never upcast)."""
    return torch.matmul(x, params["unembed"]["w"].to(x.dtype)).float()


def make_draws(cfg: ModelConfig, batch_size: int, seq_len: int,
               generator: torch.Generator, device) -> dict:
    """One step's random draws: ``noise``, a list with one entry per
    layer number (``transformer.layer_index``), [B*S, E] standard
    normals for an MoE layer (the reference's
    ``normal(fold_in(rng, layer), [T, E])``), the two-level dict of
    ``hierarchical.make_noise`` for a hierarchical one (the reference
    splits ``fold_in(rng, layer)`` into the two levels' keys) and None
    elsewhere."""
    noise: list = [None] * cfg.n_layers
    for layer, kind in transformer.layer_index(cfg):
        if kind.ffn in ("moe", "moe+dense"):
            noise[layer] = transformer.moe_noise(
                cfg, batch_size * seq_len, generator, device)
    return {"noise": noise}


def _xent_sum(params, x, labels, cfg: ModelConfig):
    """Summed token cross-entropy of one chunk: x [B, c, d] -> the
    [B, c, V] f32 logits, their log-sum-exp minus the gold logit (a
    gather, exact where the reference takes a one-hot product)."""
    logits = logits_fn(params, x, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(params, x: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy without materializing [B, S, V]: each chunk of
    the sequence runs under ``torch.utils.checkpoint``, so one chunk's
    logits exist at a time, forward and backward."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk != 0:
        raise ValueError(
            f"sequence length {s} not divisible by loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_xent_sum, params, x[:, c0:c0 + chunk],
                                   labels[:, c0:c0 + chunk], cfg,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def lm_loss(params, batch: dict, cfg: ModelConfig, *,
            generator: torch.Generator | None = None,
            draws: dict | None = None, train: bool = True):
    """batch: tokens / labels [B, S].  Returns (loss, metrics) with the
    reference's keys: ``xent``, ``aux_loss``, ``loss`` and the balancing
    metrics averaged over the routed sublayers.

    Gate noise comes from ``draws`` (:func:`make_draws`) or, when that is
    None, from ``generator``; with neither the gates are noiseless, as
    with the reference's ``rng=None``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if train and draws is None and generator is not None:
        draws = make_draws(cfg, b, s, generator, tokens.device)
    noise = draws["noise"] if train and draws is not None else None
    x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, aux = transformer.stack_apply(params["blocks"], x, cfg,
                                     positions=positions, noise=noise,
                                     train=train)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    xent = chunked_xent(params, x, batch["labels"], cfg)
    loss = xent + aux["aux_loss"]
    n_moe = torch.clamp(aux["n_moe"], min=1.0)
    metrics = {"xent": xent, "aux_loss": aux["aux_loss"], "loss": loss,
               **{k: v / n_moe for k, v in aux["metrics"].items()}}
    return loss, metrics


def lm_prefill(params, batch: dict, cache, cfg: ModelConfig, *,
               last_index=None, valid=None):
    """Prompt ingestion.  batch: tokens [B, S].  Writes K/V for
    positions [0, S) into ``cache``; returns (last_logits [B, V], cache).

    Bucketed prefill: ``last_index`` (scalar or [B]) picks the logits
    position — the true final prompt token of a right-padded prompt —
    and ``valid`` ([B, S]) masks the padded tail out of MoE routing."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x = transformer.stack_prefill(params["blocks"], x, cfg, cache,
                                  positions, valid=valid)
    if last_index is None:
        x = x[:, -1:, :]
    else:
        li = torch.as_tensor(last_index, device=x.device).long()
        li = li.reshape(-1).expand(b)
        x = x[torch.arange(b, device=x.device), li][:, None, :]
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_fn(params, x, cfg)[:, 0, :], cache


def lm_decode(params, tokens, cache, cur_index, cfg: ModelConfig, *,
              valid=None, return_telemetry: bool = False):
    """One decode step.  tokens: [B]; ``cur_index``: scalar or [B]
    per-row positions of the new token; ``valid`` ([B] in {0,1}) is slot
    occupancy (dead slots route nowhere and take no expert capacity).
    Returns (logits [B, V], cache) plus, with ``return_telemetry``, the
    per-expert load / overflow counters summed over MoE layers."""
    x = layers.embed(params["embed"], tokens[:, None], cfg.compute_dtype)
    x, telem = transformer.stack_decode(params["blocks"], x, cfg, cache,
                                        cur_index, valid=valid)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = logits_fn(params, x, cfg)[:, 0, :]
    if return_telemetry:
        return logits, cache, telem
    return logits, cache
