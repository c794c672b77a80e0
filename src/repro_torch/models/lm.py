"""Top-level language model for serving (counterpart of
``repro.models.lm``): embedding -> layer stack -> norm -> logits.

* ``lm_prefill`` — prompt ingestion: last-position logits, K/V written
  into the given cache page.
* ``lm_decode``  — one-token decode step against the slot cache.

The training loss (``lm_loss``) comes with the training slice.
"""
from __future__ import annotations

import torch

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
