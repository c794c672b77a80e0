"""Decoder blocks + the period-stacked layer loop (counterpart of
``repro.models.transformer``), for prefill and decode.

Parameters for each position-in-period are stacked across periods with a
leading ``[n_periods, ...]`` axis, as in the reference, so a JAX tree
moves across as a plain copy; the loop walks the stack in Python and
hands each block views of its layer's slice.  Remainder layers live
unstacked under ``"tail"``.

This slice runs the ``attn`` mixer with ``dense`` / ``moe`` /
``moe+dense`` FFNs.  Mamba mixers (hybrid / ssm zoo slice), MoA mixers
and hierarchical MoE (their own slices) and sliding-window attention
raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDef, tree_map
from repro_torch.configs.base import (LayerKind, ModelConfig, layer_kinds,
                                      n_periods)
from repro_torch.core import moe as moe_lib
from repro_torch.models import attention, layers

_NOT_PORTED = {
    "mamba": "mamba mixers are not ported yet (the zoo slice)",
    "moa": "Mixture-of-Attention mixers are not ported yet (the zoo / MoA "
           "slice)",
    "attn_local": "sliding-window attention is not ported yet (the zoo "
                  "slice)",
}


def _check_supported(cfg: ModelConfig, kind: LayerKind) -> None:
    if kind.mixer in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind.mixer])
    if kind.ffn in ("moe", "moe+dense") and cfg.moe_hierarchical:
        raise NotImplementedError(
            "hierarchical MoE is not ported yet (the hierarchical-MoE "
            "slice)")


def _moe_args(cfg: ModelConfig) -> moe_lib.MoEArgs:
    return moe_lib.MoEArgs(
        n_experts=cfg.n_experts, k=cfg.moe_k, d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff, activation=cfg.activation, router=cfg.router,
        gating_mode=cfg.gating_mode, capacity_factor=cfg.capacity_factor,
        w_importance=cfg.w_importance, w_load=cfg.w_load,
        dispatch_impl=cfg.dispatch_impl, kernel_backend=cfg.kernel_backend,
        fused_decode=cfg.fused_decode, dtype=cfg.param_dtype)


def block_defs(cfg: ModelConfig, kind: LayerKind) -> dict:
    _check_supported(cfg, kind)
    defs: dict = {"ln1": layers.rmsnorm_defs(cfg.d_model),
                  "attn": attention.attention_defs(
                      cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      qk_norm=cfg.qk_norm, dtype=cfg.param_dtype)}
    if kind.ffn != "none":
        defs["ln2"] = layers.rmsnorm_defs(cfg.d_model)
    if kind.ffn in ("moe", "moe+dense"):
        defs["moe"] = moe_lib.moe_defs(_moe_args(cfg))
    if kind.ffn in ("dense", "moe+dense"):
        defs["mlp"] = layers.mlp_defs(cfg.d_model, cfg.d_ff, cfg.activation,
                                      cfg.param_dtype)
    return defs


def _stack_tree(tree, n: int):
    """Prepend a stacked 'layers' axis of size n to every ParamDef."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       init=d.init, dtype=d.dtype,
                                       fan_in=d.fan_in), tree)


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def stack_defs(cfg: ModelConfig) -> dict:
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    defs: dict = {}
    if full:
        defs["periods"] = {
            f"pos{p}": _stack_tree(block_defs(cfg, kinds[p]), full)
            for p in range(cfg.period)}
    if rem:
        defs["tail"] = {f"pos{p}": block_defs(cfg, kinds[p % cfg.period])
                        for p in range(rem)}
    return defs


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Decode-cache ParamDefs matching the stacked parameter structure."""
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)

    def one(kind: LayerKind):
        _check_supported(cfg, kind)
        return attention.init_cache_defs(batch, max_len, cfg.n_kv_heads,
                                         cfg.head_dim, dtype=cfg.param_dtype)

    defs: dict = {}
    if full:
        defs["periods"] = {f"pos{p}": _stack_tree(one(kinds[p]), full)
                           for p in range(cfg.period)}
    if rem:
        defs["tail"] = {f"pos{p}": one(kinds[p % cfg.period])
                        for p in range(rem)}
    return defs


def _layers(params, cache, cfg: ModelConfig):
    """(block params, block cache, kind) for every layer, in order."""
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    for i in range(full):
        for p in range(cfg.period):
            yield (_layer(params["periods"][f"pos{p}"], i),
                   _layer(cache["periods"][f"pos{p}"], i), kinds[p])
    for p in range(rem):
        yield (params["tail"][f"pos{p}"], cache["tail"][f"pos{p}"],
               kinds[p % cfg.period])


def _flat_mask(valid, b: int, s: int):
    """[B] or [B, S] validity -> flat [B*S] float routing mask."""
    if valid is None:
        return None
    v = valid.float().reshape((b, -1) if valid.dim() > 1 else (b, 1))
    return v.expand(b, s).reshape(b * s)


def _apply_ffn(params, x, kind: LayerKind, cfg: ModelConfig, *, valid=None):
    """Post-mixer FFN with residual (inference).  Returns (x, aux)."""
    if kind.ffn == "none":
        return x, None
    h = layers.rmsnorm(params["ln2"], x, cfg.norm_eps)
    out = x
    aux = None
    if kind.ffn in ("moe", "moe+dense"):
        b, s, d = h.shape
        y, aux = moe_lib.moe_apply(params["moe"], h.reshape(b * s, d),
                                   _moe_args(cfg), train=False,
                                   mask=_flat_mask(valid, b, s))
        out = out + y.reshape(b, s, d)
    if kind.ffn in ("dense", "moe+dense"):
        out = out + layers.mlp(params["mlp"], h, cfg.activation)
    return out, aux


def block_prefill(params, x, kind: LayerKind, cfg: ModelConfig, cache,
                  positions, valid=None):
    """Prefill block: causal attention + cache fill.  Returns x."""
    h = layers.rmsnorm(params["ln1"], x, cfg.norm_eps)
    y, _ = attention.prefill_attention(
        params["attn"], h, positions, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, cache=cache)
    x, _ = _apply_ffn(params, x + y, kind, cfg, valid=valid)
    return x


def block_decode(params, x, kind: LayerKind, cfg: ModelConfig, cache,
                 cur_index, valid=None):
    """One-token decode block.  Returns (x, aux)."""
    h = layers.rmsnorm(params["ln1"], x, cfg.norm_eps)
    y, _ = attention.decode_attention(
        params["attn"], h, cache, cur_index, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm)
    return _apply_ffn(params, x + y, kind, cfg, valid=valid)


def stack_prefill(params, x, cfg: ModelConfig, cache, positions, valid=None):
    """Prefill all layers, writing K/V into ``cache``.  Returns x."""
    for p, c, kind in _layers(params, cache, cfg):
        x = block_prefill(p, x, kind, cfg, c, positions, valid=valid)
    return x


def telemetry_width(cfg: ModelConfig) -> int:
    """Length of the per-expert telemetry vectors (0 = no MoE layer)."""
    if not any(k.ffn in ("moe", "moe+dense") for k in layer_kinds(cfg)):
        return 0
    return cfg.n_experts


def stack_decode(params, x, cfg: ModelConfig, cache, cur_index, valid=None):
    """One-token decode through all layers.  Returns (x, telemetry): the
    per-expert load / overflow counters summed over MoE layers (None for
    a model without MoE)."""
    n = telemetry_width(cfg)
    telem = None
    if n:
        zero = torch.zeros((n,), dtype=torch.float32, device=x.device)
        telem = {"expert_load": zero, "overflow": zero.clone(),
                 "n_moe": torch.zeros((), dtype=torch.float32,
                                      device=x.device)}
    for p, c, kind in _layers(params, cache, cfg):
        x, aux = block_decode(p, x, kind, cfg, c, cur_index, valid=valid)
        if telem is not None and aux is not None:
            t = aux["telemetry"]
            telem = {"expert_load": telem["expert_load"] + t["expert_load"],
                     "overflow": telem["overflow"] + t["overflow"],
                     "n_moe": telem["n_moe"] + 1.0}
    return x, telem

