"""Decoder blocks + the period-stacked layer loop (counterpart of
``repro.models.transformer``), for prefill and decode.

Parameters for each position-in-period are stacked across periods with a
leading ``[n_periods, ...]`` axis, as in the reference, so a JAX tree
moves across as a plain copy; the loop walks the stack in Python and
hands each block views of its layer's slice.  Remainder layers live
unstacked under ``"tail"``.

The port runs the ``attn`` and ``moa`` mixers with ``dense`` / ``moe``
/ ``moe+dense`` FFNs.  Mamba mixers (hybrid / ssm zoo slice),
hierarchical MoE (its own slice) and sliding-window attention raise
NotImplementedError.  ``cfg.fused_decode`` reaches decode-shaped MoE and
MoA calls only; prefill stays unfused.
"""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDef, tree_map
from repro_torch.configs.base import (LayerKind, ModelConfig, layer_kinds,
                                      n_periods)
from repro_torch.core import moa as moa_lib
from repro_torch.core import moe as moe_lib
from repro_torch.models import attention, layers

_NOT_PORTED = {
    "mamba": "mamba mixers are not ported yet (the zoo slice)",
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


def _moe_args(cfg: ModelConfig, *, decode: bool = False) -> moe_lib.MoEArgs:
    # Only decode-shaped calls opt in to the fused decode step.
    return moe_lib.MoEArgs(
        n_experts=cfg.n_experts, k=cfg.moe_k, d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff, activation=cfg.activation, router=cfg.router,
        gating_mode=cfg.gating_mode, capacity_factor=cfg.capacity_factor,
        w_importance=cfg.w_importance, w_load=cfg.w_load,
        dispatch_impl=cfg.dispatch_impl, kernel_backend=cfg.kernel_backend,
        fused_decode=cfg.fused_decode and decode, dtype=cfg.param_dtype)


def _moa_args(cfg: ModelConfig, *, decode: bool = False) -> moa_lib.MoAArgs:
    # The FFN's RouterSpec serves MoA too unless moa_router overrides it;
    # its k is the FFN's, so it is stripped and re-inherited from moa_k.
    router = cfg.moa_router
    if router is None and cfg.router is not None:
        router = cfg.router.replace(k=None)
    return moa_lib.MoAArgs(
        n_experts=cfg.moa_experts, k=cfg.moa_k, d_model=cfg.d_model,
        n_heads_per_expert=cfg.moa_heads_per_expert, head_dim=cfg.head_dim,
        n_kv_heads=max(cfg.n_kv_heads, 1), qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, router=router,
        capacity_factor=cfg.capacity_factor, w_importance=cfg.w_importance,
        w_load=cfg.w_load, kernel_backend=cfg.kernel_backend,
        dispatch_impl=cfg.dispatch_impl,
        fused_decode=cfg.fused_decode and decode, dtype=cfg.param_dtype)


def block_defs(cfg: ModelConfig, kind: LayerKind) -> dict:
    _check_supported(cfg, kind)
    defs: dict = {"ln1": layers.rmsnorm_defs(cfg.d_model)}
    if kind.mixer == "moa":
        defs["moa"] = moa_lib.moa_defs(_moa_args(cfg))
    else:
        defs["attn"] = attention.attention_defs(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, dtype=cfg.param_dtype)
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
        if kind.mixer == "moa":
            # Shared K/V: a plain attention layer's cache.
            return moa_lib.init_cache_defs(batch, max_len, _moa_args(cfg),
                                           dtype=cfg.param_dtype)
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


def _apply_ffn(params, x, kind: LayerKind, cfg: ModelConfig, *, valid=None,
               decode: bool = False):
    """Post-mixer FFN with residual (inference).  Returns (x, aux)."""
    if kind.ffn == "none":
        return x, None
    h = layers.rmsnorm(params["ln2"], x, cfg.norm_eps)
    out = x
    aux = None
    if kind.ffn in ("moe", "moe+dense"):
        b, s, d = h.shape
        y, aux = moe_lib.moe_apply(params["moe"], h.reshape(b * s, d),
                                   _moe_args(cfg, decode=decode),
                                   train=False, mask=_flat_mask(valid, b, s))
        out = out + y.reshape(b, s, d)
    if kind.ffn in ("dense", "moe+dense"):
        out = out + layers.mlp(params["mlp"], h, cfg.activation)
    return out, aux


def _moa_telemetry(aux) -> dict:
    """An MoA layer's router telemetry under its own names, so head-group
    load is never summed into FFN-expert load."""
    t = aux["telemetry"]
    return {"moa_load": t["expert_load"], "moa_overflow": t["overflow"]}


def block_prefill(params, x, kind: LayerKind, cfg: ModelConfig, cache,
                  positions, valid=None):
    """Prefill block: causal attention (or MoA) + cache fill.  Returns
    x."""
    h = layers.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind.mixer == "moa":
        b, s, _ = h.shape
        y, _ = moa_lib.moa_prefill(params["moa"], h, positions,
                                   _moa_args(cfg), cache=cache,
                                   mask=_flat_mask(valid, b, s))
    else:
        y, _ = attention.prefill_attention(
            params["attn"], h, positions, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, cache=cache)
    x, _ = _apply_ffn(params, x + y, kind, cfg, valid=valid)
    return x


def block_decode(params, x, kind: LayerKind, cfg: ModelConfig, cache,
                 cur_index, valid=None):
    """One-token decode block.  Returns (x, telemetry): the MoE layer's
    expert_load / overflow and the MoA mixer's moa_load / moa_overflow,
    whichever the block has."""
    h = layers.rmsnorm(params["ln1"], x, cfg.norm_eps)
    telem = {}
    if kind.mixer == "moa":
        mask = None if valid is None else valid.float().reshape(-1)
        y, _, aux = moa_lib.moa_decode(params["moa"], h, cache, cur_index,
                                       _moa_args(cfg, decode=True),
                                       mask=mask)
        telem.update(_moa_telemetry(aux))
    else:
        y, _ = attention.decode_attention(
            params["attn"], h, cache, cur_index, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm)
    x, aux = _apply_ffn(params, x + y, kind, cfg, valid=valid, decode=True)
    if aux is not None:
        telem.update(aux["telemetry"])
    return x, telem


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


def moa_telemetry_width(cfg: ModelConfig) -> int:
    """Length of the per-head-group telemetry vectors (0 = no MoA
    mixer)."""
    if not any(k.mixer == "moa" for k in layer_kinds(cfg)):
        return 0
    return cfg.moa_experts


# (load key, overflow key, layer-count key) of the two counter families.
_FAMILIES = (("expert_load", "overflow", "n_moe"),
             ("moa_load", "moa_overflow", "n_moa"))


def stack_decode(params, x, cfg: ModelConfig, cache, cur_index, valid=None):
    """One-token decode through all layers.  Returns (x, telemetry): the
    per-expert load / overflow counters summed over MoE layers and, for a
    model with MoA mixers, the per-head-group ``moa_load`` /
    ``moa_overflow`` summed over them (None for a model with neither)."""
    dev = x.device
    telem = {}
    for (load, over, count), width in zip(
            _FAMILIES, (telemetry_width(cfg), moa_telemetry_width(cfg))):
        if width:
            telem[load] = torch.zeros((width,), dtype=torch.float32,
                                      device=dev)
            telem[over] = torch.zeros((width,), dtype=torch.float32,
                                      device=dev)
            telem[count] = torch.zeros((), dtype=torch.float32, device=dev)
    for p, c, kind in _layers(params, cache, cfg):
        x, t = block_decode(p, x, kind, cfg, c, cur_index, valid=valid)
        for load, over, count in _FAMILIES:
            if load in t and load in telem:
                telem[load] = telem[load] + t[load]
                telem[over] = telem[over] + t[over]
                telem[count] = telem[count] + 1.0
    return x, telem or None
