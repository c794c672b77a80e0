"""Decoder blocks + the period-stacked layer loop (counterpart of
``repro.models.transformer``), for training, prefill and decode.

Parameters for each position-in-period are stacked across periods with a
leading ``[n_periods, ...]`` axis, as in the reference, so a JAX tree
moves across as a plain copy; the loop walks the stack in Python and
hands each block views of its layer's slice.  Remainder layers (every
layer without ``cfg.scan_layers``) live unstacked under ``"tail"``.
Training (:func:`stack_apply`) wraps each layer of the stacked periods
in ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the reference
wraps its scan body, a period, in ``jax.checkpoint``).

The port runs the ``attn``, ``attn_local`` (sliding window,
``cfg.sliding_window``; its decode cache is a ring buffer), ``moa`` and
``mamba`` (``models/ssm.py``; its decode cache is the scan and conv
state, written in place by prefill and decode like K/V) mixers with
``dense`` / ``moe`` / ``moe+dense`` / no FFN, the MoE flat or
hierarchical (``cfg.moe_hierarchical``, Appendix B).
``cfg.fused_decode`` reaches decode-shaped flat MoE and MoA calls only;
prefill stays unfused, and the hierarchical MoE has no fused decode (nor
has the reference).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.param import ParamDef, tree_map
from repro_torch.configs.base import (LayerKind, ModelConfig, layer_kinds,
                                      n_periods)
from repro_torch.core import hierarchical as hmoe_lib
from repro_torch.core import moa as moa_lib
from repro_torch.core import moe as moe_lib
from repro_torch.models import attention, layers, ssm


def _moe_args(cfg: ModelConfig, *, decode: bool = False) -> moe_lib.MoEArgs:
    # Only decode-shaped calls opt in to the fused decode step.
    return moe_lib.MoEArgs(
        n_experts=cfg.n_experts, k=cfg.moe_k, d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff, activation=cfg.activation, router=cfg.router,
        gating_mode=cfg.gating_mode, capacity_factor=cfg.capacity_factor,
        w_importance=cfg.w_importance, w_load=cfg.w_load,
        dispatch_impl=cfg.dispatch_impl, kernel_backend=cfg.kernel_backend,
        dispatch_e_block=cfg.dispatch_e_block,
        fused_decode=cfg.fused_decode and decode, dtype=cfg.param_dtype)


def _hmoe_args(cfg: ModelConfig) -> hmoe_lib.HMoEArgs:
    a, b = cfg.moe_hierarchical
    return hmoe_lib.HMoEArgs(
        n_groups=a, n_experts_per_group=b, k_primary=cfg.moe_k,
        k_secondary=cfg.moe_k, d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
        activation=cfg.activation, router=cfg.router,
        capacity_factor=cfg.capacity_factor, w_importance=cfg.w_importance,
        w_load=cfg.w_load, dispatch_impl=cfg.dispatch_impl,
        kernel_backend=cfg.kernel_backend,
        dispatch_e_block=cfg.dispatch_e_block, dtype=cfg.param_dtype)


def moe_noise(cfg: ModelConfig, n_tokens: int,
              generator: torch.Generator, device):
    """One MoE layer's training gate noise: [T, E] standard normals, or
    the hierarchical MoE's two-level dict (``hierarchical.make_noise``)."""
    if cfg.moe_hierarchical:
        return hmoe_lib.make_noise(_hmoe_args(cfg), n_tokens, generator,
                                   device)
    return torch.randn((n_tokens, cfg.n_experts), generator=generator,
                       device=device)


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
        dispatch_e_block=cfg.dispatch_e_block,
        fused_decode=cfg.fused_decode and decode, q_block=cfg.q_block,
        kv_block=cfg.kv_block, dtype=cfg.param_dtype)


def _window(cfg: ModelConfig, kind: LayerKind) -> int:
    """The attention window of a layer: ``cfg.sliding_window`` for a
    local layer, 0 (global) otherwise."""
    return cfg.sliding_window if kind.mixer == "attn_local" else 0


def block_defs(cfg: ModelConfig, kind: LayerKind) -> dict:
    defs: dict = {"ln1": layers.rmsnorm_defs(cfg.d_model)}
    if kind.mixer == "moa":
        defs["moa"] = moa_lib.moa_defs(_moa_args(cfg))
    elif kind.mixer == "mamba":
        defs["mamba"] = ssm.mamba_defs(
            cfg.d_model, d_state=cfg.ssm_d_state, d_conv=cfg.ssm_d_conv,
            expand=cfg.ssm_expand, dtype=cfg.param_dtype)
    else:
        defs["attn"] = attention.attention_defs(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, dtype=cfg.param_dtype)
    if kind.ffn != "none":
        defs["ln2"] = layers.rmsnorm_defs(cfg.d_model)
    if kind.ffn in ("moe", "moe+dense") and cfg.moe_hierarchical:
        defs["moe"] = hmoe_lib.hmoe_defs(_hmoe_args(cfg))
    elif kind.ffn in ("moe", "moe+dense"):
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


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, as views whose
    gradients reach the stacked leaf in one piece: ``unbind`` (its
    backward stacks the layers' gradients once) rather than ``n``
    selects (each of whose backward passes writes a zero-filled tensor
    of the whole leaf), and for one layer a squeeze, whose backward is a
    view (an arctic expert leaf is 8.9 GB)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(tree[k], n) for k in sorted(tree)}
        return [{k: subs[k][i] for k in subs} for i in range(n)]
    return [tree.squeeze(0)] if n == 1 else list(tree.unbind(0))


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
        if kind.mixer == "moa":
            # Shared K/V: a plain attention layer's cache.
            return moa_lib.init_cache_defs(batch, max_len, _moa_args(cfg),
                                           dtype=cfg.param_dtype)
        if kind.mixer == "mamba":
            return ssm.init_state_defs(batch, cfg.d_model,
                                       d_state=cfg.ssm_d_state,
                                       d_conv=cfg.ssm_d_conv,
                                       expand=cfg.ssm_expand,
                                       dtype=cfg.param_dtype)
        return attention.init_cache_defs(batch, max_len, cfg.n_kv_heads,
                                         cfg.head_dim,
                                         window=_window(cfg, kind),
                                         dtype=cfg.param_dtype)

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
               decode: bool = False, train: bool = False, noise=None):
    """Post-mixer FFN with residual.  ``noise`` is the MoE gate's
    training noise ([B*S, E], or the hierarchical MoE's two-level dict).
    Returns (x, aux)."""
    if kind.ffn == "none":
        return x, None
    h = layers.rmsnorm(params["ln2"], x, cfg.norm_eps)
    out = x
    aux = None
    if kind.ffn in ("moe", "moe+dense"):
        b, s, d = h.shape
        flat, mask = h.reshape(b * s, d), _flat_mask(valid, b, s)
        if cfg.moe_hierarchical:
            y, aux = hmoe_lib.hmoe_apply(params["moe"], flat,
                                         _hmoe_args(cfg), train=train,
                                         noise=noise, mask=mask)
        else:
            y, aux = moe_lib.moe_apply(params["moe"], flat,
                                       _moe_args(cfg, decode=decode),
                                       train=train, noise=noise, mask=mask)
        out = out + y.reshape(b, s, d)
    if kind.ffn in ("dense", "moe+dense"):
        out = out + layers.mlp(params["mlp"], h, cfg.activation)
    return out, aux


def _moa_aux(aux) -> dict:
    """An MoA layer's router aux: its aux loss and metrics, counted as
    one routed sublayer (``n``), and its telemetry under its own names,
    so head-group load is never summed into FFN-expert load."""
    t = aux["telemetry"]
    return {"aux_loss": aux["aux_loss"], "metrics": aux["metrics"],
            "n": 1.0, "telemetry": {"moa_load": t["expert_load"],
                                    "moa_overflow": t["overflow"]}}


# ---------------------------------------------------------------------------
# training: blocks, the aux sums, the stack
# ---------------------------------------------------------------------------

def _zero_aux(device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": zero, "metrics": {k: zero
                                          for k in moe_lib.ZERO_METRICS},
            "n_moe": zero}


def _add_aux(acc: dict, aux: dict) -> dict:
    """Add a block's aux; ``aux["n"]`` counts the routed sublayers it
    sums over (metrics are averaged over ``n_moe`` in ``lm_loss``)."""
    return {"aux_loss": acc["aux_loss"] + aux["aux_loss"],
            "metrics": {k: acc["metrics"][k] + aux["metrics"][k]
                        for k in moe_lib.ZERO_METRICS},
            "n_moe": acc["n_moe"] + aux.get("n", 1.0)}


def _merge_aux(a, b):
    """Merge the mixer's and the FFN's aux of one block (either may be
    None); the sublayer count ``n`` adds up."""
    if a is None:
        return b
    if b is None:
        return a
    return {"aux_loss": a["aux_loss"] + b["aux_loss"],
            "metrics": {k: a["metrics"][k] + b["metrics"][k]
                        for k in moe_lib.ZERO_METRICS},
            "n": a.get("n", 1.0) + b.get("n", 1.0)}


def block_apply(params, x, kind: LayerKind, cfg: ModelConfig, *,
                positions, noise=None, moa_noise=None, train: bool = True):
    """Training block: the mixer, then the FFN.  ``noise`` (as in
    :func:`_apply_ffn`, or None) is the layer's MoE gate noise,
    ``moa_noise`` ([B*S, moa_experts] or None) its MoA gate's.  Returns
    (x, aux or None)."""
    h = layers.rmsnorm(params["ln1"], x, cfg.norm_eps)
    aux_mix = None
    if kind.mixer == "moa":
        y, aux = moa_lib.moa_apply(params["moa"], h, _moa_args(cfg),
                                   positions=positions, train=train,
                                   noise=moa_noise)
        aux_mix = _moa_aux(aux)
    elif kind.mixer == "mamba":
        y = ssm.mamba(params["mamba"], h, d_state=cfg.ssm_d_state)
    else:
        y = attention.attention(params["attn"], h, positions,
                                rope_theta=cfg.rope_theta,
                                qk_norm=cfg.qk_norm,
                                window=_window(cfg, kind),
                                q_block=cfg.q_block, kv_block=cfg.kv_block,
                                pad_heads=cfg.pad_attn_heads)
    x, aux = _apply_ffn(params, x + y, kind, cfg, train=train, noise=noise)
    return x, _merge_aux(aux_mix, aux)


def layer_index(cfg: ModelConfig) -> list[tuple[int, LayerKind]]:
    """(layer number, kind) of every layer in the order the stack runs
    them: the stacked periods, then the tail.  Layer ``l``'s gate noise
    is the reference's ``fold_in(rng, l)`` draw."""
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    return ([(i * cfg.period + p, kinds[p]) for i in range(full)
             for p in range(cfg.period)]
            + [(full * cfg.period + p, kinds[p % cfg.period])
               for p in range(rem)])


def stack_apply(params, x, cfg: ModelConfig, *, positions, draws=None,
                train: bool = True):
    """Run all layers for training.  ``draws`` is one step's draws
    (``lm.make_draws``: ``noise`` and ``moa_noise``, lists with one
    entry per layer number) or None for noiseless gates; a config with
    MoA mixers needs ``moa_noise``.  With ``cfg.remat`` each layer of
    the stacked periods runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward pass
    from its input, with the same noise tensors, so the recomputed
    routing is the forward's.  The reference checkpoints a whole period;
    a layer at a time recomputes the same work and holds one layer's
    activations, not a period's (a jamba period at S = 4096 would not
    fit beside its weights and gradients on one card).  Returns (x,
    summed aux)."""
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    aux = _zero_aux(x.device)
    if (draws is not None and "moa_noise" not in draws
            and any(kind.mixer == "moa" for kind in kinds)):
        raise ValueError("draws for a config with MoA mixers need "
                         "'moa_noise' (see lm.make_draws)")

    def draws_of(layer: int) -> dict:
        if draws is None:
            return {}
        return {"noise": draws["noise"][layer],
                "moa_noise": (draws["moa_noise"][layer]
                              if "moa_noise" in draws else None)}

    def layer(x, aux, block, kind, number):
        x, a = block_apply(block, x, kind, cfg, positions=positions,
                           **draws_of(number), train=train)
        return x, aux if a is None else _add_aux(aux, a)

    if full:
        stacked = {f"pos{p}": _unstack(params["periods"][f"pos{p}"], full)
                   for p in range(cfg.period)}
        for i in range(full):
            for p in range(cfg.period):
                args = (x, aux, stacked[f"pos{p}"][i], kinds[p],
                        i * cfg.period + p)
                if cfg.remat:
                    x, aux = checkpoint(layer, *args, use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    x, aux = layer(*args)
    for p in range(rem):
        x, aux = layer(x, aux, params["tail"][f"pos{p}"],
                       kinds[p % cfg.period], full * cfg.period + p)
    return x, aux


def _write_state(cache: dict, state: dict) -> None:
    """Copy a mamba mixer's new scan and conv state into its cache
    tensors (the page or pool that prefill and decode write in place)."""
    for key in ("ssm", "conv"):
        cache[key].copy_(state[key])


def block_prefill(params, x, kind: LayerKind, cfg: ModelConfig, cache,
                  positions, valid=None, start_pos: int | None = None):
    """Prefill block: causal attention (or MoA, or the mamba scan) +
    cache fill.  Returns x.  ``start_pos`` is chunked-prefill mode: K/V
    lands at cache positions [start_pos, start_pos + S) and attention
    resumes against the cached prefix (attention mixers only).  A mamba
    mixer copies its final scan and conv state into ``cache``."""
    if kind.mixer == "mamba" and start_pos is not None:
        raise ValueError(
            "chunked prefill requires attention mixers (ssm/hybrid state "
            "scans cannot resume mid-prompt from a cache page)")
    h = layers.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind.mixer == "moa":
        b, s, _ = h.shape
        y, _ = moa_lib.moa_prefill(params["moa"], h, positions,
                                   _moa_args(cfg), cache=cache,
                                   mask=_flat_mask(valid, b, s),
                                   start_pos=start_pos)
    elif kind.mixer == "mamba":
        y, state = ssm.mamba(params["mamba"], h, d_state=cfg.ssm_d_state,
                             return_state=True)
        _write_state(cache, state)
    else:
        y, _ = attention.prefill_attention(
            params["attn"], h, positions, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, cache=cache, window=_window(cfg, kind),
            offset=start_pos)
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
        telem.update(_moa_aux(aux)["telemetry"])
    elif kind.mixer == "mamba":
        y, state = ssm.mamba_decode(params["mamba"], h, cache,
                                    d_state=cfg.ssm_d_state)
        _write_state(cache, state)
    else:
        y, _ = attention.decode_attention(
            params["attn"], h, cache, cur_index, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, window=_window(cfg, kind))
    x, aux = _apply_ffn(params, x + y, kind, cfg, valid=valid, decode=True)
    if aux is not None:
        telem.update(aux["telemetry"])
    return x, telem


def stack_prefill(params, x, cfg: ModelConfig, cache, positions, valid=None,
                  start_pos: int | None = None):
    """Prefill all layers, writing K/V into ``cache``.  ``start_pos`` is
    the chunked-prefill offset: this call ingests prompt positions
    [start_pos, start_pos + S) against a cache already holding [0,
    start_pos).  Returns x."""
    for p, c, kind in _layers(params, cache, cfg):
        x = block_prefill(p, x, kind, cfg, c, positions, valid=valid,
                          start_pos=start_pos)
    return x


def telemetry_width(cfg: ModelConfig) -> int:
    """Length of the per-expert telemetry vectors (0 = no MoE layer; a·b
    for the hierarchical MoE's flat (group, expert) grid)."""
    if not any(k.ffn in ("moe", "moe+dense") for k in layer_kinds(cfg)):
        return 0
    if cfg.moe_hierarchical:
        a, b = cfg.moe_hierarchical
        return a * b
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
