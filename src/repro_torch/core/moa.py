"""Mixture-of-Attention-Heads, the serving half (counterpart of
``repro.core.moa``).

MoA (Zhang et al. 2022) routes each token through its top-k of E groups
of query heads against one shared K/V projection:

    y_t = sum_e  w_e · Attn(x_t W_q^e, K, V) W_o^e

* **Shared K/V**: the cache has exactly a plain attention layer's shape,
  so the slot pool works unchanged.
* **Routed Q/O**: each expert owns a ``[d, Hg·hd]`` query and a
  ``[Hg·hd, d]`` output projection, run as grouped matmuls over capacity
  buffers through the kernel backend: ``dispatch -> gmm -> combine``,
  with the gates applied once, in the final combine.  The Q combine and
  the O dispatch use the assignment-major ``[T·k, 1]`` view of the plan
  (unit weights), so every (token, slot) is its own row.
* With ``fused_decode`` each routed projection at decode is one launch of
  the backend's ``decode_proj`` (kernel 8 in ``"proj"`` mode on
  ``"cuda"``).

Prefill attention is the port's plain ``attention.causal_attention``
(the reference's ``blockwise_attention`` is plain jnp too).  Training
(``moa_apply``, the flash-attention VJP) comes with the MoA training
slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import dispatch as dsp
from repro_torch.core import router as router_lib
from repro_torch.kernels import backend as backend_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoAArgs:
    """One MoA layer: ``n_experts`` head groups of ``n_heads_per_expert``
    query heads, ``k`` of them per token, over ``n_kv_heads`` shared K/V
    heads (which must divide ``n_heads_per_expert``).  The routing and
    kernel fields mirror ``MoEArgs``."""
    n_experts: int
    k: int
    d_model: int
    n_heads_per_expert: int
    head_dim: int
    n_kv_heads: int = 1
    qk_norm: bool = False
    rope_theta: float = 10000.0
    router: "router_lib.RouterSpec | None" = None
    capacity_factor: float | None = None
    eval_capacity_factor: float | None = None
    w_importance: float = 0.1
    w_load: float = 0.1
    priority_dispatch: bool = False
    kernel_backend: str = "cuda"
    dispatch_impl: str = "sort"
    # Decode-shaped calls only (set by the model layer): each routed
    # projection is one launch of the backend's decode_proj.
    fused_decode: bool = False
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.n_experts < 2:
            raise ValueError(
                f"MoA needs >= 2 head-group experts, got {self.n_experts}")
        if not 1 <= self.k <= self.n_experts:
            raise ValueError(
                f"MoA k={self.k} out of range for E={self.n_experts}")
        if self.n_kv_heads < 1 \
                or self.n_heads_per_expert % self.n_kv_heads:
            raise ValueError(
                f"n_heads_per_expert={self.n_heads_per_expert} must be a "
                f"positive multiple of n_kv_heads={self.n_kv_heads} (each "
                "head group spreads uniformly over the shared K/V heads)")

    @property
    def d_head_group(self) -> int:
        return self.n_heads_per_expert * self.head_dim


def moa_defs(a: MoAArgs) -> dict:
    """Router gate + per-expert wq / wo + the shared wk / wv."""
    spec = router_lib.resolve_spec(a)
    defs = dict(router_lib.Router(spec, a.n_experts).gate_defs(a.d_model))
    hh = a.d_head_group
    defs.update({
        "wq": ParamDef((a.n_experts, a.d_model, hh),
                       ("experts", "expert_embed", "expert_mlp"),
                       dtype=a.dtype, fan_in=a.d_model),
        "wo": ParamDef((a.n_experts, hh, a.d_model),
                       ("experts", "expert_mlp", "expert_embed"),
                       dtype=a.dtype, fan_in=hh),
        "wk": ParamDef((a.d_model, a.n_kv_heads, a.head_dim),
                       ("embed_fsdp", "kv_heads", "head_dim"),
                       dtype=a.dtype, fan_in=a.d_model),
        "wv": ParamDef((a.d_model, a.n_kv_heads, a.head_dim),
                       ("embed_fsdp", "kv_heads", "head_dim"),
                       dtype=a.dtype, fan_in=a.d_model),
    })
    if a.qk_norm:
        defs["q_norm"] = layers.rmsnorm_defs(a.head_dim)
        defs["k_norm"] = layers.rmsnorm_defs(a.head_dim)
    return defs


def init_cache_defs(batch: int, max_len: int, a: MoAArgs, *, dtype=None):
    """A plain attention layer's cache (the shared K/V)."""
    return attn_lib.init_cache_defs(batch, max_len, a.n_kv_heads,
                                    a.head_dim, dtype=dtype or a.dtype)


# ---------------------------------------------------------------------------
# plan views + projection pipeline
# ---------------------------------------------------------------------------

def assignment_plan(p: dsp.DispatchPlan) -> dsp.DispatchPlan:
    """Token-major [T, k] plan -> assignment-major [T·k, 1] view with
    unit weights (zero where the assignment was dropped or masked)."""
    tk = p.expert_index.numel()
    return dsp.DispatchPlan(
        expert_index=p.expert_index.reshape(tk, 1),
        position=p.position.reshape(tk, 1),
        weight=(p.weight > 0.0).float().reshape(tk, 1),
        n_experts=p.n_experts, capacity=p.capacity,
        fraction_dropped=p.fraction_dropped)


def _routed_q(params, flat, dec, a: MoAArgs, bk):
    """[T, d] tokens -> [T·k, Hg·hd] selected head-group queries."""
    buf = bk.dispatch(flat, dec, a)                        # [E, C, d]
    qbuf = bk.gmm(buf, params["wq"], a)                    # [E, C, Hg·hd]
    return bk.combine(qbuf, assignment_plan(dec.plan), a, dtype=flat.dtype)


def _routed_o(params, o_sel, dec, a: MoAArgs, bk, dtype):
    """[T·k, Hg·hd] attention outputs -> [T, d] gate-weighted output."""
    obuf = bk.dispatch(o_sel, assignment_plan(dec.plan), a)
    out = bk.gmm(obuf, params["wo"], a)                    # [E, C, d]
    return bk.combine(out, dec, a, dtype=dtype)


def _norm_rope_q(params, q_sel, positions, a: MoAArgs):
    """q_sel: [B, S, kk·Hg, hd] — per-head qk-norm, then RoPE."""
    if a.qk_norm:
        q_sel = layers.rmsnorm(params["q_norm"], q_sel)
    return layers.rope(q_sel, positions, a.rope_theta)


def _shared_kv(params, x, positions, a: MoAArgs):
    """Shared K/V projection (+ norm + rope): [B, S, d] -> 2 x
    [B, S, KV, hd]; f32 products, one cast."""
    dt = x.dtype
    xf = x.float()
    k = torch.einsum("bsd,dhk->bshk", xf, params["wk"].float()).to(dt)
    v = torch.einsum("bsd,dhk->bshk", xf, params["wv"].float()).to(dt)
    if a.qk_norm:
        k = layers.rmsnorm(params["k_norm"], k)
    return layers.rope(k, positions, a.rope_theta), v


def _to_virtual(q_sel, n_kv: int):
    """[B, S, kk, Hg, hd] -> KV-major [B, S, kk·Hg, hd] virtual heads
    (attention maps query head h to KV head h // g)."""
    b, s, kk, hg, hd = q_sel.shape
    ge = hg // n_kv
    q = q_sel.reshape(b, s, kk, n_kv, ge, hd).permute(0, 1, 3, 2, 4, 5)
    return q.reshape(b, s, n_kv * kk * ge, hd)


def _from_virtual(o, n_kv: int, kk: int, hg: int):
    """Inverse of :func:`_to_virtual`: [B, S, kk·Hg, hd] ->
    [B, S, kk, Hg, hd]."""
    b, s, _, hd = o.shape
    ge = hg // n_kv
    o = o.reshape(b, s, n_kv, kk, ge, hd).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, s, kk, hg, hd)


def _route(params, flat, a: MoAArgs, bk, *, mask):
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    return router.route(params, flat, train=False, mask=mask)


def _aux(dec: router_lib.RouteDecision) -> dict:
    return {"aux_loss": dec.aux_loss, "metrics": dec.metrics,
            "telemetry": dec.telemetry}


def _queries(q_sel, positions, params, a: MoAArgs, kk: int):
    b, s = positions.shape
    q = q_sel.reshape(b, s, kk * a.n_heads_per_expert, a.head_dim)
    q = _norm_rope_q(params, q, positions, a)
    return _to_virtual(q.reshape(b, s, kk, a.n_heads_per_expert,
                                 a.head_dim), a.n_kv_heads)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def moa_apply(params, x, a: MoAArgs, **kw):
    """Full-sequence MoA for training (the reference's flash-attention
    custom VJP) is not ported yet."""
    raise NotImplementedError(
        "moa_apply (MoA training, flash-attention VJP) is not ported yet: "
        "it comes with the MoA training slice; serving uses moa_prefill "
        "and moa_decode")


def moa_prefill(params, x, positions, a: MoAArgs, *, cache: dict,
                mask: torch.Tensor | None = None,
                start_pos: int | None = None):
    """Prefill: routed attention that also writes K/V for positions
    [0, S) into ``cache`` (in place).  ``mask`` ([B·S]) keeps bucketed
    padding out of routing.  Returns (y, cache)."""
    if start_pos is not None:
        raise NotImplementedError("chunked prefill is not ported yet")
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    bk = backend_lib.resolve(a)
    dec = _route(params, flat, a, bk, mask=mask)
    kk = dec.plan.expert_index.shape[1]
    q = _queries(_routed_q(params, flat, dec, a, bk), positions, params, a,
                 kk)
    k, v = _shared_kv(params, x, positions, a)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    o = attn_lib.causal_attention(q, k, v)
    o = _from_virtual(o, a.n_kv_heads, kk, a.n_heads_per_expert)
    y = _routed_o(params, o.reshape(b * s * kk, a.d_head_group), dec, a,
                  bk, x.dtype)
    return y.reshape(b, s, d), cache


def moa_decode(params, x, cache: dict, cur_index, a: MoAArgs, *,
               mask: torch.Tensor | None = None):
    """One-token routed decode.  x: [B, 1, d]; ``cur_index``: scalar or
    [B] per-slot positions; ``mask`` ([B]) is slot occupancy.  Returns
    (y [B, 1, d], cache, aux) with this step's routing telemetry."""
    b, _, d = x.shape
    cur = torch.as_tensor(cur_index, device=x.device).long().reshape(-1)
    cur = cur.expand(b)
    positions = cur[:, None]
    bk = backend_lib.resolve(a)
    flat = x.reshape(b, d)
    dec = _route(params, flat, a, bk, mask=mask)
    kk = dec.plan.expert_index.shape[1]
    ap = assignment_plan(dec.plan)
    if a.fused_decode:
        q_sel = bk.decode_proj(flat, params["wq"], dec.plan, ap, a,
                               dtype=flat.dtype)
    else:
        q_sel = _routed_q(params, flat, dec, a, bk)         # [B·k, Hg·hd]
    q = _queries(q_sel, positions, params, a, kk)
    k_new, v_new = _shared_kv(params, x, positions, a)
    o = attn_lib.attend_cached(q, k_new, v_new, cache, cur)
    o = _from_virtual(o, a.n_kv_heads, kk, a.n_heads_per_expert)
    o_sel = o.reshape(b * kk, a.d_head_group)
    if a.fused_decode:
        y = bk.decode_proj(o_sel, params["wo"], ap, dec.plan, a,
                           dtype=x.dtype)
    else:
        y = _routed_o(params, o_sel, dec, a, bk, x.dtype)
    return y.reshape(b, 1, d), cache, _aux(dec)
