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

On a mesh (``ctx``) the plan is global (``core/expert_parallel.py::
GlobalPlan``, the reference's GSPMD run of the one-process code): each
routed projection gathers the step's rows, dispatches them by the
global plan, runs this rank's slab of the head groups and all-gathers
the slab outputs over the expert axis before the combine; a rank keeps
its own rows.  Attention stays local (a rank's batch rows are whole
sequences), and decode attends over the decode plan's sequence-sharded
cache (``attention.attend_cached_sharded``).  Fused decode on a mesh
runs kernel 8 on the plans restricted to the rank's head groups and
sums the partial projections over the expert axis in f32: exact for
the Q projection (each row comes from one group), one cast after a
partial sum for the O projection.

Training (``moa_apply``) attends through the port's
``attention.FlashAttentionFn`` (the reference's flash-attention custom
VJP), so gradients reach the gate, both routed projections and the
shared K/V through the kernels' backward passes.  Prefill attends
through the port's ``attention.blockwise_attention`` with the
reference's blocks and query offset (the reference's is plain jnp too).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import dispatch as dsp
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.core import router as router_lib
from repro_torch.kernels import backend as backend_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.sharding.context import MeshContext


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
    # None keeps the resident dispatch / combine; an int forces the
    # expert-blocked kernels with that slab (kernels/backend.py).
    dispatch_e_block: int | None = None
    # Decode-shaped calls only (set by the model layer): each routed
    # projection is one launch of the backend's decode_proj.
    fused_decode: bool = False
    # Attention's blocks (FlashAttentionFn; blockwise prefill).
    q_block: int = 512
    kv_block: int = 512
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


def _routed_q(params, flat, dec, a: MoAArgs, bk, gp):
    """[T, d] tokens (every row of the step's plan) -> this rank's rows
    of the [T·k, Hg·hd] selected head-group queries."""
    w = gp.weights(params)["wq"]
    return gp.apply(flat, dec, a, lambda buf: bk.gmm(buf, w, a),
                    out_plan=assignment_plan(dec.plan), dtype=flat.dtype)


def _routed_o(params, o_sel, dec, a: MoAArgs, bk, gp, dtype):
    """This rank's rows of the [T·k, Hg·hd] attention outputs -> the
    [T, d] gate-weighted output of every row of the step's plan."""
    w = gp.weights(params)["wo"]
    return gp.apply(gp.gather(o_sel), assignment_plan(dec.plan), a,
                    lambda buf: bk.gmm(buf, w, a), out_plan=dec,
                    dtype=dtype)


def _fused_proj(x, w, plan_in, plan_out, a: MoAArgs, bk, gp, dtype):
    """One routed projection as kernel 8 (``decode_proj``); on a mesh
    over this rank's head groups, the partial outputs summed over the
    expert axis in f32."""
    if gp.ctx is None:
        return bk.decode_proj(x, w, plan_in, plan_out, a, dtype=dtype)
    part = bk.decode_proj(x, w, gp.local(plan_in), gp.local(plan_out), a,
                          dtype=torch.float32)
    return gp.reduce(part).to(dtype)


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


def _block(pref: int, n: int) -> int:
    """The attention block for a length ``n``: ``pref`` (at most ``n``),
    or the whole length when ``pref`` does not divide it, as in the
    reference (whose ``flash_attention`` would truncate such a length;
    ``FlashAttentionFn`` raises on it)."""
    b = min(pref, n)
    return b if n % b == 0 else n


def _route(params, flat, a: MoAArgs, bk, *, mask, train=False, noise=None):
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    return router.route(params, flat, train=train, noise=noise, mask=mask)


def _plan(ctx, a: MoAArgs, token_axes) -> ep_lib.GlobalPlan:
    return ep_lib.GlobalPlan.build(ctx, moa_defs(a), a.n_experts,
                                   token_axes)


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

def moa_apply(params, x, a: MoAArgs, *, positions, train: bool = True,
              noise: torch.Tensor | None = None,
              mask: torch.Tensor | None = None,
              ctx: MeshContext | None = None):
    """Full-sequence MoA for training.  x: [B, S, d]; positions: [B, S];
    ``noise`` ([B·S, E] standard normals) is the gate's training noise
    (None: a noiseless gate, as the reference's ``rng=None``); ``mask``
    ([B·S]) marks the tokens that route.  Attention is the causal
    ``FlashAttentionFn`` over the virtual heads.  On a mesh (``ctx``)
    ``x``, ``positions`` and ``mask`` are this rank's batch rows of the
    global batch, ``noise`` the global batch's.  Returns (y [B, S, d],
    aux) with ``moe_apply``'s aux keys."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    bk = backend_lib.resolve(a)
    gp = _plan(ctx, a, None)
    flat_all = gp.gather(flat)
    dec = _route(params, flat_all, a, bk, mask=gp.gather(mask), train=train,
                 noise=noise)
    kk = dec.plan.expert_index.shape[1]
    q_sel = gp.own(_routed_q(params, flat_all, dec, a, bk, gp), b * s * kk)
    q = _queries(q_sel, positions, params, a, kk)
    k, v = _shared_kv(params, x, positions, a)
    kvh, hd = a.n_kv_heads, a.head_dim
    g = q.shape[2] // kvh
    qr = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    o = attn_lib.flash_attention(qr, k.permute(0, 2, 3, 1),
                                 v.permute(0, 2, 1, 3), True, 0,
                                 _block(a.q_block, s), _block(a.kv_block, s))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)
    o = _from_virtual(o, kvh, kk, a.n_heads_per_expert)
    y = _routed_o(params, o.reshape(b * s * kk, a.d_head_group), dec, a,
                  bk, gp, x.dtype)
    return gp.own(y, b * s).reshape(b, s, d), _aux(dec)


def moa_prefill(params, x, positions, a: MoAArgs, *, cache: dict,
                mask: torch.Tensor | None = None,
                start_pos: int | None = None,
                ctx: MeshContext | None = None, token_axes=()):
    """Prefill: routed attention that also writes K/V for positions
    [0, S) into ``cache`` (in place).  ``mask`` ([B·S]) keeps bucketed
    or chunk padding out of routing.  ``start_pos`` is chunked-prefill
    mode, as ``attention.prefill_attention``'s ``offset``: the shared
    K/V lands at [start_pos, start_pos + S) and the chunk attends over
    the cached prefix.  Attention is ``attention.blockwise_attention``
    over the reference's blocks (``_block`` of the chunk's and of the
    context's length) at ``q_offset = start_pos``.  On a mesh (``ctx``,
    the prefill plan) the head groups are split over the expert axis,
    and ``x`` is the rank's rows, split over ``token_axes`` (none: the
    rows and the page are whole on every rank); the plan routes every
    rank's rows.  Returns (y, cache)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    bk = backend_lib.resolve(a)
    gp = _plan(ctx, a, token_axes)
    flat_all = gp.gather(flat)
    dec = _route(params, flat_all, a, bk, mask=gp.gather(mask))
    kk = dec.plan.expert_index.shape[1]
    q_sel = gp.own(_routed_q(params, flat_all, dec, a, bk, gp), b * s * kk)
    q = _queries(q_sel, positions, params, a, kk)
    k, v = _shared_kv(params, x, positions, a)
    off = 0 if start_pos is None else int(start_pos)
    o = attn_lib.attend_chunk(q, k, v, cache, off,
                              q_block=_block(a.q_block, s),
                              kv_block=_block(a.kv_block, off + s))
    o = _from_virtual(o, a.n_kv_heads, kk, a.n_heads_per_expert)
    y = _routed_o(params, o.reshape(b * s * kk, a.d_head_group), dec, a,
                  bk, gp, x.dtype)
    return gp.own(y, b * s).reshape(b, s, d), cache


def moa_decode(params, x, cache: dict, cur_index, a: MoAArgs, *,
               mask: torch.Tensor | None = None,
               ctx: MeshContext | None = None):
    """One-token routed decode.  x: [B, 1, d]; ``cur_index``: scalar or
    [B] per-slot positions; ``mask`` ([B]) is slot occupancy.  On a mesh
    (``ctx``, the decode plan) the rows are this rank's slots (the
    plan's ``batch`` axes), routed with every rank's, and ``cache`` is
    this rank's slice of their pages (``kv_seq`` sharded as the plan
    says).  Returns (y [B, 1, d], cache, aux) with this step's routing
    telemetry (every slot's)."""
    b, _, d = x.shape
    cur = torch.as_tensor(cur_index, device=x.device).long().reshape(-1)
    cur = cur.expand(b)
    positions = cur[:, None]
    bk = backend_lib.resolve(a)
    gp = _plan(ctx, a, None if ctx is None else ctx.axes_of("batch"))
    flat = x.reshape(b, d)
    flat_all = gp.gather(flat)
    dec = _route(params, flat_all, a, bk,
                 mask=gp.gather(None if mask is None else mask.reshape(-1)))
    kk = dec.plan.expert_index.shape[1]
    ap = assignment_plan(dec.plan)
    w = gp.weights(params)
    if a.fused_decode:
        q_sel = _fused_proj(flat_all, w["wq"], dec.plan, ap, a, bk, gp,
                            flat.dtype)
    else:
        q_sel = _routed_q(params, flat_all, dec, a, bk, gp)  # [B·k, Hg·hd]
    q = _queries(gp.own(q_sel, b * kk), positions, params, a, kk)
    k_new, v_new = _shared_kv(params, x, positions, a)
    seq_axes = () if gp.ctx is None else tuple(
        ax for ax in ctx.axes_of("kv_seq") if ctx.sizes[ax] > 1)
    if seq_axes:
        o = attn_lib.attend_cached_sharded(q, k_new, v_new, cache, cur, ctx,
                                           seq_axes)
    else:
        o = attn_lib.attend_cached(q, k_new, v_new, cache, cur)
    o = _from_virtual(o, a.n_kv_heads, kk, a.n_heads_per_expert)
    o_sel = o.reshape(b * kk, a.d_head_group)
    if a.fused_decode:
        y = _fused_proj(gp.gather(o_sel), w["wo"], ap, dec.plan, a, bk, gp,
                        x.dtype)
    else:
        y = _routed_o(params, o_sel, dec, a, bk, gp, x.dtype)
    return gp.own(y, b).reshape(b, 1, d), cache, _aux(dec)
