"""Grouped-query attention for prefill and decode (counterpart of
``repro.models.attention``).

The reference's attention is plain jnp (no Pallas kernel), so the port
writes it as plain torch: f32 scores, f32 softmax, masked entries at
NEG_INF.  Prefill keeps the masking semantics of the reference's
``blockwise_attention`` (causal, optional ``kv_len``, GQA) but forms the
whole score matrix at once: prompts here are short.  Decode attends one
query per row against the slot cache at the row's own position.

Caches are updated in place: the engine owns one pool and the layers
write their new K/V into it, where the reference returns new arrays.
"""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDef
from repro_torch.models import layers

NEG_INF = -1e30


def attention_defs(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qk_norm: bool, dtype) -> dict:
    defs = {
        "wq": ParamDef((d_model, n_heads, head_dim),
                       ("embed_fsdp", "heads", "head_dim"), dtype=dtype,
                       fan_in=d_model),
        "wk": ParamDef((d_model, n_kv_heads, head_dim),
                       ("embed_fsdp", "kv_heads", "head_dim"), dtype=dtype,
                       fan_in=d_model),
        "wv": ParamDef((d_model, n_kv_heads, head_dim),
                       ("embed_fsdp", "kv_heads", "head_dim"), dtype=dtype,
                       fan_in=d_model),
        "wo": ParamDef((n_heads, head_dim, d_model),
                       ("heads", "head_dim", "embed_fsdp"), dtype=dtype,
                       fan_in=n_heads * head_dim),
    }
    if qk_norm:
        defs["q_norm"] = layers.rmsnorm_defs(head_dim)
        defs["k_norm"] = layers.rmsnorm_defs(head_dim)
    return defs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, d] x [d, H, hd] -> [B, S, H, hd] in x.dtype."""
    b, s, d = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] x [H, hd, d] -> [B, S, d] in o.dtype."""
    b, s, h, hd = o.shape
    return torch.matmul(o.reshape(b, s, h * hd),
                        wo.to(o.dtype).reshape(h * hd, -1))


def _qkv(params, x, positions, *, rope_theta, qk_norm, eps=1e-6):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, eps)
        k = layers.rmsnorm(params["k_norm"], k, eps)
    q = layers.rope(q, positions, rope_theta)
    k = layers.rope(k, positions, rope_theta)
    return q, k, v


def causal_attention(q, k, v, *, kv_len: int | None = None,
                     q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd].

    Query i sits at position ``q_offset + i`` and sees kv positions
    <= its own (and < ``kv_len`` when given).  Scores and softmax in f32;
    the probabilities meet v in v's dtype, as in the reference."""
    b, sq, h, hd = q.shape
    skv, kv_heads = k.shape[1], k.shape[2]
    g = h // kv_heads
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(b, sq, kv_heads, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) * scale
    pos_q = q_offset + torch.arange(sq, device=q.device)
    pos_k = torch.arange(skv, device=q.device)
    mask = pos_k[None, :] <= pos_q[:, None]
    if kv_len is not None:
        mask = mask & (pos_k < kv_len)[None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def prefill_attention(params, x, positions, *, rope_theta: float,
                      qk_norm: bool, cache: dict, window: int = 0,
                      offset: int | None = None):
    """Prefill: causal attention that also writes K/V for positions
    [0, S) into ``cache`` (in place).  Returns (y, cache)."""
    if window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (zoo slice)")
    if offset is not None:
        raise NotImplementedError(
            "chunked prefill (offset) is not ported yet")
    q, k, v = _qkv(params, x, positions, rope_theta=rope_theta,
                   qk_norm=qk_norm)
    s = x.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    o = causal_attention(q, k, v)
    return _out(o, params["wo"]), cache


def init_cache_defs(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                    *, dtype=torch.bfloat16) -> dict:
    shape = (batch, max_len, n_kv_heads, head_dim)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ParamDef(shape, axes, init="zeros", dtype=dtype),
            "v": ParamDef(shape, axes, init="zeros", dtype=dtype)}


def decode_attention(params, x, cache, cur_index, *, rope_theta: float,
                     qk_norm: bool, window: int = 0):
    """One-token decode.  x: [B, 1, d]; ``cur_index``: scalar or [B]
    per-row positions (slots of mixed age).  Writes the new K/V at each
    row's position in ``cache`` (in place) and attends over positions
    <= it.  Returns (y [B, 1, d], cache)."""
    if window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (zoo slice)")
    b = x.shape[0]
    cur = torch.as_tensor(cur_index, device=x.device).long().reshape(-1)
    cur = cur.expand(b)
    q, k_new, v_new = _qkv(params, x, cur[:, None], rope_theta=rope_theta,
                           qk_norm=qk_norm)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, cur] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, cur] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    h, hd = q.shape[2], q.shape[3]
    kv_heads = k.shape[2]
    qr = q.reshape(b, 1, kv_heads, h // kv_heads, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) / (hd ** 0.5)
    valid = torch.arange(length, device=x.device)[None, :] <= cur[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    o = o.reshape(b, 1, h, hd).to(x.dtype)
    return _out(o, params["wo"]), cache
