"""Grouped-query attention for training, prefill and decode
(counterpart of ``repro.models.attention``).

The reference's attention is plain jnp (no Pallas kernel), so the port
writes it as plain torch: f32 scores, f32 softmax, masked entries at
NEG_INF.  Training runs :class:`FlashAttentionFn`, the reference's
``flash_attention`` with its custom VJP: block by block over query and
key / value blocks with an online softmax, only the blocks at or below
the diagonal, and a backward pass that recomputes the probabilities
from the saved log-sum-exp, so no ``[S, S]`` tensor is ever kept.
Prefill keeps the masking semantics of the reference's
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


def _kv_range(i: int, nkv: int, q_block: int, kv_block: int, causal: bool,
              window: int) -> tuple[int, int]:
    """Static kv-block range visible to query block i."""
    if causal:
        hi = min(nkv, (i * q_block + q_block + kv_block - 1) // kv_block)
    else:
        hi = nkv
    lo = max(0, (i * q_block + 1 - window) // kv_block) if window > 0 else 0
    return lo, hi


def _q_range(j: int, nq: int, q_block: int, kv_block: int, causal: bool,
             window: int) -> tuple[int, int]:
    """Static q-block range that can see kv block j (inverse of
    _kv_range)."""
    lo = (j * kv_block) // q_block if causal else 0
    if window > 0:
        hi = min(nq, (j * kv_block + kv_block - 1 + window) // q_block + 1)
    else:
        hi = nq
    return lo, hi


def _gmat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B,KV,G,R,X] x b [B,KV,X,Y] -> [B,KV,G,R,Y] in f32: the G query
    heads of a kv head share its operand, as one [G*R, X] product."""
    bsz, kvh, g, r, x = a.shape
    out = torch.matmul(a.float().reshape(bsz, kvh, g * r, x), b.float())
    return out.reshape(bsz, kvh, g, r, -1)


def _scores(q_i, k_j, i, j, q_block, kv_block, causal, window, scale):
    """f32 scores of query block i against kv block j, masked:
    q_i [B,KV,G,qb,hd], k_j [B,KV,hd,kvb] -> [B,KV,G,qb,kvb]."""
    s = _gmat(q_i, k_j) * scale
    pos_q = i * q_block + torch.arange(q_block, device=s.device)
    pos_k = j * kv_block + torch.arange(kv_block, device=s.device)
    mask = None
    if causal and (j + 1) * kv_block - 1 > i * q_block:
        mask = pos_k[None, :] <= pos_q[:, None]
    if window > 0:
        inside = pos_k[None, :] > pos_q[:, None] - window
        mask = inside if mask is None else mask & inside
    return s if mask is None else torch.where(mask, s, NEG_INF)


class FlashAttentionFn(torch.autograd.Function):
    """The reference's ``flash_attention`` (``_flash_fwd_impl`` /
    ``_flash_bwd``): ``apply(qr, kr, vr, causal, window, q_block,
    kv_block)`` with qr [B,KV,G,Sq,hd], kr [B,KV,hd,Skv], vr
    [B,KV,Skv,hd] -> [B,KV,G,Sq,hd] in qr's dtype.

    Forward: for each query block, an online softmax over the kv blocks
    of its static range (``_kv_range``); scores in f32, the
    probabilities meet v in v's dtype; it saves only (q, k, v, out,
    lse).  Backward: delta = rowsum(dout * out); dq query-block-major
    over the same ranges, dk / dv kv-block-major over ``_q_range``, each
    recomputing p = exp(s - lse) block by block, in f32, cast back to the
    input dtypes at the end."""

    @staticmethod
    def forward(ctx, qr, kr, vr, causal, window, q_block, kv_block):
        b, kvh, g, sq, hd = qr.shape
        skv = kr.shape[-1]
        if sq % q_block or skv % kv_block:
            raise ValueError(
                f"sequence lengths must divide the attention blocks: "
                f"sq={sq} % q_block={q_block}, skv={skv} % "
                f"kv_block={kv_block}")
        nq, nkv = sq // q_block, skv // kv_block
        scale = 1.0 / (hd ** 0.5)
        out = torch.empty_like(qr)
        lse = torch.empty((b, kvh, g, sq), dtype=torch.float32,
                          device=qr.device)
        for i in range(nq):
            qs = slice(i * q_block, (i + 1) * q_block)
            q_i = qr[:, :, :, qs]
            acc = torch.zeros((b, kvh, g, q_block, hd), dtype=torch.float32,
                              device=qr.device)
            m = torch.full((b, kvh, g, q_block), NEG_INF,
                           dtype=torch.float32, device=qr.device)
            l = torch.zeros_like(m)
            lo, hi = _kv_range(i, nkv, q_block, kv_block, causal, window)
            for j in range(lo, hi):
                ks = slice(j * kv_block, (j + 1) * kv_block)
                s = _scores(q_i, kr[..., ks], i, j, q_block, kv_block,
                            causal, window, scale)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                pv = _gmat(p.to(vr.dtype), vr[:, :, ks])
                acc = acc * alpha[..., None] + pv
                m = m_new
            lsafe = torch.clamp(l, min=1e-30)
            out[:, :, :, qs] = (acc / lsafe[..., None]).to(qr.dtype)
            lse[:, :, :, qs] = m + torch.log(lsafe)
        ctx.save_for_backward(qr, kr, vr, out, lse)
        ctx.blocks = (causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        qr, kr, vr, out, lse = ctx.saved_tensors
        causal, window, q_block, kv_block = ctx.blocks
        b, kvh, g, sq, hd = qr.shape
        nq, nkv = sq // q_block, kr.shape[-1] // kv_block
        scale = 1.0 / (hd ** 0.5)
        dout = dout.float()
        delta = (dout * out.float()).sum(dim=-1)          # [B,KV,G,Sq]

        def block(i, j):
            """(q_i, dout_i, delta_i, ds, p) of query block i against kv
            block j, p recomputed from the saved log-sum-exp."""
            qs = slice(i * q_block, (i + 1) * q_block)
            ks = slice(j * kv_block, (j + 1) * kv_block)
            q_i, do_i, dl_i = qr[:, :, :, qs], dout[:, :, :, qs], \
                delta[:, :, :, qs]
            s = _scores(q_i, kr[..., ks], i, j, q_block, kv_block, causal,
                        window, scale)
            p = torch.exp(s - lse[:, :, :, qs][..., None])
            dp = _gmat(do_i, vr[:, :, ks].transpose(-1, -2))
            ds = p * (dp - dl_i[..., None]) * scale
            return q_i, do_i, ds, p

        # dq: query-block-major, the forward's ranges.
        dq = torch.empty_like(qr)
        for i in range(nq):
            acc = torch.zeros((b, kvh, g, q_block, hd), dtype=torch.float32,
                              device=qr.device)
            lo, hi = _kv_range(i, nkv, q_block, kv_block, causal, window)
            for j in range(lo, hi):
                ks = slice(j * kv_block, (j + 1) * kv_block)
                _, _, ds, _ = block(i, j)
                acc = acc + _gmat(ds, kr[..., ks].transpose(-1, -2))
            dq[:, :, :, i * q_block:(i + 1) * q_block] = acc.to(qr.dtype)

        # dk / dv: kv-block-major; a kv head's G query heads and the query
        # rows form one reduction axis.
        dk = torch.empty_like(kr)
        dv = torch.empty_like(vr)
        rows = g * q_block
        for j in range(nkv):
            dk_acc = torch.zeros((b, kvh, hd, kv_block), dtype=torch.float32,
                                 device=qr.device)
            dv_acc = torch.zeros((b, kvh, kv_block, hd), dtype=torch.float32,
                                 device=qr.device)
            lo, hi = _q_range(j, nq, q_block, kv_block, causal, window)
            for i in range(lo, hi):
                q_i, do_i, ds, p = block(i, j)
                dv_acc = dv_acc + torch.matmul(
                    p.reshape(b, kvh, rows, kv_block).transpose(-1, -2),
                    do_i.reshape(b, kvh, rows, hd))
                dk_acc = dk_acc + torch.matmul(
                    q_i.float().reshape(b, kvh, rows, hd).transpose(-1, -2),
                    ds.reshape(b, kvh, rows, kv_block))
            ks = slice(j * kv_block, (j + 1) * kv_block)
            dk[..., ks] = dk_acc.to(kr.dtype)
            dv[:, :, ks] = dv_acc.to(vr.dtype)
        return dq, dk, dv, None, None, None, None


def flash_attention(qr, kr, vr, causal: bool = True, window: int = 0,
                    q_block: int = 512, kv_block: int = 512):
    """Differentiable blockwise attention in the reference's layouts (see
    :class:`FlashAttentionFn`)."""
    return FlashAttentionFn.apply(qr, kr, vr, causal, window, q_block,
                                  kv_block)


def attention(params, x, positions, *, rope_theta: float, qk_norm: bool,
              window: int = 0, q_block: int = 512, kv_block: int = 512,
              pad_heads: int = 0) -> torch.Tensor:
    """Causal self-attention for training.  x: [B, S, d] -> [B, S, d].

    ``pad_heads`` pads the query heads of each KV group with zero heads
    up to this many in all; their outputs are sliced off before the
    output projection, so the result is unchanged."""
    if window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (zoo slice)")
    q, k, v = _qkv(params, x, positions, rope_theta=rope_theta,
                   qk_norm=qk_norm)
    b, sq, h, hd = q.shape
    kv_heads = k.shape[2]
    g = g_orig = h // kv_heads
    q = q.reshape(b, sq, kv_heads, g_orig, hd)
    if pad_heads > h:
        g = -(-pad_heads // kv_heads)
        q = torch.nn.functional.pad(q, (0, 0, 0, g - g_orig))
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sq)
    qr = q.permute(0, 2, 3, 1, 4)                  # [B, KV, G, S, hd]
    kr = k.permute(0, 2, 3, 1)                     # [B, KV, hd, S]
    vr = v.permute(0, 2, 1, 3)                     # [B, KV, S, hd]
    o = flash_attention(qr, kr, vr, True, window, q_block, kv_block)
    o = o[:, :, :g_orig].permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return _out(o, params["wo"])


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
    o = attend_cached(q, k_new, v_new, cache, cur)
    return _out(o, params["wo"]), cache


def attend_cached(q, k_new, v_new, cache: dict, cur: torch.Tensor):
    """The decode step's attention: write each row's new K/V ([B, 1, KV,
    hd]) at its position ``cur`` ([B]) in ``cache`` (in place), then
    attend its query ([B, 1, H, hd]) over positions <= it.  Scores and
    softmax in f32; returns [B, 1, H, hd] in q's dtype."""
    b, _, h, hd = q.shape
    rows = torch.arange(b, device=q.device)
    cache["k"][rows, cur] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, cur] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    kv_heads = k.shape[2]
    qr = q.reshape(b, 1, kv_heads, h // kv_heads, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) / (hd ** 0.5)
    valid = torch.arange(length, device=q.device)[None, :] <= cur[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)
