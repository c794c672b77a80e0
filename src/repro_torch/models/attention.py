"""Grouped-query attention for training, prefill and decode
(counterpart of ``repro.models.attention``).

The reference's attention is plain jnp (no Pallas kernel), so the port
writes it as plain torch: f32 scores, f32 softmax, masked entries at
NEG_INF.  Training runs :class:`FlashAttentionFn`, the reference's
``flash_attention`` with its custom VJP: block by block over query and
key / value blocks with an online softmax, only the blocks at or below
the diagonal, and a backward pass that recomputes the probabilities
from the saved log-sum-exp, so no ``[S, S]`` tensor is ever kept.
Prefill runs :func:`blockwise_attention`, the reference's: the same
online softmax over the same static block ranges, with a query offset
for a chunk against its cached prefix, a sliding window and an optional
``kv_len``, so a prompt's attention holds one ``[q_block, kv_block]``
block of scores a kv head at a time, never the whole ``[Sq, Skv]``
matrix.  :func:`causal_attention` forms that whole matrix at once; it
serves no path, and stays as the plain version that tests and the card's
smoke hold the blockwise one against.  Decode attends one
query per row against the slot cache at the row's own position.  A
sliding-window layer's cache is a ring buffer of ``min(window,
max_len)`` positions: position p lives in slot ``p % length``.

Caches are updated in place: the engine owns one pool and the layers
write their new K/V into it, where the reference returns new arrays.

On a mesh (``ctx`` with the serving decode plan) a decode cache may be
sharded over its sequence (``kv_seq``, over ``model`` under
``decode_std``): each rank holds ``max_len / M`` consecutive positions
of every page, and of a sliding-window ring whose length divides, ``L /
M`` consecutive slots.  :func:`attend_cached_sharded` then writes the
new K/V only on the rank that owns the row's position (or ring slot),
attends over the local positions and combines the ranks' softmax in the
flash-decoding way.
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


def _kv_pick(params, ctx, axes):
    """The key / value heads that this rank's query heads read, where
    the query heads run tensor-parallel over the mesh ``axes`` and the
    key / value heads are whole: ``wq`` holds query heads [h0, h0 + n)
    of H = n x ranks, KV-major (query head h reads kv head h // G, G = H
    / KV).  A slice where those heads are whole kv groups or lie in one
    group, else one kv head a query head (an index tensor)."""
    n, kvh = params["wq"].shape[1], params["wk"].shape[1]
    g = n * ctx.size(axes) // kvh
    h0 = ctx.index(axes) * n
    if n % g == 0 or g % n == 0:
        return slice(h0 // g, h0 // g + max(n // g, 1))
    return (h0 + torch.arange(n, device=params["wk"].device)) // g


def _take(t: torch.Tensor, dim: int, pick) -> torch.Tensor:
    """``t``'s entries ``pick`` (a slice or an index tensor) of ``dim``."""
    if isinstance(pick, slice):
        return t.narrow(dim, pick.start, pick.stop - pick.start)
    return t.index_select(dim, pick)


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
              window: int, q_offset: int = 0) -> tuple[int, int]:
    """Static kv-block range visible to query block i, whose first query
    sits at position ``q_offset + i * q_block``."""
    first = q_offset + i * q_block
    if causal:
        hi = min(nkv, (first + q_block + kv_block - 1) // kv_block)
    else:
        hi = nkv
    lo = max(0, (first + 1 - window) // kv_block) if window > 0 else 0
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


def _mask(i: int, j: int, q_block: int, kv_block: int, causal: bool,
          window: int, q_offset: int = 0, kv_len=None, device=None):
    """The [qb, kvb] visibility of query block i (query r at position
    ``q_offset + i * q_block + r``) against kv block j, or None where the
    block is wholly visible: a mask is built only for a block that
    crosses the diagonal (its last key after its first query), the
    window's lower edge (its first key at or below its last query's
    minus the window) or ``kv_len``, as the reference's masks leave the
    others whole."""
    first_q, first_k = q_offset + i * q_block, j * kv_block
    causal_cut = causal and first_k + kv_block - 1 > first_q
    window_cut = window > 0 and first_k <= first_q + q_block - 1 - window
    if not (causal_cut or window_cut or kv_len is not None):
        return None
    pos_q = first_q + torch.arange(q_block, device=device)
    pos_k = first_k + torch.arange(kv_block, device=device)
    mask = torch.ones((q_block, kv_block), dtype=torch.bool, device=device)
    if causal_cut:
        mask &= pos_k[None, :] <= pos_q[:, None]
    if window_cut:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    if kv_len is not None:
        mask &= (pos_k < kv_len)[None, :]
    return mask


def _scores(q_i, k_j, i, j, q_block, kv_block, causal, window, scale):
    """f32 scores of query block i against kv block j, masked (the
    backward pass's): q_i [B,KV,G,qb,hd], k_j [B,KV,hd,kvb] ->
    [B,KV,G,qb,kvb]."""
    s = _gmat(q_i, k_j) * scale
    mask = _mask(i, j, q_block, kv_block, causal, window, device=s.device)
    return s if mask is None else torch.where(mask, s, NEG_INF)


def _block_forward(qr, kr, vr, causal: bool, window: int, q_block: int,
                   kv_block: int, q_offset: int = 0, kv_len=None):
    """The one blockwise forward (the reference's ``_flash_fwd_impl``
    and ``blockwise_attention``): qr [B,KV,G,Sq,hd], kr [B,KV,hd,Skv],
    vr [B,KV,Skv,hd] -> (out [B,KV,G,Sq,hd] in qr's dtype, lse
    [B,KV,G,Sq] f32).  For each query block an online softmax over the
    kv blocks of its static range (``_kv_range`` at ``q_offset``):
    scores in f32, the probabilities meet v in v's dtype.  K, V and each
    query block are cast to f32 once, and a kv head's G query heads
    and the block's queries are one [G*qb, hd] operand of a batched
    matmul over the B*KV heads, so a block pair costs a score product,
    the online update and a value product, each a few ops.  A length
    its block does not divide raises, as in the reference."""
    b, kvh, g, sq, hd = qr.shape
    skv = kr.shape[-1]
    if sq % q_block or skv % kv_block:
        raise ValueError(
            f"sequence lengths must divide the attention blocks: "
            f"sq={sq} % q_block={q_block}, skv={skv} % kv_block={kv_block}")
    nq, nkv = sq // q_block, skv // kv_block
    bkv, rows = b * kvh, g * q_block
    scale = 1.0 / (hd ** 0.5)
    kf = kr.float().reshape(bkv, hd, skv)
    vf = vr.float().reshape(bkv, skv, hd)
    low = vr.dtype != torch.float32
    out = torch.empty_like(qr)
    lse = torch.empty((b, kvh, g, sq), dtype=torch.float32,
                      device=qr.device)
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        q_i = qr[:, :, :, qs].float().reshape(bkv, rows, hd)
        acc = torch.zeros((bkv, rows, hd), dtype=torch.float32,
                          device=qr.device)
        m = torch.full((bkv, rows), NEG_INF, dtype=torch.float32,
                       device=qr.device)
        l = torch.zeros_like(m)
        lo, hi = _kv_range(i, nkv, q_block, kv_block, causal, window,
                           q_offset)
        for j in range(lo, hi):
            ks = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.bmm(q_i, kf[:, :, ks]).mul_(scale)
            mask = _mask(i, j, q_block, kv_block, causal, window, q_offset,
                         kv_len, qr.device)
            if mask is not None:
                s = torch.where(mask, s.view(bkv, g, q_block, kv_block),
                                NEG_INF).view(bkv, rows, kv_block)
            # In place where the old value is dead (m becomes alpha):
            # the same values, fewer allocations.
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = m.sub_(m_new).exp_()
            p = s.sub_(m_new.unsqueeze(-1)).exp_()
            l.mul_(alpha).add_(p.sum(dim=-1))
            if low:
                p = p.to(vr.dtype).float()
            acc.mul_(alpha.unsqueeze(-1)).add_(torch.bmm(p, vf[:, ks]))
            m = m_new
        lsafe = torch.clamp(l, min=1e-30)
        out[:, :, :, qs] = (acc / lsafe.unsqueeze(-1)).to(qr.dtype).view(
            b, kvh, g, q_block, hd)
        lse[:, :, :, qs] = (m + torch.log(lsafe)).view(b, kvh, g, q_block)
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """The reference's ``flash_attention`` (``_flash_fwd_impl`` /
    ``_flash_bwd``): ``apply(qr, kr, vr, causal, window, q_block,
    kv_block)`` with qr [B,KV,G,Sq,hd], kr [B,KV,hd,Skv], vr
    [B,KV,Skv,hd] -> [B,KV,G,Sq,hd] in qr's dtype.

    Forward (:func:`_block_forward`, the one blockwise forward prefill
    runs too): for each query block, an online softmax over the kv
    blocks of its static range (``_kv_range``); scores in f32, the
    probabilities meet v in v's dtype; it saves only (q, k, v, out,
    lse).  Backward: delta = rowsum(dout * out); dq query-block-major
    over the same ranges, dk / dv kv-block-major over ``_q_range``, each
    recomputing p = exp(s - lse) block by block, in f32, cast back to the
    input dtypes at the end."""

    @staticmethod
    def forward(ctx, qr, kr, vr, causal, window, q_block, kv_block):
        out, lse = _block_forward(qr, kr, vr, causal, window, q_block,
                                  kv_block)
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


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_block: int = 512, kv_block: int = 512,
                        kv_len=None, q_offset: int = 0) -> torch.Tensor:
    """The reference's ``blockwise_attention``: q [B,Sq,H,hd], k / v
    [B,Skv,KV,hd] -> [B,Sq,H,hd] in q's dtype, through
    :func:`_block_forward`.  Query i sits at position ``q_offset + i``
    against kv positions ``0..Skv`` (a chunk against its cached prefix);
    the static per-block kv ranges prune above the shifted diagonal and
    below the window.  ``kv_len`` (an int or a 0-d tensor) masks a padded
    cache tail.  The blocks are ``min(block, length)``; a length they do
    not divide raises, as in the reference."""
    b, sq, h, hd = q.shape
    skv, kv_heads = k.shape[1], k.shape[2]
    g = h // kv_heads
    qr = q.reshape(b, sq, kv_heads, g, hd).permute(0, 2, 3, 1, 4)
    out, _ = _block_forward(qr, k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3),
                            causal, window, min(q_block, sq),
                            min(kv_block, skv), q_offset, kv_len)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def attention(params, x, positions, *, rope_theta: float, qk_norm: bool,
              window: int = 0, q_block: int = 512, kv_block: int = 512,
              pad_heads: int = 0, ctx=None, tp: tuple = ((), ())
              ) -> torch.Tensor:
    """Causal self-attention for training.  x: [B, S, d] -> [B, S, d].

    ``window`` > 0 lets query i see keys in (i - window, i].
    ``pad_heads`` pads the query heads of each KV group with zero heads
    up to this many in all; their outputs are sliced off before the
    output projection, so the result is unchanged.

    ``tp`` = (the mesh axes of ``ctx`` over which the query heads run
    tensor-parallel, those of the key / value heads;
    ``MeshContext.tp_axes``): ``wq`` / ``wo`` hold this rank's query
    heads, ``wk`` / ``wv`` its key / value heads where they split, else
    all of them, of which the rank cuts the groups its heads read (a
    local cut: its gradient is partial, and the trainer's replica sum
    adds the ranks' parts).  The output projection of the rank's heads
    is a partial ``[B, S, d]``, summed over the ranks (padding applies
    to whole heads only)."""
    h_axes, kv_axes = tp
    if h_axes and not kv_axes:
        pick = _kv_pick(params, ctx, h_axes)
        params = dict(params, wk=_take(params["wk"], 1, pick),
                      wv=_take(params["wv"], 1, pick))
    if h_axes:
        pad_heads = 0
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
    y = _out(o, params["wo"])
    return ctx.all_reduce(y, h_axes) if h_axes else y


def causal_attention(q, k, v, *, kv_len: int | None = None,
                     q_offset: int = 0, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd]: the plain
    whole-matrix version of :func:`blockwise_attention`, which tests and
    the card's smoke hold it against (no serving path calls it).

    Query i sits at position ``q_offset + i`` and sees kv positions
    <= its own (and < ``kv_len`` when given; with ``window`` > 0, only
    those above its own minus ``window``).  Scores and softmax in f32;
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
    if window > 0:
        mask = mask & (pos_k[None, :] > pos_q[:, None] - window)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def prefill_attention(params, x, positions, *, rope_theta: float,
                      qk_norm: bool, cache: dict, window: int = 0,
                      q_block: int = 512, kv_block: int = 512,
                      offset: int | None = None, ctx=None,
                      tp: tuple = ((), ())):
    """Prefill: causal :func:`blockwise_attention` over blocks of
    ``min(q_block, S)`` x ``min(kv_block, S)`` that also writes K/V for
    positions [0, S) into ``cache`` (in place).  Returns (y, cache).

    A sliding-window layer (``window`` > 0) attends within its window
    and writes its ring buffer: the last ``length`` positions at slots
    ``pos % length`` when S >= length, else positions [0, S).

    ``offset`` is chunked-prefill mode: the S tokens are the prompt
    slice at positions [offset, offset + S); their K/V lands at that
    range of ``cache`` and they attend over the cached prefix [0,
    offset), cast to the compute dtype, followed by the chunk's own K/V
    at its absolute positions.  A ring buffer has no such prefix, so an
    offset on a windowed layer raises.

    ``tp``: as :func:`attention`.  Where the key / value heads split,
    ``cache`` holds this rank's of them and the rank writes its own;
    where they are whole, every rank writes all of them into its whole
    page and attends with the groups its query heads read.  The output
    is summed over the ranks."""
    if offset is not None and window:
        raise ValueError(
            "chunked prefill is unsupported for sliding-window layers")
    h_axes, kv_axes = tp
    pick = (_kv_pick(params, ctx, h_axes) if h_axes and not kv_axes
            else None)
    q, k, v = _qkv(params, x, positions, rope_theta=rope_theta,
                   qk_norm=qk_norm)
    if not window:
        o = attend_chunk(q, k, v, cache,
                         0 if offset is None else int(offset),
                         q_block=q_block, kv_block=kv_block, pick=pick)
        y = _out(o, params["wo"])
        return (ctx.all_reduce(y, h_axes) if h_axes else y), cache
    o = blockwise_attention(q, k if pick is None else _take(k, 2, pick),
                            v if pick is None else _take(v, 2, pick),
                            window=window, q_block=q_block,
                            kv_block=kv_block)
    s, length = k.shape[1], cache["k"].shape[1]
    if s >= length:
        tail = torch.arange(s - length, s, device=k.device)
        slots = tail % length
        cache["k"][:, slots] = k[:, tail].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, tail].to(cache["v"].dtype)
    else:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
    y = _out(o, params["wo"])
    return (ctx.all_reduce(y, h_axes) if h_axes else y), cache


def attend_chunk(q, k, v, cache: dict, off: int, *, q_block: int = 512,
                 kv_block: int = 512, pick=None) -> torch.Tensor:
    """Write the chunk's K/V ([B, S, KV, hd]) at cache positions [off,
    off + S) in place, then attend its queries over [cached prefix
    [0, off), the chunk] through :func:`blockwise_attention` at
    ``q_offset = off`` (blocks of ``min(q_block, S)`` x
    ``min(kv_block, off + S)``).  The prefix is read back at the cache's
    precision, as in the reference.  ``pick`` (:func:`_kv_pick`'s)
    takes the kv heads the queries read, after the write."""
    s = k.shape[1]
    if off + s > cache["k"].shape[1]:
        raise ValueError(f"chunk [{off}, {off + s}) overruns the cache "
                         f"page of {cache['k'].shape[1]} positions")
    if off:
        # torch.cat copies, so the write below cannot reach these reads.
        k_ctx = torch.cat([cache["k"][:, :off].to(k.dtype), k], dim=1)
        v_ctx = torch.cat([cache["v"][:, :off].to(v.dtype), v], dim=1)
    else:
        k_ctx, v_ctx = k, v
    cache["k"][:, off:off + s] = k.to(cache["k"].dtype)
    cache["v"][:, off:off + s] = v.to(cache["v"].dtype)
    if pick is not None:
        k_ctx, v_ctx = _take(k_ctx, 2, pick), _take(v_ctx, 2, pick)
    return blockwise_attention(q, k_ctx, v_ctx, q_block=q_block,
                               kv_block=kv_block, q_offset=off)


def init_cache_defs(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                    *, window: int = 0, dtype=torch.bfloat16) -> dict:
    """Zero K/V pages; a sliding-window layer's is a ring buffer of
    ``min(window, max_len)`` positions, on its own logical axis
    ``kv_ring`` where the reference's says ``kv_seq``: no plan maps it,
    and the decode plan fitted to a pool (``serve/kv_cache.py::
    fit_decode_plan``) splits it over the ``kv_seq`` axes as far as its
    length divides."""
    length = min(window, max_len) if window > 0 else max_len
    shape = (batch, length, n_kv_heads, head_dim)
    axes = ("batch", "kv_ring" if window > 0 else "kv_seq", "kv_heads",
            "head_dim")
    return {"k": ParamDef(shape, axes, init="zeros", dtype=dtype),
            "v": ParamDef(shape, axes, init="zeros", dtype=dtype)}


def decode_attention(params, x, cache, cur_index, *, rope_theta: float,
                     qk_norm: bool, window: int = 0, ctx=None):
    """One-token decode.  x: [B, 1, d]; ``cur_index``: scalar or [B]
    per-row positions (slots of mixed age).  Writes the new K/V at each
    row's position in ``cache`` (in place; a windowed layer's ring
    buffer at the position modulo its length) and attends over positions
    <= it (within the ring).  With ``ctx`` (a mesh whose plan shards
    ``kv_seq``, a ring ``kv_ring``: the plan fitted to the pool) the
    cache holds this rank's positions of it.  Returns (y [B, 1, d],
    cache)."""
    b = x.shape[0]
    cur = torch.as_tensor(cur_index, device=x.device).long().reshape(-1)
    cur = cur.expand(b)
    q, k_new, v_new = _qkv(params, x, cur[:, None], rope_theta=rope_theta,
                           qk_norm=qk_norm)
    seq_axes = () if ctx is None or ctx.mesh is None else tuple(
        a for a in ctx.axes_of("kv_ring" if window else "kv_seq")
        if ctx.sizes[a] > 1)
    if seq_axes:
        o = attend_cached_sharded(q, k_new, v_new, cache, cur, ctx,
                                  seq_axes, ring=window > 0)
    else:
        o = attend_cached(q, k_new, v_new, cache, cur, ring=window > 0)
    return _out(o, params["wo"]), cache


def attend_cached(q, k_new, v_new, cache: dict, cur: torch.Tensor, *,
                  ring: bool = False):
    """The decode step's attention: write each row's new K/V ([B, 1, KV,
    hd]) at its position ``cur`` ([B]) in ``cache`` (in place), then
    attend its query ([B, 1, H, hd]) over positions <= it.  A ``ring``
    cache takes position p at slot ``p % length`` and attends every slot
    written so far (slot s then holds the latest position <= cur that
    is s modulo the length, valid once that position is >= 0).  Scores
    and softmax in f32; returns [B, 1, H, hd] in q's dtype."""
    b, _, h, hd = q.shape
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    slot = cur % length if ring else cur
    rows = torch.arange(b, device=q.device)
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)
    kv_heads = k.shape[2]
    qr = q.reshape(b, 1, kv_heads, h // kv_heads, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) / (hd ** 0.5)
    slots = torch.arange(length, device=q.device)[None, :]
    if ring:
        abs_pos = (cur[:, None] - slot[:, None] + slots
                   - length * (slots > slot[:, None]).long())
        valid = abs_pos >= 0
    else:
        valid = slots <= cur[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def attend_cached_sharded(q, k_new, v_new, cache: dict, cur: torch.Tensor,
                          ctx, axes: tuple[str, ...], *,
                          ring: bool = False) -> torch.Tensor:
    """:func:`attend_cached` over a cache whose sequence is sharded over
    the mesh ``axes``: this rank holds positions [lo, lo + L_local) of
    every row, with ``lo = ctx.index(axes) * L_local``.  The row's new
    K/V is written only where its position lies.  A ``ring`` cache of
    ``L = L_local * n`` slots over n ranks holds ring slots [lo, lo +
    L_local) here: the new K/V goes to slot ``cur % L`` on the rank that
    owns it, and slot ``lo + j`` is valid by :func:`attend_cached`'s
    ring formula at that global slot.  The softmax is
    combined over the ranks in the flash-decoding way, in three small
    all-gathers: the ranks' maxima (the global max, which every rank
    then subtracts, as one process does), the sums of their
    exponentials (each rank then normalizes its probabilities and casts
    them to the values' type, as one process does), and the weighted
    values, summed in rank order.  Only the two sums reassociate (f32),
    so the output is one process's to f32 rounding, the same on every
    rank.  Returns [B, 1, H, hd] in q's dtype."""
    b, _, h, hd = q.shape
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    lo, ring_len = ctx.index(axes) * length, length * ctx.size(axes)
    slot = cur % ring_len if ring else cur
    local = slot - lo
    mine = ((local >= 0) & (local < length))[:, None, None]
    # A row whose position lies on another rank writes its own slot's
    # value back (no shape depends on the positions: no host sync, and
    # the write traces on meta).
    rows = torch.arange(b, device=q.device)
    at = local.clamp(0, length - 1)
    k[rows, at] = torch.where(mine, k_new[:, 0].to(k.dtype), k[rows, at])
    v[rows, at] = torch.where(mine, v_new[:, 0].to(v.dtype), v[rows, at])
    kv_heads = k.shape[2]
    qr = q.reshape(b, 1, kv_heads, h // kv_heads, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qr, k.float()) / (hd ** 0.5)
    pos = lo + torch.arange(length, device=q.device)[None, :]
    if ring:
        abs_pos = (cur[:, None] - slot[:, None] + pos
                   - ring_len * (pos > slot[:, None]).long())
        valid = abs_pos >= 0
    else:
        valid = pos <= cur[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = _rank_gather(torch.amax(s, dim=-1, keepdim=True), ctx, axes)
    p = torch.exp(s - torch.amax(m, dim=0))
    total = torch.sum(_rank_gather(torch.sum(p, dim=-1, keepdim=True), ctx,
                                   axes), dim=0)
    p = (p / total).to(v.dtype).float()
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    o = torch.sum(_rank_gather(o, ctx, axes), dim=0)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _rank_gather(t, ctx, axes):
    """[n, ...]: every rank's ``t`` along ``axes``, in rank order (a sum
    or max over dim 0 is then the same on every rank).  A rank with no
    valid position holds a max of NEG_INF, whose exponentials are 0."""
    return ctx.all_gather(t[None], axes, 0)
