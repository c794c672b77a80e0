"""Mamba-1 selective state-space block, the falcon-mamba and jamba mixer
(counterpart of ``repro.models.ssm``).

Training and prefill run the reference's *chunked* scan: an outer loop
over chunks of 128 positions carries the ``[B, d_inner, d_state]`` f32
state, and an inclusive scan inside each chunk combines ``(a1, b1)``
then ``(a2, b2)`` into ``(a1 a2, a2 b1 + b2)``.  Stable PyTorch has no
eager associative scan, so the chunk's is Hillis–Steele: log2(chunk)
doubling steps over shifted slices (7 for a chunk of 128), each a fused
multiply-add over the chunk.  The chunk is laid out position-major
(``[L, B, d_inner, d_state]``), so the shifted slices are contiguous,
and the carried state is folded into the first position, so the scan's
result is the state at every position.  Its backward pass
(:class:`_ChunkScan`) is the transposed recurrence, the same scan run
from the chunk's end, rather than autograd through the doubling steps.
Each chunk runs under ``torch.utils.checkpoint`` (the reference wraps
its chunk step in ``jax.checkpoint``): the backward pass recomputes one
chunk's tensors at a time.

Decode is the exact one-step recurrence with a ``(d_conv - 1)``-row
convolution state.  Both ``mamba(return_state=True)`` and
:func:`mamba_decode` return the new state; the caller writes it into
its cache.  The conv state handed from prefill to decode is the last
``d_conv - 1`` rows of the zero-padded input, so a prompt shorter than
that keeps its leading zeros (the reference's ``u_raw[:, -(d_conv -
1):]`` is short there; ROADMAP C.4).

Precision follows the reference: ``in_proj`` / ``out_proj`` in the
compute dtype; ``x_proj`` and ``dt_proj``, whose results the reference
asks for and keeps in f32, from f32 operands (the compute-dtype weights
widened exactly), so B, C and dt are never rounded to the compute dtype
on the way; the scan, the skip and the gate in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.param import ParamDef

CHUNK = 128


def _dt_rank(d_model: int) -> int:
    return -(-d_model // 16)   # ceil(d/16), mamba-1 default


def mamba_defs(d_model: int, *, d_state: int, d_conv: int, expand: int,
               dtype: torch.dtype) -> dict:
    d_in = expand * d_model
    r = _dt_rank(d_model)
    f32 = torch.float32
    return {
        "in_proj": ParamDef((d_model, 2 * d_in), ("embed_fsdp", "ssm_inner"),
                            dtype=dtype, fan_in=d_model),
        "conv_w": ParamDef((d_conv, d_in), ("conv", "ssm_inner"),
                           dtype=dtype, fan_in=d_conv),
        "conv_b": ParamDef((d_in,), ("ssm_inner",), init="zeros",
                           dtype=dtype),
        "x_proj": ParamDef((d_in, r + 2 * d_state), ("ssm_inner", None),
                           dtype=dtype, fan_in=d_in),
        "dt_proj": ParamDef((r, d_in), (None, "ssm_inner"), dtype=dtype,
                            fan_in=r),
        "dt_bias": ParamDef((d_in,), ("ssm_inner",), init="zeros",
                            dtype=f32),
        "a_log": ParamDef((d_in, d_state), ("ssm_inner", "ssm_state"),
                          init="ones", dtype=f32),
        "d_skip": ParamDef((d_in,), ("ssm_inner",), init="ones", dtype=f32),
        "out_proj": ParamDef((d_in, d_model), ("ssm_inner", "embed_fsdp"),
                             dtype=dtype, fan_in=d_in),
    }


def _f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` rounded to ``x``'s dtype, computed from f32
    operands: the reference's ``preferred_element_type=f32`` result
    (products of two compute-dtype values are exact in f32)."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


def _ssm_inputs(params, u: torch.Tensor, d_state: int):
    """The shared pre-scan computation.  u: [B, L, d_in] (after the conv
    and silu) -> (dA, dB·x: [B, L, d_in, N], C: [B, L, N]), all f32."""
    r = params["dt_proj"].shape[0]
    dt_bc = _f32_matmul(u, params["x_proj"])
    dt, b_mat, c_mat = torch.split(dt_bc, [r, d_state, d_state], dim=-1)
    dt = _f32_matmul(dt.to(u.dtype), params["dt_proj"])
    dt = F.softplus(dt + params["dt_bias"])               # [B, L, d_in]
    a = -torch.exp(params["a_log"])                        # [d_in, N]
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * u.float())[..., None] * b_mat[:, :, None, :]
    return da, dbx, c_mat


def _conv1d(params, x: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv (kernel d_conv).  x: [B, L, d_in]; ``state``
    the previous ``d_conv - 1`` rows (zeros when None).  Returns the
    output and the last ``d_conv - 1`` rows of the padded input."""
    d_conv = params["conv_w"].shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = params["conv_w"].to(x.dtype)
    n = x.shape[1]
    out = sum(xp[:, i:i + n] * w[i] for i in range(d_conv))
    new_state = xp[:, -(d_conv - 1):] if d_conv > 1 else pad
    return out + params["conv_b"].to(x.dtype), new_state


def _scan(a: torch.Tensor, b: torch.Tensor, *, reverse: bool = False):
    """Inclusive scan along axis 0 (Hillis–Steele, no autograd).
    Forward: h_t = a_t h_{t-1} + b_t (``a`` as long as ``b``, a_0
    unused).  Reverse: h_t = a_t h_{t+1} + b_t (``a`` one shorter: a_t
    multiplies h_{t+1}).  Each doubling step writes one buffer of a
    pair: b's shifted fused multiply-add, the b entries the step leaves
    alone copied, and the products of ``a`` over windows twice as long,
    only where the next step reads them."""
    n, off = b.shape[0], 1
    b_bufs = (torch.empty_like(b), torch.empty_like(b))
    a_bufs = (torch.empty_like(a), torch.empty_like(a))
    i = 0
    while off < n:
        out = b_bufs[i]
        if reverse:      # out[t] = b[t] + a[t] b[t + off]
            out[n - off:].copy_(b[n - off:])
            torch.addcmul(b[:n - off], a[:n - off], b[off:],
                          out=out[:n - off])
        else:            # out[t] = b[t] + a[t] b[t - off]
            out[:off].copy_(b[:off])
            torch.addcmul(b[off:], a[off:], b[:n - off], out=out[off:])
        b = out
        if 2 * off < n:  # a over windows of 2 off where the next step reads
            a_out = a_bufs[i]
            if reverse:
                torch.mul(a[:n - 2 * off], a[off:n - off],
                          out=a_out[:n - 2 * off])
            else:
                torch.mul(a[2 * off:], a[off:n - off], out=a_out[2 * off:])
            a = a_out
        off *= 2
        i ^= 1
    return b


class _ChunkScan(torch.autograd.Function):
    """One chunk's recurrence, position-major.  Inputs: dA, dB·x
    ([L, B, d_in, N] f32), C ([L, B, N]) and the carried state h0
    ([B, d_in, N]).  Outputs: y_t = sum_n h_t C_t ([L, B, d_in]) and
    the last state.  Backward: with G_t = dy_t C_t (the last state's
    cotangent added at t = L - 1), the state's total cotangent is the
    reverse recurrence H_t = dA_{t+1} H_{t+1} + G_t; then d(dB·x) = H,
    d(dA_t) = H_t h_{t-1}, dh0 = dA_0 H_0, dC_t = sum_d h_t dy_t."""

    @staticmethod
    def forward(ctx, da, dbx, c, h0):
        b = dbx.clone()
        b[0].addcmul_(da[0], h0)
        h = _scan(da, b)
        ctx.save_for_backward(da, c, h0, h)
        return torch.einsum("lbdn,lbn->lbd", h, c), h[-1].clone()

    @staticmethod
    def backward(ctx, dy, dh_last):
        da, c, h0, h = ctx.saved_tensors
        g = dy[..., None] * c[:, :, None, :]
        if dh_last is not None:
            g[-1] += dh_last
        hh = _scan(da[1:], g, reverse=True)
        dda = torch.empty_like(hh)
        torch.mul(hh[1:], h[:-1], out=dda[1:])
        torch.mul(hh[0], h0, out=dda[0])
        dc = torch.einsum("lbdn,lbd->lbn", h, dy)
        return dda, hh, dc, da[0] * hh[0]


def _chunk_step(params, h: torch.Tensor, u_chunk: torch.Tensor,
                d_state: int):
    """One chunk: h [B, d_in, N] f32 carried in -> (h out, y [B, L,
    d_in] f32)."""
    da, dbx, c_mat = _ssm_inputs(params, u_chunk.transpose(0, 1), d_state)
    y, h_last = _ChunkScan.apply(da, dbx, c_mat, h)
    return h_last, y.transpose(0, 1)


def mamba(params, x: torch.Tensor, *, d_state: int, chunk: int = CHUNK,
          return_state: bool = False):
    """Training / prefill forward.  x: [B, S, d_model] -> [B, S,
    d_model]; S must be a multiple of ``min(chunk, S)``, as in the
    reference.  With ``return_state`` also returns ``{"ssm": [B, d_in,
    N] f32, "conv": [B, d_conv - 1, d_in]}`` for the decode handoff."""
    dt = x.dtype
    b, s, _ = x.shape
    xz = torch.matmul(x, params["in_proj"].to(dt))
    u, z = xz.chunk(2, dim=-1)                            # [B, S, d_in] x2
    u, conv_state = _conv1d(params, u)
    u = F.silu(u)
    chunk = min(chunk, s)
    if s % chunk != 0:
        raise ValueError(
            f"sequence length {s} not divisible by ssm scan chunk {chunk}")
    h = torch.zeros((b, u.shape[-1], d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        h, y = checkpoint(_chunk_step, params, h, u[:, c0:c0 + chunk],
                          d_state, use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    y = torch.cat(ys, dim=1) + params["d_skip"] * u.float()
    y = (y * F.silu(z.float())).to(dt)
    out = torch.matmul(y, params["out_proj"].to(dt))
    if return_state:
        return out, {"ssm": h, "conv": conv_state}
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_state_defs(batch: int, d_model: int, *, d_state: int, d_conv: int,
                    expand: int, dtype: torch.dtype = torch.float32) -> dict:
    d_in = expand * d_model
    return {
        "ssm": ParamDef((batch, d_in, d_state),
                        ("batch", "ssm_inner", "ssm_state"), init="zeros",
                        dtype=torch.float32),
        "conv": ParamDef((batch, d_conv - 1, d_in),
                         ("batch", "conv", "ssm_inner"), init="zeros",
                         dtype=dtype),
    }


def mamba_decode(params, x: torch.Tensor, state: dict, *, d_state: int
                 ) -> tuple[torch.Tensor, dict]:
    """One-token step.  x: [B, 1, d_model] -> (y [B, 1, d_model], the new
    state); ``state`` is read, not written."""
    dt = x.dtype
    xz = torch.matmul(x, params["in_proj"].to(dt))
    u, z = xz.chunk(2, dim=-1)
    u, conv_state = _conv1d(params, u, state["conv"])
    u = F.silu(u)
    da, dbx, c_mat = _ssm_inputs(params, u, d_state)     # L == 1
    h = state["ssm"] * da[:, 0] + dbx[:, 0]              # [B, d_in, N]
    y = torch.einsum("bds,bs->bd", h, c_mat[:, 0])[:, None, :]
    y = y + params["d_skip"] * u.float()
    y = (y * F.silu(z.float())).to(dt)
    y = torch.matmul(y, params["out_proj"].to(dt))
    return y, {"ssm": h, "conv": conv_state}
