"""Grouped (per-expert) matmul with a fused activation: the CUDA kernels
of ``csrc/gmm.cuh`` (instantiated by ``csrc/gmm*.cu``) and their plain
PyTorch version, and its custom VJP.

Replaces ``repro/kernels/gmm.py::_gmm_kernel``: ``[E, C, K] x [E, K, N]
-> [E, C, N]`` with an f32 accumulator and a none / relu / silu
epilogue; and ``_gmm_bwd`` (l.283) as :class:`GMMFn`, whose two
products read an operand transposed in place (``trans_x`` /
``trans_w``).  Two kernels, both on the tensor cores (:func:`kernel_for`
picks one per call): the streaming kernel for bf16 with at most
:data:`STREAM_MAX_C` rows an expert (serving), the tiled kernel for
everything else (f32 as 3xTF32, bf16 above that, every transposed
layout).  ``rows`` (``[E]`` int32, the filled leading rows of each
expert, :func:`repro_torch.core.dispatch.filled_rows`) lets both skip
what holds no token.  ``out_dtype=torch.float32`` stores the forward
layout's f32 accumulator without the cast (a d_ff slice's partial sums,
``core/expert_parallel.py``).  The reference's tiling table
(``gmm_tunings.json``) was measured in CPU interpret mode and is not
carried over; the CUDA source carries the design notes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

ACTIVATIONS = {"none": 0, "relu": 1, "silu": 2}
# Kernel codes of csrc/gmm.cuh (GmmKernel).
KERNELS = {"stream": 1, "tile": 2}
# The streaming kernel's range: bf16, forward layout, C at most this.
STREAM_MAX_C = 64

# Experts per step of the plain version: at most 256 Mi f32 weight
# elements (1 GiB) are upcast at once, never the whole weight tensor.
_PLAIN_CHUNK_ELEMS = 1 << 28


def activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    """The epilogue, in the kernel's arithmetic."""
    if activation == "relu":
        return torch.clamp(z, min=0.0)
    if activation == "silu":
        return z * (1.0 / (1.0 + torch.exp(-z)))
    if activation != "none":
        raise ValueError(f"unknown gmm activation {activation!r} "
                         f"(expected one of {sorted(ACTIVATIONS)})")
    return z


def expert_chunk(k: int, n: int) -> int:
    """Experts per step when upcasting [k, n] weight slices to f32."""
    return max(1, _PLAIN_CHUNK_ELEMS // max(k * n, 1))


def _logical(x: torch.Tensor, trans: bool) -> torch.Tensor:
    return x.transpose(1, 2) if trans else x


def mask_rows(t: torch.Tensor, rows: torch.Tensor | None) -> torch.Tensor:
    """Zero the rows of ``t`` [E, R, *] at or beyond ``rows[e]`` (no host
    sync); ``rows=None`` returns ``t``."""
    if rows is None:
        return t
    keep = torch.arange(t.shape[1], device=t.device)[None, :] < rows[:, None]
    return torch.where(keep[..., None], t, torch.zeros((), dtype=t.dtype,
                                                       device=t.device))


def gmm_plain(x: torch.Tensor, w: torch.Tensor, activation: str = "none",
              trans_x: bool = False, trans_w: bool = False,
              rows: torch.Tensor | None = None,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: f32 products over expert chunks, then the
    epilogue and one cast to ``out_dtype`` (default x.dtype).  The flags
    read x / w transposed (as views); ``rows`` zeroes x's stored rows at
    or beyond ``rows[e]`` and, unless x is read transposed, the
    output's, as the kernels do."""
    xl, wl = _logical(mask_rows(x, rows), trans_x), _logical(w, trans_w)
    e, c, k = xl.shape
    n = wl.shape[-1]
    out = torch.empty((e, c, n), dtype=out_dtype or x.dtype, device=x.device)
    step = expert_chunk(k, n)
    for e0 in range(0, e, step):
        z = torch.bmm(xl[e0:e0 + step].float(), wl[e0:e0 + step].float())
        out[e0:e0 + step] = activate(z, activation).to(out.dtype)
    return out if trans_x else mask_rows(out, rows)


def kernel_for(dtype: torch.dtype, c: int, transposed: bool) -> str:
    """The kernel a call runs: ``"stream"`` for bf16 in the forward
    layout with at most STREAM_MAX_C rows an expert, else ``"tile"``."""
    if dtype == torch.bfloat16 and not transposed and c <= STREAM_MAX_C:
        return "stream"
    return "tile"


def gmm(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
        trans_x: bool = False, trans_w: bool = False,
        rows: torch.Tensor | None = None,
        kernel: str | None = None,
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[E, C, K] x [E, K, N] -> [E, C, N] in ``out_dtype``: x.dtype
    (default), or float32 in the forward layout, the accumulator stored
    without the cast.  ``trans_x`` reads x
    stored as [E, K, C], ``trans_w`` reads w stored as [E, N, K], in
    place (the backward pass's layouts, one operand at a time).
    ``rows`` ([E] int32, e.g. a dispatch buffer's filled slots): x's
    rows as stored (its dimension 1) at or beyond ``rows[e]`` are taken
    as zeros and not read, so the output rows there are zeros (with
    ``trans_x``, where they are the reduction, it stops there).
    ``kernel`` forces ``"stream"`` or ``"tile"`` (measurements and
    tests); ``None`` takes :func:`kernel_for`'s choice.  CPU tensors take
    the plain version; CUDA tensors launch a kernel or raise; meta
    tensors in ``cuda_lib.meta_trace()`` trace the launch."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown gmm activation {activation!r} "
                         f"(expected one of {sorted(ACTIVATIONS)})")
    if trans_x and trans_w:
        raise ValueError("gmm: at most one operand is read transposed "
                         "(the backward pass's layouts)")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"gmm: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be 3-d")
    e, c, k = _logical(x, trans_x).shape
    _, kw, n = _logical(w, trans_w).shape
    if w.shape[0] != e or kw != k:
        raise ValueError(f"gmm: x {tuple(x.shape)} (trans {trans_x}) and "
                         f"w {tuple(w.shape)} (trans {trans_w}) are not "
                         "[E, C, K] x [E, K, N]")
    if x.dtype != w.dtype:
        raise ValueError(f"gmm: x {x.dtype} and w {w.dtype} differ")
    transposed = trans_x or trans_w
    out_dtype = out_dtype or x.dtype
    if out_dtype != x.dtype and (out_dtype != torch.float32 or transposed):
        raise ValueError(f"gmm: out_dtype {out_dtype} for {x.dtype} "
                         f"operands (transposed = {transposed}); only the "
                         "forward layout stores f32 instead")
    if rows is not None:
        if rows.shape != (e,) or rows.dtype != torch.int32:
            raise ValueError(f"gmm: rows must be [{e}] int32, got "
                             f"{tuple(rows.shape)} {rows.dtype}")
        if rows.device != x.device:
            raise ValueError(f"gmm: rows on {rows.device}, x on {x.device}")
    if kernel is None:
        kernel = kernel_for(x.dtype, c, transposed)
    if kernel not in KERNELS:
        raise ValueError(f"gmm: unknown kernel {kernel!r} "
                         f"(expected one of {sorted(KERNELS)})")
    if kernel == "stream" and kernel_for(x.dtype, c, transposed) != "stream":
        raise ValueError(f"gmm: the streaming kernel takes bf16 in the "
                         f"forward layout with C <= {STREAM_MAX_C}, got "
                         f"{x.dtype}, C = {c}, transposed = {transposed}")
    if x.device.type == "cpu":
        return gmm_plain(x, w, activation, trans_x, trans_w, rows,
                         out_dtype)
    launch = cuda_lib.launches("gmm", x.device)
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"gmm: unsupported dtype {x.dtype}")
    cuda_lib.check_cuda("gmm", x, w, *(() if rows is None else (rows,)))
    out = torch.empty((e, c, n), dtype=out_dtype, device=x.device)
    if not launch:
        return out
    cuda_lib.call("repro_gmm", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  None if rows is None else rows.data_ptr(), e, c, k, n,
                  ACTIVATIONS[activation], cuda_lib.DTYPE_CODES[x.dtype],
                  cuda_lib.DTYPE_CODES[out_dtype], int(trans_x),
                  int(trans_w), KERNELS[kernel])
    # Counted by layout, whichever kernel ran: the backward pass's
    # transposed products are "gmm_bwd".
    cuda_lib.count("gmm_bwd" if transposed else "gmm")
    return out


def act_grad(z: torch.Tensor, activation: str) -> torch.Tensor:
    """d act(z) / dz in f32 (the reference's ``_act_grad``)."""
    if activation == "relu":
        return (z > 0.0).float()
    if activation == "silu":
        sg = torch.sigmoid(z)
        return sg * (1.0 + z * (1.0 - sg))
    if activation != "none":
        raise ValueError(f"unknown gmm activation {activation!r}")
    return torch.ones_like(z)


class GMMFn(torch.autograd.Function):
    """Differentiable :func:`gmm`: ``apply(x, w, activation, rows,
    out_dtype)``; an f32 output's cotangent is cast to x's dtype, the
    operands' type of the backward products.
    Backward (the reference's ``_gmm_bwd``): the pre-activation z is
    recomputed with one more forward GMM (``activation="none"``), ``dz =
    g * act'(z)`` in f32 cast to g's dtype, then ``dx = gmm(dz, w^T)`` and
    ``dw = gmm(x^T, dz)`` with the operands read transposed in place.
    All three take ``rows``: dz's rows past it are not read (the VJP of
    the masked product), so dx's rows there are zeros and dw's reduction
    stops there."""

    @staticmethod
    def forward(ctx, x, w, activation, rows=None, out_dtype=None):
        ctx.save_for_backward(x, w, rows)
        ctx.activation = activation
        return gmm(x, w, activation=activation, rows=rows,
                   out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, rows = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if ctx.activation != "none":
            z = gmm(x, w, activation="none", rows=rows)
            g = (g.float() * act_grad(z.float(), ctx.activation)).to(g.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(g, w, trans_w=True, rows=rows).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gmm(x, g, trans_x=True, rows=rows).to(w.dtype)
        return dx, dw, None, None, None
