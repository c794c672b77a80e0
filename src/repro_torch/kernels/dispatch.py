"""Capacity-buffer dispatch and weighted combine: the CUDA kernels in
``csrc/dispatch.cu`` and their plain PyTorch versions, in two buffer
regimes, with their custom VJPs as autograd Functions.

Replaces ``repro/kernels/dispatch.py``:

* resident regime — ``_dispatch_kernel`` and ``_combine_kernel``;
* expert-blocked regime — ``_dispatch_eblock_kernel`` (over the slot
  table of ``_bucket_assignments``) and ``_combine_eblock_kernel``;
* ``_dispatch_bwd`` / ``_combine_bwd`` — :class:`DispatchFn` and
  :class:`CombineFn`, which carry ``e_block`` into their backward pass
  so that forward and backward run the same regime, as the reference's
  VJPs do.

On the TPU the regime is chosen against the VMEM budget.  The card has
no VMEM, so the port's backend keeps the resident kernels unless a
caller forces a slab (``MoEArgs.dispatch_e_block``,
``kernels/backend.py``).  The CUDA source carries the design notes.

Semantics: an assignment with ``pos >= capacity`` (dropped, or masked
padding) writes nothing in dispatch and contributes nothing in combine;
combine sums over k in ascending order in f32 (the e-blocked combine:
slab by slab, k ascending within a slab).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib


def _kept(eidx: torch.Tensor, pos: torch.Tensor, n_experts: int,
          capacity: int) -> torch.Tensor:
    return (pos >= 0) & (pos < capacity) & (eidx >= 0) & (eidx < n_experts)


def dispatch_plain(x: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor,
                   scale: torch.Tensor | None, n_experts: int,
                   capacity: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`dispatch`."""
    t, d = x.shape
    k = eidx.shape[1]
    buf = torch.zeros((n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    rows = x.repeat_interleave(k, dim=0)
    if scale is not None:
        rows = (rows.float() * scale.reshape(-1, 1).float()).to(x.dtype)
    kept = _kept(eidx, pos, n_experts, capacity).reshape(-1)
    buf[eidx.reshape(-1)[kept].long(), pos.reshape(-1)[kept].long()] = \
        rows[kept]
    return buf


def combine_plain(buf: torch.Tensor, w: torch.Tensor, eidx: torch.Tensor,
                  pos: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`combine`."""
    n_experts, capacity, d = buf.shape
    t, k = eidx.shape
    kept = _kept(eidx, pos, n_experts, capacity)
    e = torch.where(kept, eidx, 0).long()
    p = torch.where(kept, pos, 0).long()
    wk = torch.where(kept, w.float(), 0.0)
    acc = torch.zeros((t, d), dtype=torch.float32, device=buf.device)
    for j in range(k):
        acc = acc + wk[:, j:j + 1] * buf[e[:, j], p[:, j]].float()
    return acc.to(out_dtype)


def _check_plan(name, eidx, pos, t):
    if eidx.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{name}: eidx/pos must be int32")
    if eidx.shape != pos.shape or eidx.dim() != 2 or eidx.shape[0] != t:
        raise ValueError(f"{name}: eidx {tuple(eidx.shape)} / pos "
                         f"{tuple(pos.shape)} do not match {t} tokens")


def dispatch(x: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor,
             scale: torch.Tensor | None = None, *, n_experts: int,
             capacity: int) -> torch.Tensor:
    """[T, d] -> [E, C, d]: zeroed buffer with ``x[t] * scale[t, j]``
    copied into slot ``(eidx[t, j], pos[t, j])`` for kept assignments.
    ``scale=None`` means 1.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.dim() != 2:
        raise ValueError(f"dispatch: x must be [T, d], got {tuple(x.shape)}")
    _check_plan("dispatch", eidx, pos, x.shape[0])
    if x.device.type == "cpu":
        return dispatch_plain(x, eidx, pos, scale, n_experts, capacity)
    if x.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"dispatch: no kernel for device {x.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"dispatch: unsupported dtype {x.dtype}")
    tensors = [x, eidx, pos]
    if scale is not None:
        if scale.dtype != torch.float32 or scale.shape != eidx.shape:
            raise ValueError("dispatch: scale must be f32 shaped like eidx")
        tensors.append(scale)
    cuda_lib.check_cuda("dispatch", *tensors)
    t, d = x.shape
    buf = torch.empty((n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    cuda_lib.call("repro_dispatch", x.data_ptr(), eidx.data_ptr(),
                  pos.data_ptr(), 0 if scale is None else scale.data_ptr(),
                  buf.data_ptr(), t, eidx.shape[1], d, n_experts, capacity,
                  cuda_lib.DTYPE_CODES[x.dtype])
    cuda_lib.count("dispatch")
    return buf


def combine(buf: torch.Tensor, w: torch.Tensor, eidx: torch.Tensor,
            pos: torch.Tensor, *, out_dtype: torch.dtype | None = None
            ) -> torch.Tensor:
    """[E, C, d] -> [T, d]: ``y[t] = sum_j w[t, j] * buf[eidx, pos]``
    over kept slots, f32 accumulation in ascending j.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    out_dtype = out_dtype or buf.dtype
    if buf.dim() != 3:
        raise ValueError(f"combine: buf must be [E, C, d], got "
                         f"{tuple(buf.shape)}")
    _check_plan("combine", eidx, pos, w.shape[0])
    if w.shape != eidx.shape:
        raise ValueError("combine: w must be shaped like eidx")
    if buf.device.type == "cpu":
        return combine_plain(buf, w, eidx, pos, out_dtype)
    if buf.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"combine: no kernel for device {buf.device}")
    if buf.dtype not in cuda_lib.DTYPE_CODES or \
            out_dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"combine: unsupported dtypes {buf.dtype} -> "
                         f"{out_dtype}")
    if w.dtype != torch.float32:
        raise ValueError("combine: w must be float32")
    cuda_lib.check_cuda("combine", buf, w, eidx, pos)
    n_experts, capacity, d = buf.shape
    t, k = eidx.shape
    y = torch.empty((t, d), dtype=out_dtype, device=buf.device)
    cuda_lib.call("repro_combine", buf.data_ptr(), w.data_ptr(),
                  eidx.data_ptr(), pos.data_ptr(), y.data_ptr(), t, k, d,
                  n_experts, capacity, cuda_lib.DTYPE_CODES[buf.dtype],
                  cuda_lib.DTYPE_CODES[out_dtype])
    cuda_lib.count("combine")
    return y


# ---------------------------------------------------------------------------
# expert-blocked regime
# ---------------------------------------------------------------------------

def bucket_assignments(eidx: torch.Tensor, pos: torch.Tensor,
                       scale: torch.Tensor | None, n_experts: int,
                       capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_bucket_assignments``: invert the [T, k] plan
    into flat [E*C] slot tables.  ``btok[e*C + p]`` is the token row
    feeding slot p of expert e (-1 when empty) and ``bscale`` its scale
    (1 when ``scale`` is None).  Kept assignments own unique cells, so
    the slot is just ``e*C + p``; dropped ones land in a sink cell past
    the end, which is cut off.  Plain index ops (XLA in the reference),
    with no host sync."""
    t, k = eidx.shape
    n = n_experts * capacity
    ef = eidx.reshape(-1).long()
    pf = pos.reshape(-1).long()
    kept = _kept(ef, pf, n_experts, capacity)
    slot = torch.where(kept, ef * capacity + pf, n)
    tok = torch.arange(t * k, device=eidx.device, dtype=torch.int32) // k
    btok = torch.full((n + 1,), -1, dtype=torch.int32, device=eidx.device)
    btok.scatter_(0, slot, tok)
    sval = (torch.ones((t * k,), dtype=torch.float32, device=eidx.device)
            if scale is None else scale.reshape(-1).float())
    bscale = torch.zeros((n + 1,), dtype=torch.float32, device=eidx.device)
    bscale.scatter_(0, slot, sval)
    # Cut off the sink cell; empty cells keep token -1 and scale 0.
    return btok[:n].contiguous(), bscale[:n].contiguous()


def dispatch_eblock_plain(x: torch.Tensor, eidx: torch.Tensor,
                          pos: torch.Tensor, scale: torch.Tensor | None,
                          n_experts: int, capacity: int,
                          e_block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`dispatch_eblock`: every buffer row
    is ``x[btok] * bscale`` or zeros.  ``e_block`` orders the kernel's
    walk only, so it does not change the result."""
    del e_block
    btok, bscale = bucket_assignments(eidx, pos, scale, n_experts,
                                      capacity)
    rows = x[btok.clamp(min=0).long()]
    rows = (rows.float() * bscale[:, None]).to(x.dtype)
    rows = torch.where((btok >= 0)[:, None], rows, torch.zeros_like(rows))
    return rows.reshape(n_experts, capacity, x.shape[1])


def dispatch_eblock(x: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor,
                    scale: torch.Tensor | None = None, *, n_experts: int,
                    capacity: int, e_block: int) -> torch.Tensor:
    """[T, d] -> [E, C, d] through the slot table, one buffer row at a
    time, slab by slab: bit-identical to :func:`dispatch`.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.dim() != 2:
        raise ValueError(f"dispatch_eblock: x must be [T, d], got "
                         f"{tuple(x.shape)}")
    if e_block < 1:
        raise ValueError(f"e_block must be >= 1, got {e_block}")
    _check_plan("dispatch_eblock", eidx, pos, x.shape[0])
    if x.device.type == "cpu":
        return dispatch_eblock_plain(x, eidx, pos, scale, n_experts,
                                     capacity, e_block)
    if x.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"dispatch_eblock: no kernel for device {x.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"dispatch_eblock: unsupported dtype {x.dtype}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.shape != eidx.shape):
        raise ValueError("dispatch_eblock: scale must be f32 shaped like "
                         "eidx")
    cuda_lib.check_cuda("dispatch_eblock", x, eidx, pos)
    btok, bscale = bucket_assignments(eidx, pos, scale, n_experts,
                                      capacity)
    d = x.shape[1]
    buf = torch.empty((n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    cuda_lib.call("repro_dispatch_eblock", x.data_ptr(), btok.data_ptr(),
                  bscale.data_ptr(), buf.data_ptr(), d, n_experts, capacity,
                  e_block, cuda_lib.DTYPE_CODES[x.dtype])
    cuda_lib.count("dispatch_eblock")
    return buf


def combine_eblock_plain(buf: torch.Tensor, w: torch.Tensor,
                         eidx: torch.Tensor, pos: torch.Tensor,
                         out_dtype: torch.dtype,
                         e_block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`combine_eblock`: per slab a
    partial sum from 0 over j ascending, added to the f32 total."""
    n_experts, capacity, d = buf.shape
    t, k = eidx.shape
    kept = _kept(eidx, pos, n_experts, capacity)
    e = torch.where(kept, eidx, 0).long()
    p = torch.where(kept, pos, 0).long()
    total = torch.zeros((t, d), dtype=torch.float32, device=buf.device)
    for lo in range(0, n_experts, e_block):
        part = torch.zeros_like(total)
        for j in range(k):
            hit = kept[:, j] & (e[:, j] >= lo) & (e[:, j] < lo + e_block)
            wj = torch.where(hit, w[:, j].float(), 0.0)
            part = part + wj[:, None] * buf[e[:, j], p[:, j]].float()
        total = total + part
    return total.to(out_dtype)


def combine_eblock(buf: torch.Tensor, w: torch.Tensor, eidx: torch.Tensor,
                   pos: torch.Tensor, *, out_dtype: torch.dtype | None = None,
                   e_block: int) -> torch.Tensor:
    """[E, C, d] -> [T, d] walking the experts in slabs of ``e_block``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise (the kernel sorts a token's slots in 48 KB of shared
    memory, 28 bytes a slot: k <= 1755)."""
    out_dtype = out_dtype or buf.dtype
    if buf.dim() != 3:
        raise ValueError(f"combine_eblock: buf must be [E, C, d], got "
                         f"{tuple(buf.shape)}")
    if e_block < 1:
        raise ValueError(f"e_block must be >= 1, got {e_block}")
    _check_plan("combine_eblock", eidx, pos, w.shape[0])
    if w.shape != eidx.shape:
        raise ValueError("combine_eblock: w must be shaped like eidx")
    if buf.device.type == "cpu":
        return combine_eblock_plain(buf, w, eidx, pos, out_dtype, e_block)
    if buf.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"combine_eblock: no kernel for device {buf.device}")
    if buf.dtype not in cuda_lib.DTYPE_CODES or \
            out_dtype not in cuda_lib.DTYPE_CODES or w.dtype != torch.float32:
        raise ValueError(f"combine_eblock: unsupported dtypes {buf.dtype} "
                         f"-> {out_dtype} (w {w.dtype})")
    cuda_lib.check_cuda("combine_eblock", buf, w, eidx, pos)
    n_experts, capacity, d = buf.shape
    t, k = eidx.shape
    y = torch.empty((t, d), dtype=out_dtype, device=buf.device)
    cuda_lib.call("repro_combine_eblock", buf.data_ptr(), w.data_ptr(),
                  eidx.data_ptr(), pos.data_ptr(), y.data_ptr(), t, k, d,
                  n_experts, capacity, e_block,
                  cuda_lib.DTYPE_CODES[buf.dtype],
                  cuda_lib.DTYPE_CODES[out_dtype])
    cuda_lib.count("combine_eblock")
    return y


# ---------------------------------------------------------------------------
# differentiable ops: the reference's custom VJPs
# ---------------------------------------------------------------------------

def _dispatch_any(x, eidx, pos, scale, n_experts, capacity, e_block):
    if e_block is None:
        return dispatch(x, eidx, pos, scale, n_experts=n_experts,
                        capacity=capacity)
    return dispatch_eblock(x, eidx, pos, scale, n_experts=n_experts,
                           capacity=capacity, e_block=e_block)


def _combine_any(buf, w, eidx, pos, out_dtype, e_block):
    if e_block is None:
        return combine(buf, w, eidx, pos, out_dtype=out_dtype)
    return combine_eblock(buf, w, eidx, pos, out_dtype=out_dtype,
                          e_block=e_block)


class DispatchFn(torch.autograd.Function):
    """Differentiable dispatch: ``apply(x, eidx, pos, n_experts, capacity,
    e_block) -> buf`` (``e_block=None``: resident kernels).  The scatter
    duplicates x[t] into its kept slots, so dx is the unit-weight combine
    of the buffer's cotangent, in the same regime (``_dispatch_bwd``)."""

    @staticmethod
    def forward(ctx, x, eidx, pos, n_experts, capacity, e_block):
        ctx.save_for_backward(eidx, pos)
        ctx.e_block = e_block
        return _dispatch_any(x, eidx, pos, None, n_experts, capacity,
                             e_block)

    @staticmethod
    def backward(ctx, g):
        eidx, pos = ctx.saved_tensors
        unit = torch.ones(eidx.shape, dtype=torch.float32, device=g.device)
        dx = _combine_any(g.contiguous(), unit, eidx, pos, g.dtype,
                          ctx.e_block)
        return dx, None, None, None, None, None


class CombineFn(torch.autograd.Function):
    """Differentiable combine: ``apply(buf, w, eidx, pos, out_dtype,
    e_block) -> y``.  Backward (``_combine_bwd``): d buf is the dispatch
    of dy in f32 scaled by w, in the same regime, cast once to buf's
    dtype; ``dw[t, j] = <dy[t], buf[e, p]>`` over kept slots (a plain
    gather, as in the reference)."""

    @staticmethod
    def forward(ctx, buf, w, eidx, pos, out_dtype, e_block):
        ctx.save_for_backward(buf, w, eidx, pos)
        ctx.e_block = e_block
        return _combine_any(buf, w, eidx, pos, out_dtype, e_block)

    @staticmethod
    def backward(ctx, g):
        buf, w, eidx, pos = ctx.saved_tensors
        n_experts, capacity, _ = buf.shape
        gf = g.float().contiguous()
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            dbuf = _dispatch_any(gf, eidx, pos, w.float().contiguous(),
                                 n_experts, capacity, ctx.e_block
                                 ).to(buf.dtype)
        if ctx.needs_input_grad[1]:
            kept = _kept(eidx, pos, n_experts, capacity)
            gathered = buf[eidx.long(),
                           pos.long().clamp(0, capacity - 1)]      # [T,k,d]
            dw = torch.sum(gf[:, None, :] * gathered.float(), dim=-1)
            dw = torch.where(kept, dw, 0.0).to(w.dtype)
        return dbuf, dw, None, None, None, None
