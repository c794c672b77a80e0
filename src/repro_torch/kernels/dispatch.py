"""Capacity-buffer dispatch and weighted combine: the CUDA kernels in
``csrc/dispatch.cu`` and their plain PyTorch versions.

Replaces ``repro/kernels/dispatch.py::_dispatch_kernel`` and
``_combine_kernel`` (the resident-buffer regime).  The reference's
expert-blocked kernels (``_dispatch_eblock_kernel``,
``_combine_eblock_kernel``) exist only to fit the TPU's VMEM and are not
ported yet; the custom VJPs come with the training slice.  The CUDA
source carries the design note.

Semantics: an assignment with ``pos >= capacity`` (dropped, or masked
padding) writes nothing in dispatch and contributes nothing in combine;
combine sums over k in ascending order in f32.
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
