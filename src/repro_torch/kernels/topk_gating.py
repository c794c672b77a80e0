"""Fused top-k gating: the CUDA kernel ``csrc/topk_gating.cu`` and its
plain PyTorch version.

Replaces ``repro/kernels/topk_gating.py::_topk_kernel`` (Eqs. 3/5,
deterministic part): kk rounds of masked row argmax (ties to the lowest
index), a softmax over the top k, and the raw top-kk values (the
(k+1)-th feeds the Appendix-A load estimator).  The CUDA source carries
the design note.  Training's ``_topk_bwd`` comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

NEG = -1e30
MAX_KK = 32          # one warp lane per kept value
MAX_EXPERTS = 1024   # 32 logits per lane in registers


def topk_gating_plain(logits: torch.Tensor, k: int, kk: int):
    """Plain PyTorch version: the same kk argmax rounds, NEG masking and
    softmax.  Returns (w [T,k] f32, idx [T,kk] int32, vals [T,kk] f32)."""
    work = logits.float().clone()
    cols = torch.arange(work.shape[-1], device=work.device)[None, :]
    vals, idxs = [], []
    for _ in range(kk):
        i = torch.argmax(work, dim=-1)               # first maximal index
        vals.append(torch.gather(work, 1, i[:, None])[:, 0])
        idxs.append(i)
        work = torch.where(cols == i[:, None], NEG, work)
    v = torch.stack(vals, dim=-1)
    p = torch.exp(v[:, :k] - v[:, :1])
    w = p / torch.sum(p, dim=-1, keepdim=True)
    return w, torch.stack(idxs, dim=-1).to(torch.int32), v


def topk_gating(logits: torch.Tensor, k: int, kk: int | None = None):
    """logits [T, E] f32 -> (w [T,k] f32 softmaxed over the top k,
    idx [T,kk] int32, vals [T,kk] f32 raw top values).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    kk = k if kk is None else kk
    if logits.dim() != 2:
        raise ValueError(f"logits must be [T, E], got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= kk <= e:
        raise ValueError(f"top-k gating needs 1 <= k <= kk <= E: "
                         f"k={k}, kk={kk}, E={e}")
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, k, kk)
    if logits.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"topk_gating: no kernel for device {logits.device}")
    if logits.dtype != torch.float32:
        raise ValueError(f"topk_gating: logits must be float32, got "
                         f"{logits.dtype}")
    if kk > MAX_KK or e > MAX_EXPERTS:
        raise ValueError(f"topk_gating kernel takes kk <= {MAX_KK} and "
                         f"E <= {MAX_EXPERTS}; got kk={kk}, E={e}")
    cuda_lib.check_cuda("topk_gating", logits)
    dev = logits.device
    w = torch.empty((t, k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, kk), dtype=torch.int32, device=dev)
    vals = torch.empty((t, kk), dtype=torch.float32, device=dev)
    if t:
        cuda_lib.call("repro_topk_gating", logits.data_ptr(), w.data_ptr(),
                      idx.data_ptr(), vals.data_ptr(), t, e, k, kk)
        cuda_lib.count("topk_gating")
    return w, idx, vals
