"""Fused top-k gating: the CUDA kernels ``csrc/topk_gating.cu`` (forward
and backward) and their plain PyTorch versions.

Replaces ``repro/kernels/topk_gating.py::_topk_kernel`` (Eqs. 3/5,
deterministic part): kk rounds of masked row argmax (ties to the lowest
index), a softmax over the top k, and the raw top-kk values (the
(k+1)-th feeds the Appendix-A load estimator); and its custom VJP
``_topk_bwd`` (l.116), as :class:`TopKGatingFn`.  The CUDA source carries
the design notes.
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
    or raise; meta tensors in ``cuda_lib.meta_trace()`` trace the launch."""
    kk = k if kk is None else kk
    if logits.dim() != 2:
        raise ValueError(f"logits must be [T, E], got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= kk <= e:
        raise ValueError(f"top-k gating needs 1 <= k <= kk <= E: "
                         f"k={k}, kk={kk}, E={e}")
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, k, kk)
    launch = cuda_lib.launches("topk_gating", logits.device)
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
    if t and launch:
        cuda_lib.call("repro_topk_gating", logits.data_ptr(), w.data_ptr(),
                      idx.data_ptr(), vals.data_ptr(), t, e, k, kk)
        cuda_lib.count("topk_gating")
    return w, idx, vals


def topk_gating_bwd_plain(w: torch.Tensor, idx: torch.Tensor,
                          dw: torch.Tensor, dvals: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`topk_gating_bwd`, in the kernel's
    order of roundings: ``<w, dw>`` summed over j ascending, and each
    column the sum from +0 over its j ascending.  A row's indices repeat
    when fewer than kk of its logits lie above NEG, so the scatter takes
    one column of ``idx`` a call: one call over all kk would add the
    repeats in an undefined order on CUDA."""
    t, k = w.shape
    s = torch.zeros((t,), dtype=torch.float32, device=w.device)
    for j in range(k):
        s = s + w[:, j] * dw[:, j]
    full = dvals.clone()
    full[:, :k] = full[:, :k] + w * (dw - s[:, None])
    out = torch.zeros((t, n_experts), dtype=torch.float32, device=w.device)
    cols = idx.long()
    for j in range(idx.shape[1]):
        out.scatter_add_(1, cols[:, j:j + 1], full[:, j:j + 1])
    return out


def topk_gating_bwd(w: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
                    dvals: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The VJP of :func:`topk_gating` (the reference's ``_topk_bwd``):
    w, dw [T,k] f32, idx, dvals [T,kk] -> dlogits [T, E] f32 with
    ``dvals + [w (dw - <w, dw>), 0]`` at the kk winning columns and zero
    elsewhere.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise; meta tensors in ``cuda_lib.meta_trace()`` trace
    the launch."""
    t, k = w.shape
    kk = idx.shape[1]
    if dw.shape != w.shape or idx.shape != dvals.shape or idx.shape[0] != t \
            or not 1 <= k <= kk <= n_experts:
        raise ValueError(f"topk_gating_bwd: w {tuple(w.shape)}, dw "
                         f"{tuple(dw.shape)}, idx {tuple(idx.shape)}, dvals "
                         f"{tuple(dvals.shape)} and E={n_experts} disagree")
    if w.device.type == "cpu":
        return topk_gating_bwd_plain(w, idx, dw, dvals, n_experts)
    launch = cuda_lib.launches("topk_gating_bwd", w.device)
    if any(a.dtype != torch.float32 for a in (w, dw, dvals)) \
            or idx.dtype != torch.int32:
        raise ValueError("topk_gating_bwd: w, dw, dvals must be float32 and "
                         "idx int32")
    if kk > MAX_KK:
        raise ValueError(f"topk_gating_bwd kernel takes kk <= {MAX_KK}")
    cuda_lib.check_cuda("topk_gating_bwd", w, idx, dw, dvals)
    out = torch.empty((t, n_experts), dtype=torch.float32, device=w.device)
    if t and launch:
        cuda_lib.call("repro_topk_gating_bwd", w.data_ptr(), idx.data_ptr(),
                      dw.data_ptr(), dvals.data_ptr(), out.data_ptr(), t,
                      n_experts, k, kk)
        cuda_lib.count("topk_gating_bwd")
    return out


class TopKGatingFn(torch.autograd.Function):
    """Differentiable :func:`topk_gating`: ``apply(logits, k, kk) -> (w,
    idx, vals)``.  The backward pass is :func:`topk_gating_bwd`; ``idx``
    carries no gradient."""

    @staticmethod
    def forward(ctx, logits, k, kk):
        w, idx, vals = topk_gating(logits, k, kk)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(w, idx)
        ctx.logits_meta = (logits.shape[1], logits.dtype)
        return w, idx, vals

    @staticmethod
    def backward(ctx, dw, _didx, dvals):
        w, idx = ctx.saved_tensors
        n_experts, dtype = ctx.logits_meta
        dw = (torch.zeros_like(w) if dw is None
              else dw.float().contiguous())
        dvals = (torch.zeros(idx.shape, dtype=torch.float32,
                             device=w.device)
                 if dvals is None else dvals.float().contiguous())
        dlogits = topk_gating_bwd(w, idx, dw, dvals, n_experts)
        return dlogits.to(dtype), None, None
