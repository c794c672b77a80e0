"""Grouped (per-expert) matmul with a fused activation: the CUDA kernel
``csrc/gmm.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/gmm.py::_gmm_kernel``: ``[E, C, K] x [E, K, N]
-> [E, C, N]`` with an f32 accumulator and a none / relu / silu
epilogue.  The reference's tiling table (``gmm_tunings.json``) was
measured in CPU interpret mode and is not carried over; the CUDA source
carries this kernel's design note.  ``_gmm_bwd`` comes with the training
slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

ACTIVATIONS = {"none": 0, "relu": 1, "silu": 2}

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


def gmm_plain(x: torch.Tensor, w: torch.Tensor,
              activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: f32 products over expert chunks, then the
    epilogue and one cast to x.dtype."""
    e, c, k = x.shape
    n = w.shape[-1]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    step = expert_chunk(k, n)
    for e0 in range(0, e, step):
        z = torch.bmm(x[e0:e0 + step].float(), w[e0:e0 + step].float())
        out[e0:e0 + step] = activate(z, activation).to(x.dtype)
    return out


def gmm(x: torch.Tensor, w: torch.Tensor, *,
        activation: str = "none") -> torch.Tensor:
    """[E, C, K] x [E, K, N] -> [E, C, N] in x.dtype.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown gmm activation {activation!r} "
                         f"(expected one of {sorted(ACTIVATIONS)})")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"gmm: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not [E, C, K] x [E, K, N]")
    if x.dtype != w.dtype:
        raise ValueError(f"gmm: x {x.dtype} and w {w.dtype} differ")
    if x.device.type == "cpu":
        return gmm_plain(x, w, activation)
    if x.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"gmm: no kernel for device {x.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"gmm: unsupported dtype {x.dtype}")
    cuda_lib.check_cuda("gmm", x, w)
    e, c, k = x.shape
    n = w.shape[-1]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    cuda_lib.call("repro_gmm", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  e, c, k, n, ACTIVATIONS[activation],
                  cuda_lib.DTYPE_CODES[x.dtype])
    cuda_lib.count("gmm")
    return out
