"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``.  A
request for CUDA on a host without it raises instead of quietly running
on the CPU, and resolving a CUDA device pins float32 matmuls to full
IEEE precision (no TF32), which the f32 parity checks rely on.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` -> ``torch.device``; raises when CUDA is asked for but
    unavailable (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda is not "
                "available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
