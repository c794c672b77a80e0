"""Parameter trees between the JAX package and the port.

The JAX package's parameters, converted to numpy (``np.asarray`` of each
leaf), become the port's parameters with :func:`from_jax_tree`, and go
back with :func:`to_jax_tree`.  Both packages keep the same layouts
(dense ``[d_in, d_out]``, experts ``[E, d, f]`` / ``[E, f, d]``, gate
``[d, E]``, stacked layers with a leading ``[n_layers, ...]`` axis), so
the conversion is a plain copy of every leaf, byte for byte.

numpy has no native bfloat16: JAX hands bf16 leaves out as the
``ml_dtypes`` ``bfloat16`` dtype.  The bridge moves them through a
``uint16`` view of the same bits, so it never needs that package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def _leaf_to_torch(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16,
                                                                 copy=False)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    elif arr.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    else:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return t.to(device)


def from_jax_tree(tree, *, device: str | torch.device = "cuda"):
    """Nested dict of numpy arrays (a JAX parameter tree) -> the same
    nested dict with torch tensors on ``device`` as leaves."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        raise TypeError("parameter trees are nested dicts; got a "
                        f"{type(tree).__name__}")
    return _leaf_to_torch(tree, dev)


def to_jax_tree(params, *, bf16=None):
    """Inverse of :func:`from_jax_tree`: nested dict of tensors -> nested
    dict of numpy arrays.  bfloat16 leaves come back as their raw
    ``uint16`` bits, viewed as ``bf16`` when the caller passes that numpy
    dtype (``np.dtype(jnp.bfloat16)`` on the JAX side)."""
    if isinstance(params, dict):
        return {k: to_jax_tree(v, bf16=bf16) for k, v in params.items()}
    t = params.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bf16) if bf16 is not None else bits
    return t.numpy()
