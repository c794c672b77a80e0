"""Parameter-definition trees (counterpart of ``repro.common.param``).

Architectures declare parameters as nested dicts of :class:`ParamDef`
(shape / logical axes / init / dtype, no allocation).
:func:`materialize` allocates them; :func:`abstract` gives ``meta``
tensors of the same shapes and dtypes (no storage: a full kimi-k2 tree
costs nothing); :func:`logical_specs` the tree of logical axes, which
``repro_torch.sharding.partition`` resolves to mesh axes.

Unlike the JAX version, which draws every leaf in float32 and then
casts, :func:`materialize` draws each leaf directly in its own dtype, on
the target device, one leaf at a time and in chunks along the leading
(layer / expert) axes.  A full-width kimi-k2 expert leaf is
``[384, 7168, 2048]``; one float32 temporary of it is 22.5 GB and would
not fit on the card beside the first layer's bf16 weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

# Logical axis name ("embed", "experts", ...) or None.  Kept so the
# layouts read like the reference's; the port does not shard.
Axis = Any

# Largest number of elements drawn in one call: 256 Mi elements is
# 512 MB of bf16, and the draw kernel needs no temporary beyond it.
_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Axis, ...]
    init: str = "normal"          # normal | zeros | ones | embed | uniform_scale
    dtype: torch.dtype = torch.bfloat16
    fan_in: int | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict (sorted key order,
    like a JAX pytree flatten)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _fill(d: ParamDef, out: torch.Tensor, gen: torch.Generator) -> None:
    """Draw ``d``'s init into ``out`` in place, chunk by chunk along the
    flattened leading axes (everything but the last two dims)."""
    if d.init == "zeros":
        out.zero_()
        return
    if d.init == "ones":
        out.fill_(1.0)
        return
    if d.init == "embed":
        draw = lambda t: t.normal_(0.0, 1.0, generator=gen)  # noqa: E731
    elif d.init == "normal":
        fan_in = d.fan_in if d.fan_in is not None else (
            d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        std = 1.0 / math.sqrt(max(fan_in, 1))
        draw = lambda t: t.normal_(0.0, std, generator=gen)  # noqa: E731
    elif d.init == "uniform_scale":
        fan_in = d.fan_in if d.fan_in is not None else d.shape[0]
        lim = math.sqrt(3.0 / max(fan_in, 1))
        draw = lambda t: t.uniform_(-lim, lim, generator=gen)  # noqa: E731
    else:
        raise ValueError(f"unknown init {d.init!r}")
    if out.dim() <= 2:
        draw(out)
        return
    rows = out.view(-1, *out.shape[-2:])
    step = max(1, _CHUNK_ELEMS // max(rows[0].numel(), 1))
    for i in range(0, rows.shape[0], step):
        draw(rows[i:i + step])


def materialize(tree, generator: torch.Generator,
                device: str | torch.device,
                cut: Callable[[ParamDef, torch.Tensor], torch.Tensor]
                | None = None):
    """Allocate every ParamDef leaf on ``device`` and draw its init from
    ``generator`` (which must live on the same device type).  With
    ``cut`` each leaf is drawn whole and ``cut(def, leaf)`` kept in its
    place (a rank's slice: one whole leaf exists at a time, and the
    draws are those of the whole tree)."""
    device = torch.device(device)

    def one(d: ParamDef) -> torch.Tensor:
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        _fill(d, out, generator)
        return out if cut is None else cut(d, out)

    return tree_map(one, tree)


def zeros(tree, device: str | torch.device):
    """Zero tensors for every ParamDef leaf (caches, buffers)."""
    return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                          device=device), tree)


def abstract(tree, dtype_override: torch.dtype | None = None):
    """``meta``-device stand-ins for every ParamDef leaf: shape and
    dtype (``dtype_override`` if given), no storage."""
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=dtype_override or d.dtype, device="meta"), tree)


def logical_specs(tree):
    """The tree of each leaf's logical axes (``ParamDef.axes``)."""
    return tree_map(lambda d: d.axes, tree)


def param_count(tree) -> int:
    """Elements of a tree of ParamDefs or of tensors."""
    return sum(l.size if isinstance(l, ParamDef) else l.numel()
               for l in tree_leaves(tree))


def param_bytes(tree) -> int:
    """Bytes of a tree of ParamDefs or of tensors."""
    def nbytes(l):
        if isinstance(l, ParamDef):
            return l.size * torch.empty((), dtype=l.dtype).element_size()
        return l.numel() * l.element_size()
    return sum(nbytes(l) for l in tree_leaves(tree))
