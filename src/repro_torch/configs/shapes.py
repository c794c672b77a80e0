"""Assigned input shapes x per-arch input specs (counterpart of
``repro.configs.shapes``).

The four LM shapes (seq_len x global_batch):

* ``train_4k``     4,096 x 256   -> a training step
* ``prefill_32k``  32,768 x 32   -> a prefill call
* ``decode_32k``   32,768 x 128  -> a decode step (1 token, 32k cache)
* ``long_500k``    524,288 x 1   -> a decode step; sub-quadratic archs only

Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins, the
port returns ``meta``-device tensors: shapes and dtypes, never storage
(the kimi-k2 cells would not fit on any host otherwise).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import param as pm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Is (arch x shape) runnable?  long_500k needs sub-quadratic
    attention (decode against a full-attention 500k KV cache on every
    layer does not fit a device's memory)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token KV cache on "
                       "every layer exceeds the per-chip HBM budget; "
                       "skip recorded in DESIGN.md")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors of the step's *data* inputs, in the dtypes
    ``models.lm`` takes (int32 tokens, prefix embeddings in the compute
    dtype)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b,), torch.int32)}
    if shape.kind == "train":
        specs = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), torch.int32)}
    else:
        raise ValueError(shape.kind)
    if cfg.n_prefix:
        specs["prefix_embeds"] = _meta((b, cfg.n_prefix, cfg.d_model),
                                       cfg.compute_dtype)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(``meta`` decode / prefill cache, its ParamDefs) for this
    (arch x shape)."""
    defs = transformer.cache_defs(cfg, shape.global_batch, shape.seq_len)
    return pm.abstract(defs), defs


def logical_batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Logical axes of each batch input (for resolving its sharding)."""
    if shape.kind == "train":
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    elif shape.kind == "prefill":
        axes = {"tokens": ("batch", "seq")}
    else:
        axes = {"tokens": ("batch",)}
    if cfg.n_prefix and shape.kind != "decode":
        axes["prefix_embeds"] = ("batch", None, "embed")
    return axes
