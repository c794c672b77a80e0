"""Error-feedback int8 gradient compression for slow (cross-pod) links,
counterpart of ``repro.train.compression``.

The classic recipe (1-bit Adam / EF-SGD lineage):

    e_t   = g_t + ef_{t-1}              (add residual from last step)
    q_t   = int8_quantize(e_t)          (per-tensor scale)
    ef_t  = e_t - dequant(q_t)          (store the quantization error)
    sync  = mean over ranks of dequant(q_t)

The collective is an ``all_gather`` of int8 payloads and f32 scales over
a process group, then a local dequantized mean: (n-1)·size bytes a rank
against ring all-reduce's 2·(n-1)/n·size·4 for f32, a 4x cut at n = 2.
Error feedback makes the *accumulated* update unbiased: the quantization
error of step t is replayed into step t+1.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the payloads are the reference's bit
for bit.  As in the reference, the trainer does not call it: it is a
library function.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common.param import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_sync(grads, ef_state, group=None):
    """Synchronize ``grads`` (a nested dict of tensors) over ``group``
    (default: every rank) with int8 error feedback.  Returns
    (synced_grads, new_ef_state); ``ef_state`` is an f32 tree matching
    ``grads`` (:func:`init_ef_state` at step 0)."""
    n = dist.get_world_size(group)

    def one(g, ef):
        e = g.float() + ef
        q, scale = quantize_int8(e)
        new_ef = e - dequantize_int8(q, scale)
        q_all = [torch.empty_like(q) for _ in range(n)]
        s_all = [torch.empty_like(scale) for _ in range(n)]
        dist.all_gather(q_all, q, group=group)          # int8 on the wire
        dist.all_gather(s_all, scale.reshape(()), group=group)
        mean = torch.sum(torch.stack(q_all).float()
                         * torch.stack(s_all).reshape((n,) + (1,) * g.dim()),
                         dim=0) / n
        return mean.to(g.dtype), new_ef

    def walk(g, ef):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], ef[k]) for k in sorted(g)}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        return one(g, ef)
    return walk(grads, ef_state)


def init_ef_state(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
