"""Optimizers: Adam and the paper's memory-factored variant (Appendix
D), counterpart of ``repro.optim.optimizers``.

``kind="factored"`` is the paper's modified Adam: beta1 = 0 and, for
matrix parameters, the second moment replaced by the outer product of
row-wise and column-wise running averages divided by the mean of either.
Learning-rate schedule (§C.1): linear warmup, then inverse-sqrt decay.

Parameters, gradients and state are nested dicts of tensors, with the
reference's state tree (``{"mu": ..., "step": ...}``, leaves ``v`` /
``m`` / ``vr`` / ``vc``), so a checkpoint restores in either package.
Unlike the reference, whose functions are pure, :func:`apply_updates`
updates the parameters and the state **in place** under
``torch.no_grad()`` (no second copy of a billion-parameter model).
Leaves above :data:`SLICE_BYTES` (of f32) are updated and normed a
slice at a time along their leading (layer / expert) axes: one f32
temporary of a full-width arctic expert leaf is 17.9 GB, and an update
makes about four.  The factored statistics reduce over the last two
axes only, so slicing the leading ones leaves every update as it is.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.param import tree_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "factored"        # adam | factored
    learning_rate: float = 1e-3
    warmup_steps: int = 1000      # paper: 1000 (LM) / 2000 (MT)
    b1: float = 0.9               # adam only; factored uses b1=0 (App. D)
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 1.0
    weight_decay: float = 0.0
    factored_min_rank: int = 2    # factor matrices and higher-rank tensors


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then proportional to 1/sqrt(step) (§C.1); f32."""
    step = torch.clamp(step, min=1).float()
    w = torch.tensor(float(oc.warmup_steps), dtype=torch.float32,
                     device=step.device)
    warm = step / w
    decay = torch.sqrt(w) / torch.sqrt(step)
    return oc.learning_rate * torch.minimum(warm, decay)


# Leaves with more f32 bytes than this are updated in slices.
SLICE_BYTES = 256 << 20


def _slices(p: torch.Tensor, keep: int) -> list[slice] | None:
    """Slices of ``p``'s leading axes (all but the last ``keep``,
    flattened) of at most SLICE_BYTES of f32 each; None for a leaf that
    is not above the limit or has no leading axis."""
    if p.numel() * 4 <= SLICE_BYTES or p.dim() <= keep:
        return None
    inner = max(1, math.prod(p.shape[p.dim() - keep:]))
    step = max(1, SLICE_BYTES // (4 * inner))
    n = p.numel() // inner
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _lead(t: torch.Tensor, keep: int) -> torch.Tensor:
    """``t`` viewed as [leading axes flattened, last ``keep`` axes]."""
    return t.view(-1, *t.shape[t.dim() - keep:]) if keep else t.view(-1)


def _is_factored(p: torch.Tensor, oc: OptConfig) -> bool:
    return p.dim() >= oc.factored_min_rank and oc.kind == "factored"


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def init(params, oc: OptConfig) -> dict:
    def one(p):
        if isinstance(p, dict):
            return {k: one(p[k]) for k in sorted(p)}
        if not p.is_floating_point():
            return {}
        if _is_factored(p, oc):
            # Row / column averages over the last two dims; leading dims
            # (stacked layers / experts) are carried elementwise.
            return {"vr": _zeros(p.shape[:-1], p),
                    "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
        state = {"v": _zeros(p.shape, p)}
        if oc.kind == "adam" and oc.b1 > 0:
            state["m"] = _zeros(p.shape, p)
        return state
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"mu": one(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    sl = _slices(g, 0)
    if sl is None:
        return torch.sum(torch.square(g.float()))
    flat = g.reshape(-1)
    return sum(torch.sum(torch.square(flat[s].float())) for s in sl)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sq_sum(g) for g in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, oc: OptConfig):
    """One update, in place.  Returns (params, state, info) — the same
    objects, updated — with ``info = {"grad_norm", "lr"}``."""
    state["step"].add_(1)
    step = state["step"]
    stepf = step.float()
    lr = schedule(oc, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if oc.clip_norm > 0 else 1.0)

    def update(p, g, s):
        g = g.float() * scale
        if _is_factored(p, oc):
            g2 = g * g + 1e-30
            vr = oc.b2 * s["vr"] + (1 - oc.b2) * torch.mean(g2, dim=-1)
            vc = oc.b2 * s["vc"] + (1 - oc.b2) * torch.mean(g2, dim=-2)
            # Appendix D: estimator = outer(vr, vc) / mean(vr).
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None],
                              min=1e-30))
            upd = g / torch.clamp(denom, min=oc.eps)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = oc.b2 * s["v"] + (1 - oc.b2) * g * g
            vh = v / (1 - oc.b2 ** stepf)
            upd = g / (torch.sqrt(vh) + oc.eps)
            s["v"].copy_(v)
            if "m" in s:
                m = oc.b1 * s["m"] + (1 - oc.b1) * g
                upd = (m / (1 - oc.b1 ** stepf)) / (torch.sqrt(vh) + oc.eps)
                s["m"].copy_(m)
        if oc.weight_decay:
            upd = upd + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))

    def one(p, g, s):
        if not p.is_floating_point():
            return
        # Factored leaves keep their last two axes whole (the statistics
        # reduce over them); everything else is elementwise.
        keep = 2 if _is_factored(p, oc) else 0
        sl = _slices(p, keep)
        if sl is None:
            update(p, g, s)
            return
        lp, lg = _lead(p, keep), _lead(g.contiguous(), keep)
        ls = {k: _lead(v, keep - 1 if keep else 0) for k, v in s.items()}
        for i in sl:
            update(lp[i], lg[i], {k: v[i] for k, v in ls.items()})

    def walk(p, g, s):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], g[k], s[k])
        else:
            one(p, g, s)

    walk(params, grads, state["mu"])
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(state))
