"""Fused MoE decode: the CUDA kernels ``csrc/fused_decode.cu`` and their
plain PyTorch versions.

Replaces ``repro/kernels/fused_decode.py``:

* :func:`decode_step` — ``_decode_kernel`` (l.192): a whole MoE decode
  layer in one launch: clean-logit routing (k argmax rounds, lowest index
  on ties, softmax, x the valid mask), capacity slots as an exclusive
  running count in flat token-major order (zero-weight assignments take
  slot C), load / overflow telemetry, scatter, per-expert FFN (relu or
  swiglu) and the weighted combine;
* :func:`routed_apply` — ``_routed_kernel`` (l.323): the same without
  routing, over explicit plans (``mode="ffn"`` or the single grouped
  projection ``mode="proj"``); token-major ``[T, k]`` and MoA's
  assignment-major ``[T·k, 1]`` plans are just shapes.

Both are inference-only, as in the reference.  The plain versions follow
the kernels' algorithm and roundings: the FFN rounds as the reference's
``_expert_ffn_into`` (``silu(h)`` and ``x w3`` cast to the buffer type,
their product in f32 cast again; the down-projection in f32, cast), and
the combine sums in f32 in ascending j with separate multiplies and adds.
The kernel computes only the experts that receive a token (an empty
expert's output is never read); the plain versions do the same.  The
CUDA source carries the design notes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.gmm import activate
from repro_torch.kernels.topk_gating import topk_gating_plain

ACTIVATIONS = {"relu": 0, "swiglu": 1}
MODES = {"ffn": 1, "proj": 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def route_plain(x: torch.Tensor, valid: torch.Tensor, wg: torch.Tensor,
                k: int, capacity: int):
    """Kernel 7's routing: ``(flat_e, flat_p, flat_w, load, overflow)``
    with ``flat_w`` the combine weights of kept assignments (0 where the
    slot is past capacity or the token is masked)."""
    logits = x.float() @ wg.float()
    w, idx, _ = topk_gating_plain(logits, k, k)
    w = w * valid.float()[:, None]
    n_experts = wg.shape[1]
    flat_e = idx.reshape(-1).long()
    flat_w = w.reshape(-1)
    assigned = flat_w > 0.0
    hot = torch.nn.functional.one_hot(flat_e, n_experts) * assigned[:, None]
    rank = torch.cumsum(hot, dim=0) - hot                 # exclusive count
    pos = torch.sum(rank * hot, dim=-1)
    flat_p = torch.where(assigned, pos, torch.full_like(pos, capacity))
    kept = flat_p < capacity
    load = hot.sum(dim=0).float()
    overflow = (hot * (~kept)[:, None]).sum(dim=0).float()
    return (flat_e.to(torch.int32), flat_p.to(torch.int32),
            torch.where(kept, flat_w, 0.0), load, overflow)


def _expert_ffn_rows(rows: torch.Tensor, w1: torch.Tensor, w2, w3, mode: str,
                     activation: str) -> torch.Tensor:
    """One expert on its ``[C, d_in]`` cells, in the kernel's roundings."""
    dt = rows.dtype
    xr = rows.float()
    h = xr @ w1.to(dt).float()
    if mode == "proj":
        return h.to(dt)
    if activation == "swiglu":
        s = activate(h, "silu").to(dt)
        g = (xr @ w3.to(dt).float()).to(dt)
        h = (s.float() * g.float()).to(dt)
    else:
        h = activate(h, "relu").to(dt)
    return (h.float() @ w2.to(dt).float()).to(dt)


def _cells(eidx, pos, n_experts, capacity):
    e = eidx.reshape(-1).long()
    p = pos.reshape(-1).long()
    kept = (e >= 0) & (e < n_experts) & (p >= 0) & (p < capacity)
    return e, p, kept


def _fused_plain(x, in_e, in_p, k_in, out_e, out_p, out_w, k_out, w1, w2,
                 w3, n_experts, capacity, mode, activation, out_dtype):
    """scatter(in plan) -> FFN / projection of the filled experts ->
    combine(out plan), f32 in ascending j."""
    dt = x.dtype
    d_out = w1.shape[-1] if mode == "proj" else w2.shape[-1]
    e, p, kept = _cells(in_e, in_p, n_experts, capacity)
    tok = torch.arange(e.shape[0], device=x.device) // k_in
    buf = torch.zeros((n_experts, capacity, x.shape[1]), dtype=dt,
                      device=x.device)
    buf[e[kept], p[kept]] = x[tok[kept]]
    out = torch.zeros((n_experts, capacity, d_out), dtype=dt,
                      device=x.device)
    for ex in torch.unique(e[kept]).tolist():
        out[ex] = _expert_ffn_rows(buf[ex], w1[ex],
                                   None if w2 is None else w2[ex],
                                   None if w3 is None else w3[ex], mode,
                                   activation)
    oe, op, okept = _cells(out_e, out_p, n_experts, capacity)
    t_out = out_e.shape[0]
    gathered = out[oe.clamp(0, n_experts - 1), op.clamp(0, capacity - 1)]
    gathered = gathered.float().reshape(t_out, k_out, d_out)
    w = torch.where(okept, out_w.reshape(-1).float(), 0.0).reshape(
        t_out, k_out)
    y = torch.zeros((t_out, d_out), dtype=torch.float32, device=x.device)
    for j in range(k_out):
        y = y + w[:, j:j + 1] * gathered[:, j]
    return y.to(out_dtype)


def decode_step_plain(x, valid, wg, w1, w2, w3=None, *, k: int,
                      capacity: int, activation: str = "relu"):
    """Plain PyTorch version of :func:`decode_step`."""
    flat_e, flat_p, flat_w, load, overflow = route_plain(x, valid, wg, k,
                                                         capacity)
    ie, ip = flat_e.reshape(-1, k), flat_p.reshape(-1, k)
    y = _fused_plain(x, ie, ip, k, ie, ip, flat_w.reshape(-1, k), k, w1, w2,
                     w3, wg.shape[1], capacity, "ffn", activation, x.dtype)
    return y, load, overflow


def routed_apply_plain(x, in_eidx, in_pos, out_eidx, out_pos, out_w, w1,
                       w2=None, w3=None, *, n_experts: int, capacity: int,
                       mode: str = "ffn", activation: str = "relu",
                       out_dtype=None):
    """Plain PyTorch version of :func:`routed_apply`."""
    return _fused_plain(x, in_eidx, in_pos, in_eidx.shape[1], out_eidx,
                        out_pos, out_w, out_eidx.shape[1], w1, w2, w3,
                        n_experts, capacity, mode, activation,
                        out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_activation(activation, w3):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r} (expected one "
                         f"of {sorted(ACTIVATIONS)})")
    if activation == "swiglu" and w3 is None:
        raise ValueError("activation='swiglu' needs w3")


def _on_card(name: str, x: torch.Tensor, weights) -> None:
    """The CUDA launch's dtype checks (the kernels read weights in the
    activations' type, as the reference casts them)."""
    if x.device.type != "cuda":
        raise cuda_lib.KernelLaunchError(
            f"{name}: no kernel for device {x.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    for w in weights:
        if w is not None and w.dtype != x.dtype:
            raise ValueError(f"{name}: weights ({w.dtype}) must be in the "
                             f"activations' type ({x.dtype})")


@functools.lru_cache(maxsize=256)
def _workspace_bytes(*args) -> int:
    """Scratch bytes of one launch at these shapes (asked of the library
    once per shape: decode steps repeat a few shapes)."""
    n = ctypes.c_longlong(0)
    code = cuda_lib.library().repro_fused_workspace_bytes(
        *args, ctypes.byref(n))
    if code != 0:
        raise cuda_lib.KernelLaunchError(
            f"repro_fused_workspace_bytes rejected {args} (code {code})")
    return max(n.value, 1)


def _workspace(x, *args) -> torch.Tensor:
    return torch.empty((_workspace_bytes(*args),), dtype=torch.uint8,
                       device=x.device)


def decode_step(x: torch.Tensor, valid: torch.Tensor, wg: torch.Tensor,
                w1: torch.Tensor, w2: torch.Tensor,
                w3: torch.Tensor | None = None, *, k: int, capacity: int,
                activation: str = "relu"):
    """One fused MoE decode step.  x [T, d]; valid [T] slot occupancy;
    wg [d, E] gate; w1 / w3 [E, d, f], w2 [E, f, d].  Returns (y [T, d],
    expert_load [E] f32, overflow [E] f32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.dim() != 2 or wg.dim() != 2 or wg.shape[0] != x.shape[1]:
        raise ValueError(f"decode_step: x {tuple(x.shape)} and wg "
                         f"{tuple(wg.shape)} are not [T, d] and [d, E]")
    t, d = x.shape
    e = wg.shape[1]
    if not 1 <= k <= e:
        raise ValueError(f"fused decode needs 1 <= k <= E: k={k}, E={e}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    _check_activation(activation, w3)
    f = w1.shape[-1]
    if w1.shape != (e, d, f) or w2.shape != (e, f, d) or (
            activation == "swiglu" and w3.shape != w1.shape):
        raise ValueError(f"decode_step: expert weights {tuple(w1.shape)} / "
                         f"{tuple(w2.shape)} are not [E, d, f] / [E, f, d]")
    valid = valid.reshape(-1)
    if valid.shape[0] != t:
        raise ValueError(f"decode_step: valid has {valid.shape[0]} rows, "
                         f"x has {t}")
    w3 = w3 if activation == "swiglu" else None
    if x.device.type == "cpu":
        return decode_step_plain(x, valid, wg, w1, w2, w3, k=k,
                                 capacity=capacity, activation=activation)
    _on_card("decode_step", x, (w1, w2, w3))
    if t == 0:
        zero = torch.zeros((e,), dtype=torch.float32, device=x.device)
        return x.clone(), zero, zero.clone()
    valid = valid.float().contiguous()
    wg = wg.float().contiguous()
    cuda_lib.check_cuda("decode_step", x, valid, wg, w1, w2,
                        *([w3] if w3 is not None else []))
    code = cuda_lib.DTYPE_CODES[x.dtype]
    act = ACTIVATIONS[activation]
    ws = _workspace(x, 1, t, k, d, d, f, e, capacity, 0, act, code)
    y = torch.empty_like(x)
    load = torch.empty((e,), dtype=torch.float32, device=x.device)
    overflow = torch.empty((e,), dtype=torch.float32, device=x.device)
    cuda_lib.call("repro_fused_decode", x.data_ptr(), valid.data_ptr(),
                  wg.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                  0 if w3 is None else w3.data_ptr(), y.data_ptr(),
                  load.data_ptr(), overflow.data_ptr(), ws.data_ptr(), t, d,
                  e, f, k, capacity, act, code)
    cuda_lib.count("fused_decode")
    return y, load, overflow


def _check_plan(name, eidx, pos, w=None):
    if eidx.dim() != 2 or pos.shape != eidx.shape or (
            w is not None and w.shape != eidx.shape):
        raise ValueError(f"{name}: plan views must share one [T, k] shape")


def routed_apply(x: torch.Tensor, in_eidx: torch.Tensor,
                 in_pos: torch.Tensor, out_eidx: torch.Tensor,
                 out_pos: torch.Tensor, out_w: torch.Tensor,
                 w1: torch.Tensor, w2: torch.Tensor | None = None,
                 w3: torch.Tensor | None = None, *, n_experts: int,
                 capacity: int, mode: str = "ffn",
                 activation: str = "relu",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Fused dispatch -> grouped matmul(s) -> combine over explicit
    plans.  ``in_eidx`` / ``in_pos`` ([T_in, k_in]) scatter rows of x
    into the expert cells; ``mode="ffn"`` applies the expert FFN (w1, w2,
    and w3 for swiglu), ``mode="proj"`` the projection w1 [E, d_in,
    d_out]; ``out_eidx`` / ``out_pos`` / ``out_w`` ([T_out, k_out])
    gather the rows back, weighted.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of "
                         f"{sorted(MODES)})")
    if x.dim() != 2:
        raise ValueError(f"routed_apply: x must be [T, d], got "
                         f"{tuple(x.shape)}")
    _check_plan("routed_apply", in_eidx, in_pos)
    _check_plan("routed_apply", out_eidx, out_pos, out_w)
    if in_eidx.shape[0] != x.shape[0]:
        raise ValueError("routed_apply: the in-plan must have one row per "
                         "row of x")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    d_in = x.shape[1]
    if mode == "ffn":
        _check_activation(activation, w3)
        if w2 is None:
            raise ValueError("mode='ffn' needs w2")
        f, d_out = w1.shape[-1], w2.shape[-1]
        if w1.shape != (n_experts, d_in, f) or w2.shape[:2] != (n_experts,
                                                                 f):
            raise ValueError(f"routed_apply: FFN weights {tuple(w1.shape)} "
                             f"/ {tuple(w2.shape)} do not match x and E")
        w3 = w3 if activation == "swiglu" else None
    else:
        f, d_out = 0, w1.shape[-1]
        if w1.shape[:2] != (n_experts, d_in):
            raise ValueError(f"routed_apply: projection {tuple(w1.shape)} "
                             "is not [E, d_in, d_out]")
        w2 = w3 = None
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return routed_apply_plain(x, in_eidx, in_pos, out_eidx, out_pos,
                                  out_w, w1, w2, w3, n_experts=n_experts,
                                  capacity=capacity, mode=mode,
                                  activation=activation,
                                  out_dtype=out_dtype)
    _on_card("routed_apply", x, (w1, w2, w3))
    if out_dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"routed_apply: unsupported out dtype {out_dtype}")
    plans = [t.to(torch.int32).contiguous()
             for t in (in_eidx, in_pos, out_eidx, out_pos)]
    out_w = out_w.float().contiguous()
    cuda_lib.check_cuda("routed_apply", x, *plans, out_w, w1,
                        *[w for w in (w2, w3) if w is not None])
    t_in, k_in = in_eidx.shape
    t_out, k_out = out_eidx.shape
    code = cuda_lib.DTYPE_CODES[x.dtype]
    act = ACTIVATIONS[activation] if mode == "ffn" else 0
    ws = _workspace(x, 0, t_in, k_in, d_in, d_out, f, n_experts, capacity,
                    MODES[mode], act, code)
    y = torch.empty((t_out, d_out), dtype=out_dtype, device=x.device)
    cuda_lib.call("repro_fused_routed", x.data_ptr(),
                  *(t.data_ptr() for t in plans), out_w.data_ptr(), w1.data_ptr(), 0 if w2 is None else w2.data_ptr(),
                  0 if w3 is None else w3.data_ptr(), y.data_ptr(),
                  ws.data_ptr(), t_in, k_in, t_out, k_out, d_in, d_out, f,
                  n_experts, capacity, MODES[mode], act, code,
                  cuda_lib.DTYPE_CODES[out_dtype])
    cuda_lib.count("fused_routed")
    return y
