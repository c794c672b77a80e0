"""LSTM layers (the paper's recurrent backbone, §C.1), counterpart of
``repro.models.lstm``.

Gate order i, f, g, o along the ``4H`` axis, a ``+1.0`` bias on the
forget gate and the cell state in f32, as in the reference.  Supports
the projected variant of Sak et al. (2014) used by LSTM-2048-512: hidden
size H with an output projection to P, the recurrent input being the
projected output.

The reference scans the cell with ``lax.scan``; here the time loop is a
Python loop of ``torch.matmul``s (there is no Pallas kernel on this
path).  The input projection ``x @ wx`` does not depend on the state,
so it is one matmul over all time steps before the loop.
"""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDef


def lstm_defs(d_in: int, d_hidden: int, d_proj: int | None = None,
              dtype: torch.dtype = torch.float32) -> dict:
    rec = d_proj or d_hidden
    defs = {
        "wx": ParamDef((d_in, 4 * d_hidden), ("embed_fsdp", "mlp"),
                       dtype=dtype, fan_in=d_in),
        "wh": ParamDef((rec, 4 * d_hidden), ("embed_fsdp", "mlp"),
                       dtype=dtype, fan_in=rec),
        "b": ParamDef((4 * d_hidden,), ("mlp",), init="zeros", dtype=dtype),
    }
    if d_proj:
        defs["proj"] = ParamDef((d_hidden, d_proj), ("mlp", "embed_fsdp"),
                                dtype=dtype, fan_in=d_hidden)
    return defs


def _cell(params, carry, xw_t: torch.Tensor):
    """One step.  ``xw_t`` is ``x_t @ wx`` in the compute dtype; the gates
    are ``(x_t wx + h wh) + b`` as in the reference."""
    h, c = carry
    dt = xw_t.dtype
    gates = xw_t + h @ params["wh"].to(dt) + params["b"].to(dt)
    i, f, g, o = torch.chunk(gates.float(), 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_full = torch.sigmoid(o) * torch.tanh(c_new)
    if "proj" in params:
        h_new = (h_full.to(dt) @ params["proj"].to(dt)).float()
    else:
        h_new = h_full
    return (h_new.to(dt), c_new), h_new.to(dt)


def lstm(params, x: torch.Tensor, state: tuple | None = None
         ) -> tuple[torch.Tensor, tuple]:
    """x: [B, S, d_in] -> ([B, S, d_out], final (h, c))."""
    b, s, _ = x.shape
    d_hidden = params["b"].shape[0] // 4
    rec = params["wh"].shape[0]
    if state is None:
        state = (torch.zeros((b, rec), dtype=x.dtype, device=x.device),
                 torch.zeros((b, d_hidden), dtype=torch.float32,
                             device=x.device))
    xw = x @ params["wx"].to(x.dtype)                    # [B, S, 4H]
    ys = []
    for t in range(s):
        state, y = _cell(params, state, xw[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
