"""The Sparsely-Gated Mixture-of-Experts layer (§2), counterpart of
``repro.core.moe``.

``moe_defs`` declares the parameters; ``moe_apply`` runs routing ->
dispatch -> expert FFN -> combine and returns (output, aux) where aux
carries the §4 balancing losses, the Table-6 diagnostics and the serving
telemetry.  The hot-path ops go through the kernel backend registry
(``kernels/backend.py``): ``"cuda"`` runs the hand-written kernels,
``"ref"`` the plain PyTorch path.  With ``fused_decode`` an eval call
is the backend's one-launch ``decode_step``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import router as router_lib
from repro_torch.kernels import backend as backend_lib


ZERO_METRICS = ("cv_importance", "cv_load", "max_over_mean_load",
                "fraction_dropped")


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    n_experts: int
    k: int
    d_model: int
    d_ff: int
    activation: str = "relu"            # relu (paper) | swiglu
    router: "router_lib.RouterSpec | None" = None
    # Routing fields folded into a RouterSpec when ``router`` is None.
    gating_mode: str = "noisy_topk"
    capacity_factor: float | None = None
    eval_capacity_factor: float | None = None
    w_importance: float = 0.1
    w_load: float = 0.1
    dispatch_impl: str = "sort"         # sort | einsum (ref backend only)
    priority_dispatch: bool = False
    kernel_backend: str = "cuda"        # cuda | ref
    # Dispatch / combine buffer regime (kernels/backend.py:plan_e_block):
    # None keeps the resident kernels; an int forces the expert-blocked
    # ones with that slab.
    dispatch_e_block: int | None = None
    # Serve-time fused decode: one launch per MoE layer for eval calls
    # (the model layer sets it on decode-shaped calls only).
    fused_decode: bool = False
    sigmoid_output: bool = False        # paper's LM passes MoE out thru sigmoid
    dtype: torch.dtype = torch.bfloat16


def moe_defs(a: MoEArgs) -> dict:
    spec = router_lib.resolve_spec(a)
    defs = dict(router_lib.Router(spec, a.n_experts).gate_defs(a.d_model))
    defs.update({
        "w1": ParamDef((a.n_experts, a.d_model, a.d_ff),
                       ("experts", "expert_embed", "expert_mlp"),
                       dtype=a.dtype, fan_in=a.d_model),
        "w2": ParamDef((a.n_experts, a.d_ff, a.d_model),
                       ("experts", "expert_mlp", "expert_embed"),
                       dtype=a.dtype, fan_in=a.d_ff),
    })
    if a.activation == "swiglu":
        defs["w3"] = ParamDef((a.n_experts, a.d_model, a.d_ff),
                              ("experts", "expert_embed", "expert_mlp"),
                              dtype=a.dtype, fan_in=a.d_model)
    return defs


def moe_apply(params, x: torch.Tensor, a: MoEArgs, *, train: bool = True,
              noise: torch.Tensor | None = None,
              mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, dict]:
    """x: [T, d_model] (tokens already flattened, §3.1).

    ``noise`` ([T, E] standard normals) is the Eq. (3) gating noise for
    ``train=True`` (``None``: a noiseless gate, as the reference's
    ``rng=None``); every op is differentiable, the auxiliary loss and
    the Appendix-A load estimator included; ``mask`` ([T] in {0,1}) marks valid tokens — masked
    tokens get zero gate weight, zero load and telemetry, and consume no
    expert capacity."""
    bk = backend_lib.resolve(a)
    if not train and a.fused_decode:
        # One launch for the whole layer (kernels/backend.py); its
        # telemetry is the kernel's load / overflow.  Decode discards the
        # losses and metrics, so aux carries zeros.
        y, telemetry = bk.decode_step(params, x, a, mask=mask)
        if a.sigmoid_output:
            y = torch.sigmoid(y.float()).to(x.dtype)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return y, {"aux_loss": zero,
                   "metrics": {k: zero for k in ZERO_METRICS},
                   "telemetry": telemetry}
    router = router_lib.build(a, topk_impl=bk.topk_impl)
    dec = router.route(params, x, train=train, noise=noise, mask=mask)
    buf = bk.dispatch(x, dec, a)
    out = bk.expert_ffn(params, buf, a)
    y = bk.combine(out, dec, a, dtype=x.dtype)
    if a.sigmoid_output:
        y = torch.sigmoid(y.float()).to(x.dtype)
    return y, {"aux_loss": dec.aux_loss, "metrics": dec.metrics,
               "telemetry": dec.telemetry}
