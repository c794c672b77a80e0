"""Two-level hierarchical Mixture-of-Experts (Appendix B), counterpart of
``repro.core.hierarchical``.

A primary gating network selects among ``a`` groups; each group is
itself a secondary MoE over ``b`` experts.  Output (Eq. 12):

    y_H = sum_i sum_j G_primary(x)_i * G_i(x)_j * E_{i,j}(x)

Utilization metrics follow Eqs. (13)-(14):

    Importance_H(X)_{i,j} = sum_x Gp(x)_i * G_i(x)_j
    Load_H(X)_{i,j}       = Load_primary(X)_i * Load_i(X^(i))_j / |X^(i)|

The primary level capacity-dispatches the tokens into ``[a, Cp, d]``
group buffers.  The secondary level routes all ``a`` groups at once
(the router's grouped form: one batched gate matmul, one top-k over the
``a·Cp`` slot rows) with the primary plan's empty slots masked out, so
they neither route nor take secondary capacity.  Its plan is one plan
over the flat ``a·b`` experts (group g's expert j is ``g·b + j``), slot
for slot the reference's per-group plans, so dispatch, the expert FFN
(on ``w1.view(a·b, d, f)``, a view) and combine each run once for all
groups, as the reference's ``vmap`` of a ``pallas_call`` is one kernel
with a leading grid axis.

Randomness: ``noise`` is ``{"primary": [T, a], "secondary": [a, Cp,
b]}`` standard normals (the reference draws the primary level's from
the first half of ``split(rng)`` and group g's from ``split(rng_s,
a)[g]``).  Policies: ``noisy_topk`` and ``expert_choice``; the
Appendix-F modes raise RouterError, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import gating, losses
from repro_torch.core import router as router_lib
from repro_torch.kernels import backend as backend_lib


@dataclasses.dataclass(frozen=True)
class HMoEArgs:
    n_groups: int                 # a, the primary branching factor
    n_experts_per_group: int      # b, the secondary branching factor
    k_primary: int                # paper: k=2 at each level for the big LMs
    k_secondary: int
    d_model: int
    d_ff: int
    activation: str = "relu"
    # One spec for both levels; k is overridden per level.  None builds
    # one from the fields below (router.resolve_spec).
    router: "router_lib.RouterSpec | None" = None
    capacity_factor: float | None = None
    w_importance: float = 0.1
    w_load: float = 0.1
    dispatch_impl: str = "sort"         # sort | einsum (ref backend only)
    kernel_backend: str = "cuda"        # cuda | ref
    # Dispatch / combine regime of both levels (kernels/backend.py).
    dispatch_e_block: int | None = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_experts(self) -> int:
        return self.n_groups * self.n_experts_per_group


_HMOE_POLICIES = ("noisy_topk", "expert_choice")


def _level_specs(a: HMoEArgs):
    """(primary, secondary) RouterSpecs from the carrier's single spec."""
    spec = router_lib.resolve_spec(a)
    if spec.policy not in _HMOE_POLICIES:
        raise router_lib.RouterError(
            f"hierarchical MoE supports policies {_HMOE_POLICIES}, got "
            f"{spec.policy!r} (Appendix-F modes need per-level threshold "
            "parameters the hierarchy does not declare)")
    return spec.replace(k=a.k_primary), spec.replace(k=a.k_secondary)


def hmoe_defs(a: HMoEArgs) -> dict:
    _level_specs(a)                 # validate the policy early
    g, b, d, f = a.n_groups, a.n_experts_per_group, a.d_model, a.d_ff
    stacked = ("expert_groups", "embed", "experts")
    defs = {
        "gate_primary": gating.gating_defs(d, g),
        # Secondary gates stacked over groups: [a, d_model, b].
        "gate_secondary": {
            "wg": ParamDef((g, d, b), stacked, init="zeros",
                           dtype=torch.float32),
            "wnoise": ParamDef((g, d, b), stacked, init="zeros",
                               dtype=torch.float32),
        },
        "w1": ParamDef((g, b, d, f), ("expert_groups", "experts",
                                      "expert_embed", "expert_mlp"),
                       dtype=a.dtype, fan_in=d),
        "w2": ParamDef((g, b, f, d), ("expert_groups", "experts",
                                      "expert_mlp", "expert_embed"),
                       dtype=a.dtype, fan_in=f),
    }
    if a.activation == "swiglu":
        defs["w3"] = ParamDef((g, b, d, f), ("expert_groups", "experts",
                                             "expert_embed", "expert_mlp"),
                              dtype=a.dtype, fan_in=d)
    return defs


def make_noise(a: HMoEArgs, n_tokens: int, generator: torch.Generator,
               device) -> dict:
    """A training step's gate noise for both levels: ``{"primary": [T,
    a], "secondary": [a, Cp, b]}`` standard normals, Cp the primary
    level's capacity at ``train=True``."""
    spec_p, _ = _level_specs(a)
    cp = spec_p.capacity(n_tokens, a.n_groups, train=True)
    return {"primary": torch.randn((n_tokens, a.n_groups),
                                   generator=generator, device=device),
            "secondary": torch.randn((a.n_groups, cp,
                                      a.n_experts_per_group),
                                     generator=generator, device=device)}


def _kept_slots(plan, n_groups: int) -> torch.Tensor:
    """[a, Cp] f32: 1 at the (group, slot) pairs the primary plan fills,
    the reference's dispatch of a ones column; no host sync."""
    cp = plan.capacity
    pos = plan.position.reshape(-1).long()
    cell = plan.expert_index.reshape(-1).long() * cp + pos
    spare = n_groups * cp                       # dropped pairs land here
    cell = torch.where(pos < cp, cell, torch.full_like(cell, spare))
    valid = torch.zeros((spare + 1,), dtype=torch.float32,
                        device=cell.device).scatter_(0, cell, 1.0)
    return valid[:spare].reshape(n_groups, cp)


def hmoe_apply(params, x: torch.Tensor, a: HMoEArgs, *, train: bool = True,
               noise: dict | None = None,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
    """x: [T, d_model] -> (y [T, d_model], aux).  ``noise`` is the
    two-level dict of the module docstring (None: noiseless gates, as
    the reference's ``rng=None``); ``mask`` ([T] in {0,1}) marks valid
    tokens (dead serving slots route nowhere)."""
    g, b = a.n_groups, a.n_experts_per_group
    d = x.shape[-1]
    noise = noise or {}
    bk = backend_lib.resolve(a)
    spec_p, spec_s = _level_specs(a)
    router_p = router_lib.Router(spec_p, g, topk_impl=bk.topk_impl)
    dec_p = router_p.route({"gate": params["gate_primary"]}, x, train=train,
                           noise=noise.get("primary"), mask=mask)
    buf = bk.dispatch(x, dec_p, a)                          # [a, Cp, d]
    cp = buf.shape[1]
    valid = _kept_slots(dec_p.plan, g)                      # [a, Cp]

    # Every group's secondary MoE at once, over the flat a·b experts.
    router_s = router_lib.Router(spec_s, b, topk_impl=bk.topk_impl)
    dec_s = router_s.route({"gate": params["gate_secondary"]}, buf,
                           train=train, noise=noise.get("secondary"),
                           mask=valid,
                           capacity=spec_s.capacity(cp, b, train=train))
    flat = {k: w.reshape((g * b,) + w.shape[2:])
            for k, w in params.items() if k in ("w1", "w2", "w3")}
    xs = buf.reshape(g * cp, d)
    out = bk.expert_ffn(flat, bk.dispatch(xs, dec_s, a), a, rows=dec_s.rows)
    y_grp = bk.combine(out, dec_s, a, dtype=x.dtype).reshape(g, cp, d)
    y = bk.combine(y_grp, dec_p, a, dtype=x.dtype)          # primary

    # Eq. (13): the secondary importance sums the secondary gates of the
    # dispatched tokens; scale by the mean primary gate mass per group.
    n_valid = torch.clamp(valid.sum(dim=1), min=1.0)        # [a]
    imp_primary = losses.importance(dec_p.gates)            # [a]
    imp_h = losses.importance(dec_s.gates) * (imp_primary
                                              / n_valid)[:, None]
    # Eq. (14): Load_H = Load_p_i * Load_i / |X^(i)|.
    load_h = dec_p.load[:, None] * dec_s.load / n_valid[:, None]

    cv_imp = losses.cv_squared(imp_h.reshape(-1))
    cv_load = losses.cv_squared(load_h.reshape(-1))
    aux_loss = spec_p.w_importance * cv_imp + spec_p.w_load * cv_load
    metrics = {
        "cv_importance": torch.sqrt(cv_imp),
        "cv_load": torch.sqrt(cv_load),
        "max_over_mean_load": torch.max(load_h) / torch.clamp(
            torch.mean(load_h), min=1e-9),
        "fraction_dropped": dec_p.plan.fraction_dropped,
    }
    # Serving telemetry over the flat (group, expert) grid; primary-level
    # drops show in metrics["fraction_dropped"].
    return y, {"aux_loss": aux_loss, "metrics": metrics,
               "telemetry": dec_s.telemetry}
