"""Router API: RouterSpec + policy registry + RouteDecision, counterpart
of ``repro.core.router``.

* :class:`RouterSpec` — frozen value object holding everything that
  configures a routing decision (policy, k, capacity factors, noise,
  balance-loss weights, dispatch flavour).
* the policy registry — ``get_policy`` resolves explicitly and raises
  :class:`RouterError` for an unknown name.  Built-ins: ``noisy_topk``
  (Eqs. 3-5 + Appendix-A load), ``batchwise`` and ``threshold``
  (Appendix F) and ``expert_choice`` (experts pick tokens, Zhou et al.
  2022).
* :class:`Router` / :class:`RouteDecision` — ``router.route(params, x,
  train=..., noise=..., mask=..., capacity=...)`` returns combine
  weights, indices, the capacity plan, balancing losses, metrics and
  serving telemetry.

``mask`` ([T] in {0,1}) zeroes masked tokens out of gates, load,
telemetry and capacity: the serving engine passes slot occupancy and the
bucketed-prefill padding mask through it.

Grouped routing (the hierarchical MoE's secondary level, policies
``noisy_topk`` and ``expert_choice``): ``x`` [G, T, d] routes G token
batches at once, each by its own gate slice (leaves [G, d, E]), as
``vmap`` of ``route`` over the groups would; the plan is one plan over
the G·E experts (group g's expert j is ``g·E + j``), slot for slot the
G per-group plans, so each kernel runs once for all groups.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import dispatch as dsp
from repro_torch.core import gating, losses

DEFAULT_CAPACITY_FACTOR = 2.0


class RouterError(ValueError):
    """Unknown routing policy or invalid router configuration."""


@dataclasses.dataclass(frozen=True)
class RouterSpec:
    """Everything that configures one routing decision (``k=None``
    inherits the carrier's k; ``eval_capacity_factor=None`` means "same
    as training")."""
    policy: str = "noisy_topk"
    k: int | None = None
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR
    eval_capacity_factor: float | None = None
    noise: bool = True
    w_importance: float = 0.1
    w_load: float = 0.1
    dispatch: str = "sort"          # ref-backend scatter: sort | einsum
    priority_dispatch: bool = False
    capacity_multiple: int = 8

    def replace(self, **kw) -> "RouterSpec":
        return dataclasses.replace(self, **kw)

    @property
    def eval_cf(self) -> float:
        return (self.capacity_factor if self.eval_capacity_factor is None
                else self.eval_capacity_factor)

    def capacity(self, n_tokens: int, n_experts: int, *,
                 train: bool) -> int:
        cf = self.capacity_factor if train else self.eval_cf
        return dsp.capacity_for(n_tokens, n_experts, self.k or 1, cf,
                                multiple=self.capacity_multiple)


class RouteDecision(NamedTuple):
    """For grouped input every field but ``plan``, ``rows`` and
    ``telemetry`` keeps the leading group axis (indices local to the
    group, ``aux_loss`` and metrics one per group, but the plan's
    ``fraction_dropped``); those three are over the flat G·E experts."""
    combine_weights: torch.Tensor   # [T, k] f32
    expert_index: torch.Tensor      # [T, k] int32
    gates: torch.Tensor             # [T, E] f32
    load: torch.Tensor              # [E] f32
    plan: dsp.DispatchPlan
    aux_loss: torch.Tensor
    metrics: dict
    telemetry: dict
    # [E] int32 filled leading slots of each expert (dispatch.filled_rows)
    # when the plan fills slots as a prefix (dispatch.plan's plans); None
    # for a policy's own plan (expert_choice's slots are column ranks, of
    # which a token may drop some).  The GMM kernels stop at it.
    rows: torch.Tensor | None = None


def route_telemetry(info: gating.GatingInfo, p: dsp.DispatchPlan) -> dict:
    """Per-expert serving counters over the plan's experts:
    ``expert_load`` (assignments routed per expert) and ``overflow``
    (assignments dropped by capacity).  Masked (zero-weight) tokens count
    toward neither."""
    assigned = (info.combine_weights > 0.0).reshape(-1).float()
    kept = (p.position < p.capacity).reshape(-1)
    flat_e = p.expert_index.reshape(-1).long()
    zero = torch.zeros((p.n_experts,), dtype=torch.float32,
                       device=assigned.device)
    return {"expert_load": zero.index_add(0, flat_e, assigned),
            "overflow": zero.index_add(0, flat_e,
                                       assigned * (~kept).float())}


class PolicyOutput(NamedTuple):
    """What a policy hands back to the Router: ``capacity`` / ``plan``
    override the spec's capacity and the standard plan when set;
    ``extra_loss`` joins the balancing losses (Eq. 20)."""
    info: gating.GatingInfo
    capacity: int | None = None
    plan: dsp.DispatchPlan | None = None
    extra_loss: torch.Tensor | float = 0.0


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """``route(params, x, spec, n_experts, *, train, noise, mask,
    capacity, topk_impl) -> PolicyOutput``; ``defs(spec, d_model,
    n_experts)`` -> the policy's parameter definitions."""
    name: str
    route: Callable
    defs: Callable


_POLICIES: dict[str, RouterPolicy] = {}


def register_policy(policy: RouterPolicy) -> None:
    _POLICIES[policy.name] = policy


def get_policy(name: str) -> RouterPolicy:
    entry = _POLICIES.get(name)
    if entry is None:
        raise RouterError(f"unknown router policy {name!r}; registered: "
                          f"{sorted(_POLICIES)}")
    return entry


def resolve_spec(a) -> RouterSpec:
    """Carrier (MoEArgs / ModelConfig) -> a validated RouterSpec.  An
    explicit ``a.router`` wins; otherwise the carrier's routing fields
    build one.  ``k=None`` inherits the carrier's k."""
    spec = getattr(a, "router", None)
    if spec is None:
        cf = getattr(a, "capacity_factor", None)
        spec = RouterSpec(
            policy=getattr(a, "gating_mode", "noisy_topk"),
            capacity_factor=DEFAULT_CAPACITY_FACTOR if cf is None else cf,
            eval_capacity_factor=getattr(a, "eval_capacity_factor", None),
            w_importance=getattr(a, "w_importance", 0.1),
            w_load=getattr(a, "w_load", 0.1),
            dispatch=getattr(a, "dispatch_impl", "sort"),
            priority_dispatch=getattr(a, "priority_dispatch", False))
    if spec.k is None:
        k = getattr(a, "k", None)
        if k is None:
            k = getattr(a, "moe_k", None)
        if k:
            spec = spec.replace(k=int(k))
    get_policy(spec.policy)
    return spec


class Router:
    """A resolved (spec, n_experts) pair with a callable ``route``.
    ``topk_impl`` is the kernel backend's fused KeepTopK+softmax, or None
    for the sort-based path."""

    def __init__(self, spec: RouterSpec, n_experts: int, *,
                 topk_impl: Callable | None = None):
        if spec.k is None:
            raise RouterError(f"RouterSpec.k unresolved for {spec}")
        self.spec = spec
        self.n_experts = n_experts
        self.policy = get_policy(spec.policy)
        self.topk_impl = topk_impl

    def gate_defs(self, d_model: int) -> dict:
        return self.policy.defs(self.spec, d_model, self.n_experts)

    def capacity(self, n_tokens: int, *, train: bool) -> int:
        return self.spec.capacity(n_tokens, self.n_experts, train=train)

    def route(self, params, x: torch.Tensor, *, train: bool,
              noise: torch.Tensor | None = None,
              mask: torch.Tensor | None = None,
              capacity: int | None = None) -> RouteDecision:
        """One routing decision over a flat token batch x: [T, d], or
        over G batches x: [G, T, d] (grouped routing, see the module
        docstring; ``noise`` [G, T, E], ``mask`` [G, T]).  ``capacity``
        overrides the spec-derived slots per expert (the hierarchical
        secondary level does this)."""
        spec = self.spec
        if mask is not None:
            mask = mask.float().reshape(x.shape[:-1])
        if capacity is None:
            capacity = self.capacity(x.shape[-2], train=train)
        out = self.policy.route(params, x, spec, self.n_experts,
                                train=train, noise=noise, mask=mask,
                                capacity=capacity, topk_impl=self.topk_impl)
        info = out.info
        plan, rows = out.plan, None
        if plan is None:
            k = info.expert_index.shape[-1]
            plan = dsp.plan(flat_expert_ids(info.expert_index,
                                            self.n_experts),
                            info.combine_weights.reshape(-1, k),
                            self.n_experts * n_groups(x),
                            capacity if out.capacity is None
                            else out.capacity,
                            priority=spec.priority_dispatch)
            rows = dsp.filled_rows(plan)
        aux_loss = (losses.importance_loss(info.gates, spec.w_importance)
                    + losses.load_loss(info.load, spec.w_load)
                    + out.extra_loss)
        metrics = losses.balance_metrics(info.gates, info.load)
        metrics["fraction_dropped"] = plan.fraction_dropped
        return RouteDecision(
            combine_weights=info.combine_weights,
            expert_index=info.expert_index, gates=info.gates,
            load=info.load, plan=plan, aux_loss=aux_loss,
            metrics=metrics, telemetry=route_telemetry(info, plan),
            rows=rows)


def build(a, *, topk_impl: Callable | None = None) -> Router:
    return Router(resolve_spec(a), a.n_experts, topk_impl=topk_impl)


def n_groups(x: torch.Tensor) -> int:
    """G of a grouped [G, T, d] batch; 1 for a flat [T, d] one."""
    return x.shape[0] if x.dim() == 3 else 1


def flat_expert_ids(expert_index: torch.Tensor,
                    n_experts: int) -> torch.Tensor:
    """[..., T, k] group-local expert ids -> [G·T, k] ids over the flat
    G·E experts (group g's expert j is g·E + j); [T, k] stays as is."""
    if expert_index.dim() == 2:
        return expert_index
    g = expert_index.shape[0]
    offset = torch.arange(g, dtype=expert_index.dtype,
                          device=expert_index.device) * n_experts
    return (expert_index + offset[:, None, None]).reshape(
        -1, expert_index.shape[-1])


def _gate_only_defs(spec: RouterSpec, d_model: int, n_experts: int) -> dict:
    return {"gate": gating.gating_defs(d_model, n_experts, noisy=False)}


def _noisy_topk_defs(spec: RouterSpec, d_model: int, n_experts: int) -> dict:
    return {"gate": gating.gating_defs(d_model, n_experts,
                                       noisy=spec.noise)}


def _noisy_topk_route(params, x, spec, n_experts, *, train, noise, mask,
                      capacity, topk_impl) -> PolicyOutput:
    """Eqs. (3)-(5) + the Appendix-A load estimator."""
    return PolicyOutput(info=gating.noisy_topk_gating(
        params["gate"], x, spec.k, train=train and spec.noise,
        noise=noise if spec.noise else None, valid=mask,
        topk_impl=topk_impl))


def _appendix_f_capacity(spec: RouterSpec, n_tokens: int,
                         n_experts: int) -> int:
    """Appendix F: exactly m = k·T/E slots per expert; nothing dropped."""
    cap = max((spec.k * n_tokens) // n_experts, 1)
    m = spec.capacity_multiple
    return int(-(-cap // m) * m)


def _batchwise_route(params, x, spec, n_experts, *, train, noise, mask,
                     capacity, topk_impl) -> PolicyOutput:
    info = gating.batchwise_gating(params["gate"], x, spec.k, valid=mask)
    cap = (_appendix_f_capacity(spec, x.shape[0], n_experts) if train
           else None)
    return PolicyOutput(info=info, capacity=cap)


def _threshold_defs(spec: RouterSpec, d_model: int, n_experts: int) -> dict:
    return {"gate": gating.gating_defs(d_model, n_experts, noisy=False),
            "thresholds": gating.threshold_defs(n_experts)}


def _threshold_route(params, x, spec, n_experts, *, train, noise, mask,
                     capacity, topk_impl) -> PolicyOutput:
    if train:   # train with the batchwise mask, infer with thresholds
        info = gating.batchwise_gating(params["gate"], x, spec.k,
                                       valid=mask)
        extra = gating.batchwise_threshold_loss(
            params["gate"], params["thresholds"], x, spec.k)
        cap = _appendix_f_capacity(spec, x.shape[0], n_experts)
        return PolicyOutput(info=info, capacity=cap, extra_loss=extra)
    return PolicyOutput(info=gating.threshold_gating(
        params["gate"], params["thresholds"], x, spec.k, valid=mask))


def _expert_choice_route(params, x, spec, n_experts, *, train, noise, mask,
                         capacity, topk_impl) -> PolicyOutput:
    """Expert-choice routing (Zhou et al. 2022): each expert picks its
    top-``capacity`` tokens by gate affinity, so nothing overflows: the
    positions are column ranks.  A token keeps at most ``spec.k`` of the
    experts that picked it (the token-major [T, k] plan); picks beyond
    that are reported as ``fraction_dropped``.  Masked tokens are never
    picked.  Grouped input ([G, T, d]): each group's experts pick among
    its own tokens; the plan is over the flat G·E experts."""
    t = x.shape[-2]
    dev = x.device
    logits = x.float() @ params["gate"]["wg"].float()           # [..., T, E]
    g_dense = torch.softmax(logits, dim=-1)
    g_pickable = g_dense if mask is None else g_dense * mask[..., None]
    cap = min(capacity, t)
    # Expert-major [..., E, C]: each expert's picks, in rank order.
    col_vals, col_idx = gating.top_k(g_pickable.transpose(-1, -2), cap)
    col_idx = col_idx.long()
    by_expert = g_dense.transpose(-1, -2).shape                 # [..., E, T]
    picked = torch.zeros(by_expert, dtype=torch.bool, device=dev).scatter(
        -1, col_idx, col_vals > 0.0).transpose(-1, -2)
    ranks = torch.arange(cap, dtype=torch.int32, device=dev)
    pos_matrix = torch.full(by_expert, capacity, dtype=torch.int32,
                            device=dev).scatter(
        -1, col_idx, ranks.expand(col_idx.shape)).transpose(-1, -2)
    # Token-major view: each token keeps its k best picking experts.
    g_kept = torch.where(picked, g_dense, 0.0)
    k = min(spec.k, n_experts)
    combine, topk_idx = gating.top_k(g_kept, k)
    position = torch.gather(pos_matrix, -1, topk_idx.long())
    position = torch.where(combine > 0.0, position,
                           torch.full_like(position, capacity))
    gates = torch.zeros_like(g_dense).scatter(-1, topk_idx.long(), combine)
    load = picked.float().sum(dim=-2)
    n_picks = torch.clamp(picked.float().sum(), min=1.0)
    kept = (combine > 0.0).float().sum()
    plan = dsp.DispatchPlan(
        expert_index=flat_expert_ids(topk_idx, n_experts),
        position=position.reshape(-1, k),
        weight=combine.float().reshape(-1, k),
        n_experts=n_experts * n_groups(x), capacity=capacity,
        fraction_dropped=(n_picks - kept) / n_picks)
    info = gating.GatingInfo(combine_weights=combine, expert_index=topk_idx,
                             gates=gates, load=load, raw_logits=logits)
    return PolicyOutput(info=info, plan=plan)


register_policy(RouterPolicy(name="noisy_topk", route=_noisy_topk_route,
                             defs=_noisy_topk_defs))
register_policy(RouterPolicy(name="batchwise", route=_batchwise_route,
                             defs=_gate_only_defs))
register_policy(RouterPolicy(name="threshold", route=_threshold_route,
                             defs=_threshold_defs))
register_policy(RouterPolicy(name="expert_choice",
                             route=_expert_choice_route,
                             defs=_gate_only_defs))
