"""Auxiliary balancing losses (§4 and Appendix A), counterpart of
``repro.core.losses``; all in float32."""
from __future__ import annotations

import torch


def cv_squared(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Squared coefficient of variation Var(x) / Mean(x)^2 (population
    variance); 0 for vectors of length <= 1."""
    x = x.float()
    if x.shape[-1] <= 1:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    mean = torch.mean(x, dim=-1)
    var = torch.var(x, dim=-1, unbiased=False)
    return var / (mean * mean + eps)


def importance(gates: torch.Tensor) -> torch.Tensor:
    """Eq. (6): Importance(X)_i = sum_x G(x)_i.  gates: [..., T, E] ->
    [..., E] (leading group axes stay)."""
    return torch.sum(gates.float(), dim=-2)


def importance_loss(gates: torch.Tensor, w_importance: float) -> torch.Tensor:
    """Eq. (7)."""
    return w_importance * cv_squared(importance(gates))


def load_loss(load: torch.Tensor, w_load: float) -> torch.Tensor:
    """Eq. (11); ``load`` is the smooth estimator from the gating network."""
    return w_load * cv_squared(load)


def balance_metrics(gates: torch.Tensor, load: torch.Tensor) -> dict:
    """The Table-6 diagnostics: CV(Importance), CV(Load), max/mean load
    (one value per group when the inputs carry leading group axes)."""
    imp = importance(gates)
    loadf = load.float()
    return {
        "cv_importance": torch.sqrt(cv_squared(imp)),
        "cv_load": torch.sqrt(cv_squared(loadf)),
        "max_over_mean_load": torch.amax(loadf, dim=-1) / torch.clamp(
            torch.mean(loadf, dim=-1), min=1e-9),
        "fraction_dropped": torch.zeros((), dtype=torch.float32,
                                        device=loadf.device),
    }
