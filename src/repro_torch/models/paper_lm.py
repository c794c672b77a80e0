"""The paper's language model (§C.1) and its computationally-matched
baselines, counterpart of ``repro.models.paper_lm``.

Five layers: word embedding -> LSTM -> MoE (applied "convolutionally"
over all timesteps, §3.1) -> LSTM -> softmax.  Residual connections
around each non-softmax layer with dropout on the layer output; the MoE
output passes through a sigmoid before dropout (§C.1).

Variants (Appendix C baselines, Table 7): ``moe`` (noisy top-k, flat
or hierarchical: ``hierarchical=(a, b)``, Appendix B, with no sigmoid
on its output, as in the reference), ``moe_1_wide``, ``moe_1_deep``,
``lstm_4x``, ``lstm_2048_512``.

Randomness: torch cannot reproduce ``jax.random``, so
:func:`paper_lm_loss` takes its draws either from a ``torch.Generator``
(the trainer) or as tensors (``draws=``; the tests pass the JAX draws).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.param import ParamDef
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.core import hierarchical as hmoe_lib
from repro_torch.core import moe as moe_lib
from repro_torch.models import layers
from repro_torch.models import lstm as lstm_lib
from repro_torch.sharding.context import (MeshContext, local_draws,
                                         on_mesh, with_step_rows)

VARIANTS = ("moe", "moe_1_wide", "moe_1_deep", "lstm_4x", "lstm_2048_512")


@dataclasses.dataclass(frozen=True)
class PaperLMConfig:
    vocab_size: int
    variant: str = "moe"            # one of VARIANTS
    d_model: int = 512
    n_experts: int = 4
    k: int = 4                      # paper: k=4 flat, k=2 per level (hier.)
    expert_hidden: int = 1024
    hierarchical: tuple[int, int] | None = None
    router: Any = None              # RouterSpec | None
    gating_mode: str = "noisy_topk"
    capacity_factor: float = 2.0    # §C.1
    w_importance: float = 0.1       # §C.1
    w_load: float = 0.1
    dropout: float = 0.1
    kernel_backend: str = "cuda"    # cuda | ref
    dtype: torch.dtype = torch.float32


def _check(cfg: PaperLMConfig) -> None:
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown paper LM variant {cfg.variant!r}; "
                         f"have {VARIANTS}")


def _moe_args(cfg: PaperLMConfig) -> moe_lib.MoEArgs:
    return moe_lib.MoEArgs(
        n_experts=cfg.n_experts, k=cfg.k, d_model=cfg.d_model,
        d_ff=cfg.expert_hidden, activation="relu", router=cfg.router,
        gating_mode=cfg.gating_mode, capacity_factor=cfg.capacity_factor,
        w_importance=cfg.w_importance, w_load=cfg.w_load,
        sigmoid_output=True, kernel_backend=cfg.kernel_backend,
        dtype=cfg.dtype)


def _hmoe_args(cfg: PaperLMConfig) -> hmoe_lib.HMoEArgs:
    a, b = cfg.hierarchical
    return hmoe_lib.HMoEArgs(
        n_groups=a, n_experts_per_group=b, k_primary=2, k_secondary=2,
        d_model=cfg.d_model, d_ff=cfg.expert_hidden, activation="relu",
        router=cfg.router, capacity_factor=cfg.capacity_factor,
        w_importance=cfg.w_importance, w_load=cfg.w_load,
        kernel_backend=cfg.kernel_backend, dtype=cfg.dtype)


def paper_lm_defs(cfg: PaperLMConfig) -> dict:
    _check(cfg)
    d = cfg.d_model
    defs: dict = {
        "embed": layers.embed_defs(cfg.vocab_size, d, cfg.dtype),
        "lstm1": lstm_lib.lstm_defs(d, d, dtype=cfg.dtype),
        "lstm2": lstm_lib.lstm_defs(d, d, dtype=cfg.dtype),
        "softmax": {"w": ParamDef((d, cfg.vocab_size),
                                  ("embed_fsdp", "vocab"), dtype=cfg.dtype,
                                  fan_in=d)},
    }
    if cfg.variant == "moe" and cfg.hierarchical:
        defs["moe"] = hmoe_lib.hmoe_defs(_hmoe_args(cfg))
    elif cfg.variant == "moe":
        defs["moe"] = moe_lib.moe_defs(_moe_args(cfg))
    elif cfg.variant == "moe_1_wide":
        defs["mid"] = {
            "w1": ParamDef((d, 4096), ("embed_fsdp", "mlp"), dtype=cfg.dtype),
            "w2": ParamDef((4096, d), ("mlp", "embed_fsdp"), dtype=cfg.dtype),
        }
    elif cfg.variant == "moe_1_deep":
        defs["mid"] = {"w0": ParamDef((d, 1024), ("embed_fsdp", "mlp"),
                                      dtype=cfg.dtype)}
        for i in range(3):
            defs["mid"][f"w{i+1}"] = ParamDef(
                (1024, 1024), ("mlp", "mlp2"), dtype=cfg.dtype)
        defs["mid"]["w4"] = ParamDef((1024, d), ("mlp", "embed_fsdp"),
                                     dtype=cfg.dtype)
    elif cfg.variant == "lstm_4x":
        defs["mid"] = {"lstm3": lstm_lib.lstm_defs(d, d, dtype=cfg.dtype),
                       "lstm4": lstm_lib.lstm_defs(d, d, dtype=cfg.dtype)}
    else:
        # Replaces lstm1/MoE/lstm2: one big projected LSTM.
        defs["mid"] = {"big": lstm_lib.lstm_defs(d, 2048, d_proj=d,
                                                 dtype=cfg.dtype)}
    return defs


def make_draws(cfg: PaperLMConfig, batch_size: int, seq_len: int,
               generator: torch.Generator, device) -> dict:
    """One step's random draws, in the layout of the reference's
    four-way key split (``paper_lm.py:158``): ``keep0``..``keep3`` are
    the dropout keep-masks of keys 0..3, and ``noise`` is the MoE gate
    noise, which the reference draws from key 2 as well: [T, E] standard
    normals, or for the hierarchical MoE ``{"primary": [T, a],
    "secondary": [a, Cp, b]}`` (``hierarchical.hmoe_apply``)."""
    shape = (batch_size, seq_len, cfg.d_model)
    p_keep = 1.0 - cfg.dropout
    draws = {f"keep{i}": torch.rand(shape, generator=generator,
                                    device=device) < p_keep
             for i in range(4)}
    t = batch_size * seq_len
    if cfg.variant == "moe" and cfg.hierarchical:
        draws["noise"] = hmoe_lib.make_noise(_hmoe_args(cfg), t, generator,
                                             device)
    elif cfg.variant == "moe":
        draws["noise"] = torch.randn((t, cfg.n_experts),
                                     generator=generator, device=device)
    return draws


def _mid_layer(params, x2d: torch.Tensor, cfg: PaperLMConfig, *,
               train: bool, noise, ctx: MeshContext | None = None):
    """The capacity layer between the LSTMs.  x2d: [T, d]; on a mesh
    (``ctx``) this rank's rows, the flat MoE runs the expert-parallel
    schedule and the hierarchical MoE its global plan (``noise`` the
    global batch's)."""
    zero_aux = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                        device=x2d.device), "metrics": {}}
    if cfg.variant == "moe" and cfg.hierarchical:
        return hmoe_lib.hmoe_apply(params["moe"], x2d, _hmoe_args(cfg),
                                   train=train, noise=noise, ctx=ctx)
    if cfg.variant == "moe" and on_mesh(ctx):
        return ep_lib.moe_apply_ep(params["moe"], x2d, _moe_args(cfg), ctx,
                                   train=train, noise=noise)
    if cfg.variant == "moe":
        return moe_lib.moe_apply(params["moe"], x2d, _moe_args(cfg),
                                 train=train, noise=noise)
    if cfg.variant == "moe_1_wide":
        h = torch.relu(x2d @ params["mid"]["w1"])
        return torch.sigmoid(h @ params["mid"]["w2"]), zero_aux
    h = x2d
    for i in range(5):
        h = h @ params["mid"][f"w{i}"]
        if i < 4:
            h = torch.relu(h)
    return torch.sigmoid(h), zero_aux


def paper_lm_loss(params, batch, cfg: PaperLMConfig, *,
                  generator: torch.Generator | None = None,
                  draws: dict | None = None, train: bool = True,
                  ctx: MeshContext | None = None):
    """batch: tokens / labels [B, S].  Returns (loss, metrics).

    Draws come from ``draws`` (see :func:`make_draws`) or, when that is
    None, from ``generator``; with neither (or ``train=False``) there is
    no dropout and no gate noise, as with the reference's ``rng=None``.
    On a mesh (``ctx``), as ``lm.lm_loss``: ``params`` are this rank's
    slices, gathered here on use, ``batch`` is this rank's rows (split
    as the enclosing training step split them), the draws the global
    batch's of which it keeps its rows' masks and its tokens' noise,
    and ``xent`` the rank's own mean.
    """
    _check(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    mesh = on_mesh(ctx)
    if mesh:
        ctx = with_step_rows(ctx)
        params = ep_lib.gather_on_use(params, paper_lm_defs(cfg), ctx)
    if train and draws is None and generator is not None:
        draws = make_draws(cfg, b * (ctx.size(ctx.rows_over) if mesh
                                     else 1), s, generator, tokens.device)
    if train and draws is not None and mesh:
        draws = local_draws(draws, ctx, whole=("noise",) if cfg.hierarchical
                            else (), rows=[f"keep{i}" for i in range(4)])
    draws = draws if train else None
    keep = [None if draws is None else draws.get(f"keep{i}")
            for i in range(4)]
    noise = None if draws is None else draws.get("noise")

    def drop(v, i):
        return layers.dropout(v, cfg.dropout, train, keep=keep[i])

    x = layers.embed(params["embed"], tokens, cfg.dtype)
    x = drop(x, 0)
    aux = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                   device=x.device), "metrics": {}}
    if cfg.variant == "lstm_2048_512":
        h, _ = lstm_lib.lstm(params["mid"]["big"], x)
        x = x + drop(h, 1)
    else:
        h, _ = lstm_lib.lstm(params["lstm1"], x)
        x = x + drop(h, 1)
        if cfg.variant == "lstm_4x":
            # The reference feeds key 2 to both dropouts of the two extra
            # LSTMs, so they share one mask: drawn once, used twice.
            h, _ = lstm_lib.lstm(params["mid"]["lstm3"], x)
            x = x + drop(h, 2)
            h, _ = lstm_lib.lstm(params["mid"]["lstm4"], x)
            x = x + drop(h, 2)
        else:
            # The MoE is applied convolutionally: all B*S positions as
            # one batch (§3.1).  Key 2 feeds both the gate noise and the
            # dropout of the MoE output in the reference, so both come
            # from draw 2.
            y2d, aux = _mid_layer(params, x.reshape(b * s, -1), cfg,
                                  train=train, noise=noise, ctx=ctx)
            x = x + drop(y2d.reshape(b, s, -1), 2)
        h, _ = lstm_lib.lstm(params["lstm2"], x)
        x = x + drop(h, 3)

    logits = (x @ params["softmax"]["w"]).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    xent = torch.mean(lse - gold)
    loss = xent + aux["aux_loss"]
    metrics = {"xent": xent, "perplexity": torch.exp(xent),
               "aux_loss": aux["aux_loss"], "loss": loss,
               **aux.get("metrics", {})}
    return loss, metrics
