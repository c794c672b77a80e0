"""Model configuration schema + architecture registry (counterpart of
``repro.configs.base``).

The fields are the reference's, minus the mesh and TPU-tiling knobs
(sharding, the VMEM budget ``dispatch_vmem_limit``, the measured GMM
tilings ``gmm_autotune``); dtypes are torch dtypes; ``kernel_backend``
defaults to ``"cuda"``.  The transformer stack interprets a config
through :func:`layer_kinds`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.router import DEFAULT_CAPACITY_FACTOR, RouterSpec


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str = "attn"        # attn | attn_local | mamba | moa
    ffn: str = "dense"         # dense | moe | moe+dense | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # --- layer pattern -----------------------------------------------------
    period: int = 1
    attn_positions: tuple[int, ...] = ()
    global_attn_positions: tuple[int, ...] = ()
    sliding_window: int = 0
    moe_positions: tuple[int, ...] = ()
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    moe_k: int = 0
    moe_d_ff: int = 0
    moe_hierarchical: tuple[int, int] | None = None
    dense_residual: bool = False
    router: RouterSpec | None = None
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR
    w_importance: float = 0.1
    w_load: float = 0.1
    gating_mode: str = "noisy_topk"
    dispatch_impl: str = "sort"
    # --- MoA ----------------------------------------------------------------
    moa_positions: tuple[int, ...] = ()
    moa_experts: int = 0
    moa_k: int = 0
    moa_heads_per_expert: int = 0
    # The FFN's RouterSpec (k stripped) routes MoA too unless this
    # overrides it.
    moa_router: RouterSpec | None = None
    # --- attention ----------------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # Query heads padded with zero heads up to this count (sliced off
    # before the output projection; numerically unchanged).
    pad_attn_heads: int = 0
    # --- ssm ----------------------------------------------------------------
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # --- modality frontend stub ----------------------------------------------
    frontend: str = "none"
    n_prefix: int = 0
    # --- misc ----------------------------------------------------------------
    activation: str = "swiglu"
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    # Training: one torch.utils.checkpoint around each stacked layer;
    # scan_layers=False keeps every layer unstacked (the "tail").
    remat: bool = True
    scan_layers: bool = True
    # flash_attention's blocks (models/attention.py).
    q_block: int = 512
    kv_block: int = 512
    kernel_backend: str = "cuda"           # cuda | ref
    # Dispatch / combine regime: None keeps the resident kernels 2 and 4;
    # an int forces the expert-blocked kernels 3 and 5 with that slab.
    dispatch_e_block: int | None = None
    # One fused launch per MoE layer (and per MoA projection) at decode;
    # prefill stays unfused (models/transformer.py).
    fused_decode: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def layer_kinds(cfg: ModelConfig) -> list[LayerKind]:
    """One LayerKind per position-in-period."""
    kinds = []
    for p in range(cfg.period):
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.family == "hybrid":
            mixer = "attn" if p in cfg.attn_positions else "mamba"
        elif cfg.sliding_window and cfg.global_attn_positions:
            mixer = "attn" if p in cfg.global_attn_positions else "attn_local"
        else:
            mixer = "attn"
        if p in cfg.moa_positions:
            # MoA is an attention mixer: it cannot replace a state-space
            # scan and has no sliding-window variant.
            if mixer == "mamba":
                raise ValueError(
                    f"moa_positions={cfg.moa_positions}: position {p} is "
                    f"an ssm mixer in family {cfg.family!r}; MoA routes "
                    "attention head groups and cannot replace a state-"
                    "space scan (put MoA on an attn position)")
            if mixer == "attn_local":
                raise ValueError(
                    f"moa_positions={cfg.moa_positions}: position {p} is "
                    "a sliding-window local-attention layer; MoA has no "
                    "windowed variant (use a global_attn_positions slot)")
            if cfg.moa_experts < 2 or cfg.moa_k < 1 \
                    or cfg.moa_heads_per_expert < 1:
                raise ValueError(
                    "moa_positions set but moa_experts/moa_k/"
                    "moa_heads_per_expert are not configured "
                    f"(got {cfg.moa_experts}/{cfg.moa_k}/"
                    f"{cfg.moa_heads_per_expert})")
            mixer = "moa"
        if cfg.family == "ssm":
            ffn = "none"
        elif p in cfg.moe_positions:
            ffn = "moe+dense" if cfg.dense_residual else "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        kinds.append(LayerKind(mixer=mixer, ffn=ffn))
    return kinds


def n_periods(cfg: ModelConfig) -> tuple[int, int]:
    """(full stacked periods, remainder layers); every layer is a
    remainder layer without ``scan_layers``."""
    if not cfg.scan_layers:
        return 0, cfg.n_layers
    return divmod(cfg.n_layers, cfg.period)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return cfg.replace(**overrides) if overrides else cfg


def count_params(cfg: ModelConfig) -> dict:
    """Analytic parameter counts (total / active per token)."""
    d = cfg.d_model
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    total = emb = 2 * cfg.vocab_size * d
    active = emb
    gated = cfg.activation in ("swiglu", "geglu")
    per_pos_counts = []
    for kind in kinds:
        c_total = c_active = 0
        if kind.mixer in ("attn", "attn_local"):
            c = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
            c_total += c
            c_active += c
        elif kind.mixer == "moa":
            hg = cfg.moa_heads_per_expert * cfg.head_dim
            per_e = 2 * d * hg
            shared = 2 * d * max(cfg.n_kv_heads, 1) * cfg.head_dim + \
                d * cfg.moa_experts
            c_total += cfg.moa_experts * per_e + shared
            c_active += cfg.moa_k * per_e + shared
        elif kind.mixer == "mamba":
            d_in = cfg.ssm_expand * d
            r = -(-d // 16)
            c = (d * 2 * d_in + cfg.ssm_d_conv * d_in
                 + d_in * (r + 2 * cfg.ssm_d_state) + r * d_in
                 + d_in * cfg.ssm_d_state + d_in * d)
            c_total += c
            c_active += c
        if kind.ffn == "dense":
            c = d * cfg.d_ff * (3 if gated else 2)
            c_total += c
            c_active += c
        if kind.ffn in ("moe", "moe+dense"):
            per_e = d * cfg.moe_d_ff * (3 if gated else 2)
            c_total += cfg.n_experts * per_e
            c_active += cfg.moe_k * per_e
            if kind.ffn == "moe+dense":
                c = d * cfg.d_ff * (3 if gated else 2)
                c_total += c
                c_active += c
        per_pos_counts.append((c_total, c_active))
    for i, (ct, ca) in enumerate(per_pos_counts):
        reps = full + (1 if i < rem else 0)
        total += reps * ct
        active += reps * ca
    return {"total": total, "active": active,
            "total_excl_embed": total - emb,
            "active_excl_embed": active - emb}
