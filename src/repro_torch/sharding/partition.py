"""Logical-axis -> mesh-axis resolution (MaxText-style sharding rules),
counterpart of ``repro.sharding.partition``.

Every parameter / activation dimension carries a *logical* name
("embed", "experts", "batch", ...).  A :class:`ShardingRules` table maps
each logical name to zero or more mesh axes.  Resolution enforces
divisibility: a dimension that does not divide by the product of its
assigned mesh axes falls back to fewer axes (and finally to replication),
and the fallback is recorded, as in the reference.

A resolved spec is the port's own small type, :data:`Spec`: one tuple of
mesh-axis names per dimension (``()`` = replicated), where the reference
has a ``PartitionSpec``.  It is resolved against the axis sizes of a
mesh only: a ``torch.distributed`` ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or any mapping of axis name -> size.

Plans
-----
``PLANS`` holds the reference's named rule-sets, table for table:

* ``dp_tp_ep``     -- batch over (pod, data); tensor-parallel + expert-
                     parallel over model; FSDP of params over data.  The
                     default, and the modern mapping of the paper's
                     "data-parallel standard layers + model-parallel
                     experts" scheme (Sec. 3.1).
* ``dp_fsdp_ep``   -- as dp_tp_ep, the experts' d_model FSDP over data.
* ``dp_only``      -- pure data parallel (small models / baselines).
* ``prefill_tp``, ``dp_wide``, ``decode_std``, ``decode_long`` -- the
  serving and small-model plans.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.common.param import ParamDef, tree_map

# One tuple of mesh-axis names per dimension; () = replicated.
Spec = tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> tuple of mesh axis names (in priority order)."""
    table: Mapping[str, tuple[str, ...]]
    name: str = "custom"

    def lookup(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.table.get(logical, ()))


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_spec(rules: ShardingRules, mesh, shape: Sequence[int],
                 logical_axes: Sequence, fallbacks: list | None = None
                 ) -> Spec:
    """Resolve logical axes to a :data:`Spec`, enforcing divisibility.

    Mesh axes already claimed by an earlier dimension of the same tensor
    are skipped (one mesh axis shards at most one dimension).  A mesh
    axis that does not divide what is left of a dimension ends that
    dimension's axes and is recorded in ``fallbacks`` as ``(shape,
    logical, axis, dim)``, as the reference records it."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        want = [a for a in rules.lookup(logical)
                if a in sizes and a not in used]
        # Largest prefix of `want` whose product divides dim.
        chosen: list[str] = []
        prod = 1
        for a in want:
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
            else:
                if fallbacks is not None:
                    fallbacks.append((tuple(shape), logical, a, dim))
                break
        used.update(chosen)
        out.append(tuple(chosen))
    return tuple(out)


def tree_pspecs(rules: ShardingRules, mesh, def_tree,
                fallbacks: list | None = None):
    """:data:`Spec` tree for a ParamDef tree."""
    return tree_map(lambda d: resolve_spec(rules, mesh, d.shape, d.axes,
                                           fallbacks), def_tree)


# ---------------------------------------------------------------------------
# Named plans
# ---------------------------------------------------------------------------

def _plan(name, **table):
    return ShardingRules(table=table, name=name)


PLANS: dict[str, ShardingRules] = {
    # The workhorse: DP over (pod,data), TP/EP over model, FSDP over data.
    "dp_tp_ep": _plan(
        "dp_tp_ep",
        batch=("pod", "data"),
        # flattened token dim inside the MoE: sharded over EVERY axis —
        # the paper's §3.1 combined-batch trick (each expert's batch comes
        # from all data-parallel replicas; entry reshard is a free slice,
        # exit is one all-gather over model, and the k-way a2a shrinks by M).
        tokens=("pod", "data", "model"),
        seq=(),                    # sequence replicated in train/prefill
        kv_seq=(),                 # cache length replicated (short contexts)
        embed=(),                  # d_model activations replicated
        embed_fsdp=("data",),      # d_model *param* dim -> FSDP over data
        vocab=("model",),
        heads=("model",),
        kv_heads=("model",),
        head_dim=(),
        mlp=("model",),            # d_ff tensor-parallel
        experts=("model",),        # expert-parallel (paper §3.1)
        expert_capacity=(),
        expert_embed=(),           # expert d_model: unsharded (weights stay)
        expert_mlp=("data",),      # TP-within-expert over data: no per-
                                   # microbatch weight gathers (cf. FSDP)
        expert_groups=("model",),  # hierarchical MoE primary branch
        ssm_inner=("model",),      # mamba d_inner tensor-parallel
        ssm_state=(),
        conv=(),
        layers=(),                 # stacked-layer leading axis never sharded
    ),
    # Baseline variant for §Perf: experts FSDP over data (ZeRO-3-style
    # per-microbatch weight gathers) instead of expert-TP.  Measurably
    # collective-bound for kimi-k2; kept for the before/after comparison.
    "dp_fsdp_ep": _plan(
        "dp_fsdp_ep",
        batch=("pod", "data"),
        tokens=("pod", "data", "model"),
        seq=(), kv_seq=(),
        embed=(),
        embed_fsdp=("data",),
        vocab=("model",),
        heads=("model",), kv_heads=("model",), head_dim=(),
        mlp=("model",),
        experts=("model",),
        expert_capacity=("data",),
        expert_embed=("data",),    # ZeRO-3 experts
        expert_mlp=(),
        expert_groups=("model",),
        ssm_inner=("model",), ssm_state=(), conv=(), layers=(),
    ),
    # Pure data-parallel (paper's small baselines, CPU smoke tests).
    "dp_only": _plan(
        "dp_only",
        batch=("pod", "data", "model"),
        embed_fsdp=(),
        vocab=(), heads=(), kv_heads=(), mlp=(), experts=(),
        expert_mlp=(), expert_groups=(), ssm_inner=(),
    ),
    # Prefill: like dp_tp_ep but the MoE dispatch buffer's capacity axis
    # shards over data (a 1M-token prefill dispatch buffer is ~150 GB for
    # kimi-k2; train avoids this via microbatching, prefill cannot).
    "prefill_tp": _plan(
        "prefill_tp",
        batch=("pod", "data"),
        tokens=("pod", "data", "model"),
        seq=(), kv_seq=(),
        embed=(),
        embed_fsdp=("data",),
        vocab=("model",),
        heads=("model",), kv_heads=("model",), head_dim=(),
        mlp=("model",),
        experts=("model",),
        expert_capacity=("data",),
        expert_embed=(),
        expert_mlp=("data",),      # weights must shard over data too (a
                                   # 2 TB expert set cannot live 16-way)
        expert_groups=("model",),
        ssm_inner=("model",), ssm_state=(), conv=(), layers=(),
    ),
    # Small-model plan: no tensor parallelism at all — batch shards over
    # every axis, parameters replicated for compute (FSDP storage over
    # data).  The §Perf fix for archs whose head counts cannot split the
    # model axis (smollm's 9 heads).
    "dp_wide": _plan(
        "dp_wide",
        batch=("pod", "data", "model"),
        tokens=("pod", "data", "model"),
        seq=(), kv_seq=(),
        embed=(),
        embed_fsdp=("data",),
        vocab=(),
        heads=(), kv_heads=(), head_dim=(),
        mlp=(),
        experts=(),
        expert_capacity=("data", "model"),
        expert_embed=(), expert_mlp=(),
        expert_groups=(),
        ssm_inner=(), ssm_state=(), conv=(), layers=(),
    ),
    # Standard decode (decode_32k): weight-gathering FSDP is wrong for
    # decode (one gather per generated token), so weights live sharded:
    # experts over model + within-expert d_ff tensor-parallel over data.
    # KV caches shard batch over (pod,data) and sequence over model
    # (flash-decoding style; GQA kv_heads often don't divide the model
    # axis, the sequence always does).
    "decode_std": _plan(
        "decode_std",
        batch=("pod", "data"),
        tokens=("pod", "data"),
        seq=(),
        kv_seq=("model",),
        embed=(),
        embed_fsdp=(),
        vocab=("model",),
        heads=("model",),
        kv_heads=(),
        head_dim=(),
        mlp=("model",),
        experts=("model",),
        expert_capacity=(),
        expert_embed=(),
        expert_mlp=("data",),      # TP-within-expert instead of FSDP
        expert_groups=("model",),
        ssm_inner=("model",),
        ssm_state=(),
        conv=(),
        layers=(),
    ),
    # Long-context decode: B=1 cannot shard; shard the cache sequence axis
    # over (data, model) instead.
    "decode_long": _plan(
        "decode_long",
        batch=(),
        tokens=(),
        seq=(),
        kv_seq=("data", "model"),
        embed=(),
        embed_fsdp=(),
        vocab=("model",),
        heads=("model",),
        kv_heads=(),
        head_dim=(),
        mlp=("model",),
        experts=("model",),
        expert_capacity=(),
        expert_embed=(),
        expert_mlp=("data",),
        expert_groups=("model",),
        ssm_inner=("model",),
        ssm_state=(),
        conv=(),
        layers=(),
    ),
}


def plan_for(shape_name: str) -> str:
    """Pick the sharding plan for a named input-shape kind."""
    if shape_name.startswith("long"):
        return "decode_long"
    if shape_name.startswith("decode"):
        return "decode_std"
    if shape_name.startswith("prefill"):
        return "prefill_tp"
    return "dp_tp_ep"
