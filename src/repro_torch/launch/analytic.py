"""Analytic per-device FLOPs / HBM bytes / collective wire bytes
(counterpart of ``repro.launch.analytic``).

Arithmetic on the host: it reads a config, a :class:`ShapeSpec`, the
axis sizes of a mesh (a ``DeviceMesh`` or an ``{axis: size}`` mapping,
through ``partition.axis_sizes``: no process group) and a sharding plan,
and allocates nothing.

Counting conventions (the reference's)
--------------------------------------
* 1 MAC = 2 FLOPs; matmul [m,k]x[k,n] = 2mkn.
* Backward = 2x forward matmul FLOPs; remat recompute adds 1x => train
  multiplier 4 on rematerialized segments (every block and the chunked
  xent).  Flash attention's backward recomputes the scores in its dq
  and its dk / dv passes: multiplier 5 on score FLOPs.  Score FLOPs run
  over ``S/2 + kv_block`` positions a query (``FlashAttentionFn`` skips
  the blocks the causal mask hides).
* Sharding: each op's FLOPs divide by the mesh axes that shard it,
  resolved through ``partition.resolve_spec`` with its divisibility
  fallbacks.
* MoE expert FLOPs are charged on capacity slots (E x C), not on routed
  tokens: the padding of capacity-factor dispatch is real work.
* Wire bytes are ring-algorithm bytes a device sends: (g-1)/g of an
  all-gather's result (g-1 times its input), 2(g-1)/g of an
  all-reduce's tensor, (g-1)/g of an all-to-all's buffer.
* Element sizes come from ``cfg.compute_dtype``; a mamba state is f32.

Three charges follow what the port runs, not what the reference
charges:

* Train wire: the MoE exchanges its dispatch buffer in two all-to-alls
  (``core/expert_parallel.py::moe_apply_ep``), the reference's branch
  without wide dispatch, which the port does not have.  The dense
  layers' tensor-parallel all-reduces are the port's
  (``_dense_tp_wire``): only where a microbatch's rows are whole over
  ``model``, remat's recompute of attention's exit included, the
  embedding's and the loss's too, and none for a mamba mixer (the
  reference charges attention, mamba and the dense FFN two each on
  every cell).
* Prefill / decode wire: serving runs ``moe_apply_serve``; the engine
  and the decode step keep every weight but the experts' whole on every
  rank, so no dense layer of theirs all-reduces a tensor-parallel
  output.  A prefill step whose rows do not divide over the ranks holds
  them whole over the axes outside the ``batch`` axes (``model``;
  ``MeshContext.split_rows``), and there its dense layers run
  tensor-parallel over those axes where their dim divides
  (``MeshContext.tp_axes``): each attention and dense FFN layer
  all-reduces its ``[rows, S, d]`` output, the embedding its ``[rows,
  S, d]`` lookup, and the last logits ``[rows, V / g]`` (f32) are
  all-gathered (``_dense_tp_wire``).  The flat MoE's experts are a
  rank's block over ``experts`` x ``expert_mlp`` (the reference's
  layout).  A decode step all-gathers its rows (and their routing mask)
  over the batch axes, and each MoE layer all-reduces its d_ff slice's
  f32 partial sums ``[E/g, C, d]`` over the ``expert_mlp`` axes (where
  they split d_ff) and all-gathers its expert outputs over the expert
  axis, or, fused, all-reduces the f32 partial sums of its experts
  over both (``_all_reduce_share``: one group where they are every
  axis with more than one device).  Decode attention
  over a cache whose sequence is sharded
  (``attention.attend_cached_sharded``) all-gathers three f32 tensors:
  the ranks' score maxima, their exponential sums (each [B, H]) and
  their weighted values ([B, H, hd]).
* Prefill / decode weight bytes of an MoE layer: the serving MoE routes
  the step's rows of every rank in one plan, and its GMM (``rows``) and
  the fused kernels read no expert the plan leaves empty; so a step
  reads at most ``min(E, k x T)`` experts for its T routed tokens, not
  all E.  The resident estimate still holds every expert.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig, layer_kinds, n_periods
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.dispatch import capacity_for
from repro_torch.sharding import partition

F32_BYTES = 4


def cfg_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                     batch_shards: int = 16) -> int:
    """Gradient-accumulation depth for train cells: the per-device
    microbatch capped at ~4k tokens.  Each microbatch's global batch must
    stay divisible by the batch sharding, so mb is the largest power of
    two dividing B / batch_shards under the token cap."""
    if shape.kind != "train":
        return 1
    seqs_per_shard = max(shape.global_batch // batch_shards, 1)
    tokens_loc = seqs_per_shard * shape.seq_len
    mb = 1
    while (mb * 2 <= seqs_per_shard and seqs_per_shard % (mb * 2) == 0
           and tokens_loc // mb > 4096):
        mb *= 2
    return mb


@dataclasses.dataclass
class Analytic:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    wire_bytes_per_dev: float
    detail: dict


def _shards(rules, sizes: dict, shape, axes) -> int:
    """Number of devices the given tensor is split across."""
    spec = partition.resolve_spec(rules, sizes, shape, axes)
    return math.prod(sizes[ax] for entry in spec for ax in entry)


def _dim_shards(rules, sizes: dict, shape, axes, dim: int) -> int:
    """Number of devices dimension ``dim`` of the tensor is split across."""
    spec = partition.resolve_spec(rules, sizes, shape, axes)
    return math.prod(sizes[ax] for ax in spec[dim])


def _all_reduce_share(sizes: dict, axes) -> float:
    """Ring bytes a device sends a byte of a tensor all-reduced over the
    mesh axes ``axes``, as ``MeshContext.all_reduce`` groups them: one
    group where they are every axis with more than one device, else one
    all-reduce an axis, in turn."""
    spread = [a for a in axes if sizes[a] > 1]
    if set(spread) == {a for a, n in sizes.items() if n > 1}:
        n = math.prod(sizes[a] for a in spread)
        return 2 * (n - 1) / n
    return sum(2 * (sizes[a] - 1) / sizes[a] for a in spread)


def _dense_tp_wire(cfg: ModelConfig, rules, sizes: dict, kind: str,
                   rows: int, seq: int, mbs: int, bytes_p: int) -> float:
    """Ring bytes a device sends for the dense layers run
    tensor-parallel (the module docstring): each of the ``mbs``
    (micro)batches of ``rows / mbs`` rows that do not divide over the
    devices splits over the largest prefix of the ``batch`` axes that
    divides it and stays whole over the others, over which each dense
    dim that resolves there runs tensor-parallel.  Each attention layer
    and dense FFN all-reduces its ``[rows_local, S, d]`` output once in
    a prefill; a training step does so forward and backward, and remat's
    recompute of a stacked period's layer re-runs attention's exit (it
    stops before the FFN's).  The vocabulary: the embedding's lookup
    (and its cotangent); a prefill's last logits ``[rows_local, V / g]``
    f32 all-gathered; a training step's loss chunks' f32 max (forward,
    recompute) and packed sums (forward, recompute, backward),
    ``[rows_local, chunk]`` and ``[2, rows_local, chunk]``."""
    rows_mb = rows // mbs
    if rows_mb % math.prod(sizes.values()) == 0:
        return 0.0
    row_axes = partition.resolve_spec(rules, sizes, (rows_mb,),
                                      ("batch",))[0]
    whole = {a for a in sizes if a not in row_axes}
    rows_loc = rows_mb / math.prod(sizes[a] for a in row_axes)

    def tp(logical: str, size: int) -> tuple:
        axes = partition.resolve_spec(rules, sizes, (size,), (logical,))[0]
        return axes if size and axes and set(axes) <= whole else ()
    train = kind == "train"
    passes = 2 if train else 1
    exit_bytes = rows_loc * seq * cfg.d_model * bytes_p
    wire = 0.0
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    for pos, lk in enumerate(kinds):
        r = full + (1 if pos < rem else 0)
        if lk.mixer in ("attn", "attn_local"):
            calls = r * passes + (full if train and cfg.remat else 0)
            wire += calls * _all_reduce_share(
                sizes, tp("heads", cfg.n_heads)) * exit_bytes
        if lk.ffn in ("dense", "moe+dense"):
            wire += r * passes * _all_reduce_share(
                sizes, tp("mlp", cfg.d_ff)) * exit_bytes
    vocab = tp("vocab", cfg.vocab_size)
    if vocab:
        share = _all_reduce_share(sizes, vocab)
        wire += passes * share * exit_bytes
        if train:
            wire += share * (2 + 3 * 2) * rows_loc * seq * F32_BYTES
        else:
            g = math.prod(sizes[a] for a in vocab)
            wire += (g - 1) * rows_loc * (cfg.vocab_size / g) * F32_BYTES
    return mbs * wire


def analyze_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 plan: str) -> Analytic:
    """Per-device FLOPs, HBM bytes and wire bytes of one step of
    ``shape`` on ``mesh`` (a ``DeviceMesh`` or ``{axis: size}``) under
    the sharding plan ``plan``."""
    rules = partition.PLANS[plan]
    sizes = partition.axis_sizes(mesh)
    kind = shape.kind
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    P, D, M = (sizes.get(a, 1) for a in ("pod", "data", "model"))

    def msh(shape_, axes_):   # shard count helper
        return _shards(rules, sizes, shape_, axes_)

    # --- token/batch sharding ------------------------------------------
    batch_shards = msh((B,), ("batch",))
    tokens_global = B * S if kind != "decode" else B
    tokens_loc = tokens_global / batch_shards
    # decode processes 1 position; "S" is the cache/history length.
    seq_for_attn = S

    gated = cfg.activation in ("swiglu", "geglu")
    n_mat = 3 if gated else 2
    mult = {"train": 4.0, "prefill": 1.0, "decode": 1.0}[kind]
    bytes_p = torch.empty((), dtype=cfg.compute_dtype).element_size()

    flops = 0.0
    hbm = 0.0
    wire = 0.0

    # --- per-layer-position costs ---------------------------------------
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    reps = [full + (1 if i < rem else 0) for i in range(cfg.period)]

    layer_flops = layer_wire = layer_hbm = 0.0
    params_local_bytes = 0.0       # all params, local shard
    fsdp_local_bytes = 0.0         # subset whose d_model dim is FSDP-sharded
    unread_bytes = 0.0             # local expert bytes a serving step skips
    act_bytes = 0.0
    mbs = max(cfg_microbatches(cfg, shape, batch_shards), 1) \
        if kind == "train" else 1
    fsdp_on = "data" in rules.lookup("embed_fsdp") and D > 1
    if kind == "decode":
        # The decode step's rows (and their f32 routing mask) gathered
        # over the batch axes before each MoE layer routes them.
        rows_wire = (batch_shards - 1) * tokens_loc * (d * bytes_p
                                                       + F32_BYTES)
    else:
        rows_wire = 0.0
    if kind != "decode":
        wire += _dense_tp_wire(cfg, rules, sizes, kind, B, S, mbs, bytes_p)

    for pos, lk in enumerate(kinds):
        r = reps[pos]
        if r == 0:
            continue
        f = w = h = 0.0   # per-step totals for this position (all reps)
        p_loc = 0.0       # local param bytes for this position (all reps)
        p_fsdp = 0.0      # portion that FSDP must gather per microbatch

        if lk.mixer in ("attn", "attn_local"):
            H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            if cfg.pad_attn_heads > H:
                H = KV * (-(-cfg.pad_attn_heads // KV))
            # compute shards = activation (head) sharding; FSDP shards only
            # weight *storage*, the gathered weight computes everywhere.
            m_h = max(msh((B, S, H, hd), ("batch", None, "heads", None))
                      / batch_shards, 1)
            m_kvh = max(msh((B, S, KV, hd),
                            ("batch", None, "kv_heads", None))
                        / batch_shards, 1)
            proj = (2 * d * hd * (2 * H) / m_h
                    + 2 * d * hd * (2 * KV) / m_kvh)
            f += mult * proj * tokens_loc * r
            # score/pv flops: per (token, kv position, head) 4*hd FLOPs.
            if lk.mixer == "attn_local" and cfg.sliding_window:
                kv_eff = min(cfg.sliding_window + cfg.kv_block, seq_for_attn)
            elif kind == "decode":
                kv_eff = seq_for_attn
            else:
                kv_eff = seq_for_attn / 2 + cfg.kv_block
            score_mult = mult + 1 if kind == "train" else mult
            f += score_mult * 4 * hd * H * kv_eff / m_h * tokens_loc * r
            # params
            p = d * hd * (2 * H + 2 * KV) * bytes_p
            p_here = r * (p / msh((d, H, hd),
                                  ("embed_fsdp", "heads", "head_dim")))
            p_loc += p_here
            p_fsdp += p_here if fsdp_on else 0.0
            # decode: read the KV cache once per step
            if kind == "decode":
                if lk.mixer == "attn_local" and cfg.sliding_window:
                    cache_len = min(cfg.sliding_window, S)
                else:
                    cache_len = S
                cache_shape = (B, cache_len, KV, hd)
                cache_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
                cache = B * cache_len * KV * hd * bytes_p * 2
                h += r * cache / msh(cache_shape, cache_axes)
                # attend_cached_sharded's gathers: maxima and sums
                # [B, H] and weighted values [B, H, hd], f32.
                g_seq = _dim_shards(rules, sizes, cache_shape, cache_axes, 1)
                w += r * (g_seq - 1) * (B / batch_shards) * H * (2 + hd) \
                    * F32_BYTES
            act = tokens_loc * (2 * d + (H + 2 * KV) * hd / max(m_h, 1)) \
                * bytes_p
            act_bytes += r * act if kind != "decode" else 0.0

        elif lk.mixer == "mamba":
            d_in = cfg.ssm_expand * d
            rr = -(-d // 16)
            N = cfg.ssm_d_state
            m_i = max(msh((B, S, d_in), ("batch", None, "ssm_inner"))
                      / batch_shards, 1)
            per_tok = (2 * d * 2 * d_in + 2 * cfg.ssm_d_conv * d_in
                       + 2 * d_in * (rr + 2 * N) + 2 * rr * d_in
                       + 10 * d_in * N + 2 * d_in * N + 2 * d_in * d)
            f += mult * per_tok / m_i * tokens_loc * r
            p = (d * 2 * d_in + cfg.ssm_d_conv * d_in
                 + d_in * (rr + 2 * N) + rr * d_in + d_in * N + d_in * d) \
                * bytes_p
            p_here = r * p / msh((d, 2 * d_in), ("embed_fsdp", "ssm_inner"))
            p_loc += p_here
            p_fsdp += p_here if fsdp_on else 0.0
            if kind == "decode":
                st = B * d_in * N * F32_BYTES * 2
                h += r * st / msh((B, d_in, N),
                                  ("batch", "ssm_inner", "ssm_state"))
            m_act = msh((tokens_global, d_in), (None, "ssm_inner"))
            act_bytes += r * tokens_loc * (2 * d + 6 * d_in / m_act) \
                * bytes_p

        if lk.ffn in ("dense", "moe+dense"):
            m_f = max(msh((B, S, cfg.d_ff), ("batch", None, "mlp"))
                      / batch_shards, 1)
            f += mult * 2 * d * cfg.d_ff * n_mat / m_f * tokens_loc * r
            p = d * cfg.d_ff * n_mat * bytes_p
            p_here = r * p / msh((d, cfg.d_ff), ("embed_fsdp", "mlp"))
            p_loc += p_here
            p_fsdp += p_here if fsdp_on else 0.0
            act_bytes += r * tokens_loc * (d + cfg.d_ff / m_f) * bytes_p

        if lk.ffn in ("moe", "moe+dense"):
            E, k, ff = cfg.n_experts, cfg.moe_k, cfg.moe_d_ff
            toks_for_cap = int(tokens_global) // mbs
            cap = capacity_for(toks_for_cap, E, k, cfg.capacity_factor)
            slots = E * cap
            m_e = msh((E, d, ff), ("experts", "expert_embed", "expert_mlp"))
            cap_shards = msh((E, cap, ff),
                             ("experts", "expert_capacity", "expert_mlp"))
            f += mult * 2 * d * ff * n_mat * slots * mbs / cap_shards * r
            # gating
            f += mult * 2 * d * E * tokens_loc * r
            p = E * d * ff * n_mat * bytes_p
            p_here = r * p / m_e
            p_loc += p_here
            p_fsdp += p_here if (fsdp_on and "data" in
                                 rules.lookup("expert_embed")) else 0.0
            if kind == "train":
                # expert-TP over data: partial-sum reduce of the expert
                # output buffer per microbatch, each pass.
                if "data" in rules.lookup("expert_mlp") and D > 1:
                    buf_dev = slots / max(msh((E, cap, d),
                                              ("experts", "expert_capacity",
                                               None)), 1) * d * bytes_p
                    w += 3 * (buf_dev * (D - 1) / D * mbs) * r
                # moe_apply_ep: the dispatch buffer to the experts' ranks
                # and back, each pass.
                a2a = k * tokens_loc * d * bytes_p * cfg.capacity_factor \
                    * (M - 1) / M
                w += 2 * 2 * a2a * r
            else:
                # moe_apply_serve: one plan over tokens_global tokens;
                # each rank runs its experts' d_ff slice.  Unfused, the
                # slice's f32 partial sums are all-reduced over the
                # expert_mlp axes, then the experts' outputs gathered
                # over the expert axis; fused, the f32 partial outputs
                # are all-reduced over both.
                e_ax, _, f_ax = partition.resolve_spec(
                    rules, sizes, (E, d, ff),
                    ("experts", "expert_embed", "expert_mlp"))
                g_e = math.prod(sizes[a] for a in e_ax)
                d_e = math.prod(sizes[a] for a in f_ax)
                f_ax = f_ax if d_e > 1 else ()
                if kind == "decode" and cfg.fused_decode:
                    w += r * _all_reduce_share(sizes, e_ax + f_ax) \
                        * tokens_global * d * F32_BYTES
                else:
                    w += r * (g_e - 1) * (E / g_e) * cap * d * bytes_p
                    w += r * _all_reduce_share(sizes, f_ax) * (E / g_e) \
                        * cap * d * F32_BYTES
                w += r * rows_wire
                unread_bytes += p_here * (1 - min(E, k * tokens_global) / E)
            act_bytes += r * (slots * mbs / cap_shards) * (2 * d + ff) \
                * bytes_p

        layer_flops += f
        layer_wire += w
        layer_hbm += h
        params_local_bytes += p_loc
        fsdp_local_bytes += p_fsdp

    # --- embedding / unembedding ----------------------------------------
    m_v_store = msh((d, cfg.vocab_size), ("embed_fsdp", "vocab"))
    m_v = max(msh((B, S, cfg.vocab_size), ("batch", None, "vocab"))
              / batch_shards, 1)
    emb_p = 2 * cfg.vocab_size * d * bytes_p
    params_local_bytes += emb_p / m_v_store
    if kind == "train":
        flops += 4.0 * 2 * d * cfg.vocab_size / m_v * tokens_loc
    else:
        # prefill computes last-position logits only; decode all positions.
        flops += 2 * d * cfg.vocab_size / m_v * (B / batch_shards)
    flops += layer_flops
    wire += layer_wire
    hbm += layer_hbm

    # --- FSDP weight gathers + grad reduce-scatter (train) ---------------
    if kind == "train":
        emb_fsdp = (emb_p / m_v_store) if fsdp_on else 0.0
        fsdp_bytes = fsdp_local_bytes + emb_fsdp
        if fsdp_on:
            # Per microbatch: all-gather fwd + remat-recompute gather +
            # reduce-scatter grads (grads at param dtype, EF/accum local).
            gathered = fsdp_bytes * (D - 1)
            wire += mbs * 3 * gathered
        if P > 1:
            wire += 2 * (P - 1) / P * params_local_bytes * 2  # pod grad AR
        # HBM: params r/w + f32 grads + factored opt (negligible) + acts.
        hbm += 6 * params_local_bytes + act_bytes * 2.5
    elif kind == "prefill":
        hbm += params_local_bytes - unread_bytes + act_bytes
    else:
        hbm += params_local_bytes - unread_bytes  # every weight read once

    # --- resident HBM estimate --------------------------------------------
    cache_local = 0.0
    if kind != "train":
        for pos, lk in enumerate(kinds):
            r = reps[pos]
            if lk.mixer in ("attn", "attn_local"):
                L = min(cfg.sliding_window, S) \
                    if (lk.mixer == "attn_local" and cfg.sliding_window) \
                    else S
                sh = msh((B, L, cfg.n_kv_heads, cfg.head_dim),
                         ("batch", "kv_seq", "kv_heads", "head_dim"))
                cache_local += r * 2 * B * L * cfg.n_kv_heads \
                    * cfg.head_dim * bytes_p / sh
            elif lk.mixer == "mamba":
                d_in = cfg.ssm_expand * d
                sh = msh((B, d_in, cfg.ssm_d_state),
                         ("batch", "ssm_inner", "ssm_state"))
                cache_local += r * (B * d_in * cfg.ssm_d_state * F32_BYTES
                                    + B * (cfg.ssm_d_conv - 1) * d_in
                                    * bytes_p) / sh
    if kind == "train":
        # params + f32 grads + factored opt (~1% of grads) + layer carries
        # of ONE microbatch (grad accumulation over cfg_microbatches).
        carries = cfg.n_layers * (tokens_loc / mbs) * d * bytes_p
        resident = params_local_bytes * (1 + 2 + 0.05) + carries * 2
    elif kind == "prefill":
        # no backward: the working set is a few layers' activations, not
        # the whole stack's.
        per_layer = act_bytes / max(cfg.n_layers, 1)
        resident = params_local_bytes + cache_local + 4 * per_layer
    else:
        resident = params_local_bytes + cache_local  # updated in place

    return Analytic(
        flops_per_dev=flops, hbm_bytes_per_dev=hbm,
        wire_bytes_per_dev=wire,
        detail={
            "tokens_local": tokens_loc,
            "params_local_bytes": params_local_bytes,
            "activation_bytes": act_bytes,
            "cache_local_bytes": cache_local,
            "resident_bytes_per_dev": resident,
            "batch_shards": batch_shards,
        })
