"""Ranks of the port's distributed CPU tests (gloo, spawned processes).

    python tests/torch_dist_workers.py <case> <dir> <world> <data> <model>

spawns ``world`` ranks with ``torch.multiprocessing`` over gloo, a
``file://`` store in ``<dir>`` (never a fixed port: the tests run in
parallel workers), and the host mesh (data, model).  Each rank runs
``CASES[case]``: it reads ``<dir>/inputs.pt`` (written by the test, which
runs the JAX side in its own process) and writes ``<dir>/out<rank>.pt``.
This module imports the port only.  A rank that raises makes the
command exit non-zero.
"""
from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.common.param import tree_leaves, tree_map
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.core import moe as moe_lib
from repro_torch.core import router as router_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, paper_lm
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.context import MeshContext
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import compression
from repro_torch.train import trainer as trainer_lib


def _full(ctx: MeshContext, tree, defs):
    """The full tree of this rank's slices (no autograd)."""
    with torch.no_grad():
        return tree_map(lambda t: t.detach().clone(), ctx.gather(tree, defs))


def _grad_leaves(tree):
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    return tree


# ---------------------------------------------------------------------------
# the expert-parallel MoE
# ---------------------------------------------------------------------------

def _moe_case(ctx: MeshContext, case: dict) -> dict:
    """One moe_apply_ep call: the rank's rows of ``x`` (and of the noise),
    the parameters sharded by the plan and the gate gathered, as the
    trainer hands them; the global loss ``sum(y * dy) + aux_loss`` back-
    propagated as a sum over the ranks (each rank's own ``sum(y * dy)``
    and 1/n of the aux loss that every rank holds), the replicas'
    gradients summed.  Returns the rank's y, aux, metrics and the full
    gradients of the parameters and of x."""
    a = moe_lib.MoEArgs(**case["args"])
    defs = moe_lib.moe_defs(a)
    local = _grad_leaves(ctx.shard(case["params"], defs))
    used = ep_lib.gather_on_use(local, defs, ctx)
    x = ctx.local_rows(case["x"]).clone().requires_grad_(True)
    noise = case.get("noise")
    y, aux = ep_lib.moe_apply_ep(
        used, x, a, ctx, train=case["train"],
        noise=None if noise is None else ctx.local_rows(noise))
    dy = ctx.local_rows(case["dy"])
    loss = torch.sum(y * dy) + aux["aux_loss"] / ctx.world
    loss.backward()
    grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                else p.grad), local)
    trainer_lib._sum_replicas(ctx, grads, ctx.specs(defs))
    out = {"y": y.detach(), "aux_loss": aux["aux_loss"].detach(),
           "metrics": {k: v.detach() for k, v in aux["metrics"].items()},
           "grads": _full(ctx, grads, defs), "dx": x.grad}
    if case.get("local_aux"):
        # The shard-local balance loss of the rank's tokens alone.
        dec = router_lib.build(a).route(used, x.detach(), train=False)
        out["local_aux"] = dec.aux_loss.detach()
    return out


def _refusals(ctx: MeshContext, inputs: dict) -> dict:
    """Experts that do not divide over the expert axis raise a
    ValueError on this mesh, and so does a pipelined config of period 2
    (the reference's refusal); the message of each."""
    got = {}

    def expect(name, fn, error=NotImplementedError):
        try:
            fn()
        except error as err:
            got[name] = str(err)
        else:
            got[name] = None

    moe = next(iter(inputs["moe_cases"].values()))
    a = moe_lib.MoEArgs(**moe["args"])
    defs = moe_lib.moe_defs(a)
    used = ep_lib.gather_on_use(ctx.shard(moe["params"], defs), defs, ctx)
    x = ctx.local_rows(moe["x"])
    odd = ctx.size(["model"]) + 1
    expect("indivisible_experts", lambda: ep_lib.moe_apply_ep(
        {}, x, moe_lib.MoEArgs(**dict(moe["args"], n_experts=odd)), ctx,
        train=False), error=ValueError)
    from repro_torch.train import pipeline as pp_lib
    for name, cfg in inputs["pipeline_refusals"].items():
        expect(name, lambda: pp_lib.pipeline_lm_loss(
            {}, inputs["batch"], cfg, ctx=ctx, n_stages=ctx.sizes["data"],
            n_micro=2), error=ValueError)
    return got


def _lm_eval(ctx: MeshContext, case: dict) -> dict:
    """lm_loss (train=False) on this mesh from the rank's parameter
    slices and batch rows: the rank's metrics."""
    cfg = case["cfg"]
    local = ctx.shard(case["params"], lm.lm_defs(cfg))
    batch = {k: ctx.local_rows(v) for k, v in case["batch"].items()}
    with torch.no_grad():
        _, metrics = lm.lm_loss(local, batch, cfg, train=False, ctx=ctx)
    return {k: float(v) for k, v in metrics.items()}


def _fused_decode(ctx: MeshContext, case: dict) -> dict:
    """A decode-shaped eval call of moe_apply_ep with fused_decode on this
    mesh: the rank's rows of y and the global plan's telemetry."""
    a = moe_lib.MoEArgs(**dict(case["args"], fused_decode=True))
    defs = moe_lib.moe_defs(a)
    used = ep_lib.gather_on_use(ctx.shard(case["params"], defs), defs, ctx)
    with torch.no_grad():
        y, aux = ep_lib.moe_apply_ep(used, ctx.local_rows(case["x"]), a, ctx,
                                     train=False,
                                     mask=ctx.local_rows(case["mask"]))
    return {"y": y, "telemetry": aux["telemetry"]}


def case_moe(ctx: MeshContext, inputs: dict) -> dict:
    out = {name: _moe_case(ctx, case)
           for name, case in inputs["moe_cases"].items()}
    out["refusals"] = _refusals(ctx, inputs)
    out["pipeline"] = case_pipeline(ctx, {"cases": inputs["pipeline"]})
    out["lm_eval"] = {name: _lm_eval(ctx, case)
                      for name, case in inputs["lm_eval"].items()}
    out["fused_decode"] = _fused_decode(ctx, inputs["fused_case"])
    out["serve_logits"] = {name: _routed_logits(ctx, case)
                           for name, case in inputs["serve_logits"].items()}
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _loss_fn(model: dict, ctx, draws=None):
    cfg = model["cfg"]
    fn = lm.lm_loss if model["kind"] == "lm" else paper_lm.paper_lm_loss
    if draws is not None:
        return lambda p, b, g: fn(p, b, cfg, draws=draws, ctx=ctx)
    return lambda p, b, g: fn(p, b, cfg, generator=g, ctx=ctx)


def _defs(model: dict):
    if model["kind"] == "lm":
        return lm.lm_defs(model["cfg"])
    return paper_lm.paper_lm_defs(model["cfg"])


def case_train(ctx: MeshContext, inputs: dict) -> dict:
    """For each model: step 0's gradients and metrics from the JAX draws
    (full gradients); each ``(optimizer, steps)`` of ``opts`` applied
    ``steps`` times to the shards of the given full ``grads`` (the full
    parameters and grad norms after them); then the factored optimizer's
    first ``steps`` training steps from the step generators (losses,
    full parameters), checkpointed under ``ckpt`` for ``ckpt_model``."""
    out = {}
    for name, model in inputs["models"].items():
        defs = _defs(model)
        local = _grad_leaves(ctx.shard(model["params"], defs))
        grads_fn = trainer_lib.make_grad_fn(
            _loss_fn(model, ctx, draws=model["jax_draws"]), ctx=ctx,
            defs=defs)
        grads, metrics = grads_fn(local, model["batches"][0], None)
        res = {"grads0": _full(ctx, grads, defs),
               "metrics0": {k: v.detach() for k, v in metrics.items()}}
        for oc, n_steps in model["opts"]:
            local = ctx.shard(model["params"], defs)
            grads = ctx.shard(model["grads"], defs)
            state = opt_lib.init(local, oc)
            norms = [float(opt_lib.apply_updates(
                local, grads, state, oc, ctx=ctx, defs=defs)[2]["grad_norm"])
                for _ in range(n_steps)]
            res[oc.kind] = {"grad_norms": norms,
                            "params": _full(ctx, local, defs)}
        oc, n_steps = model["opts"][0]
        local = _grad_leaves(ctx.shard(model["params"], defs))
        state = {"params": local, "opt": opt_lib.init(local, oc)}
        step = trainer_lib.make_train_step(_loss_fn(model, ctx), oc,
                                           ctx=ctx, defs=defs)
        losses = []
        for i, batch in enumerate(model["batches"][:n_steps]):
            gen = torch.Generator().manual_seed(trainer_lib.step_seed(0, i))
            state, m = step(state, batch, gen)
            losses.append(float(m["loss"]))
        res["steps"] = {"losses": losses,
                        "params": _full(ctx, state["params"], defs)}
        if name == inputs.get("ckpt_model"):
            sdefs = {"params": defs, "opt": opt_lib.state_defs(defs, oc)}
            mgr = ckpt_lib.CheckpointManager(inputs["ckpt"])
            mgr.save(n_steps, state, {"mesh": dict(ctx.sizes)}, ctx=ctx,
                     defs=sdefs)
            res["state"] = _full(ctx, state, sdefs)
        out[name] = res
    return out


def case_restore(ctx: MeshContext, inputs: dict) -> dict:
    """The checkpoint restored on this mesh: this rank's slices (their
    shapes) and the full tree gathered from them; then the int8
    error-feedback sync over every rank of one gradient a step,
    ``ef_grads[step, rank]``, with the feedback carried across steps."""
    model = inputs["model"]
    defs = _defs(model)
    sdefs = {"params": defs, "opt": opt_lib.state_defs(defs, inputs["oc"])}
    mgr = ckpt_lib.CheckpointManager(inputs["ckpt"])
    tree, extra, step = mgr.restore(mgr.latest_step(), sdefs, ctx=ctx)
    out = {"step": step, "extra": extra,
           "local_shapes": tree_map(lambda t: tuple(t.shape), tree),
           "full": _full(ctx, tree, sdefs)}
    ef = None
    synced = []
    for g in inputs["ef_grads"]:
        grads = {"g": g[ctx.index()]}
        ef = compression.init_ef_state(grads) if ef is None else ef
        mean, ef = compression.ef_compress_sync(grads, ef)
        synced.append(mean["g"])
    out["ef"] = {"synced": torch.stack(synced), "ef": ef["g"]}
    return out


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------

def case_serve(ctx: MeshContext, inputs: dict) -> dict:
    """Each serving case: the rank's engine (``ServeEngine(ctx=)``, the
    parameters sliced by the decode plan) on the case's trace; its
    greedy streams, stats, the shapes of its pool's leaves (the first
    one's apart) and of a page relaid onto the decode plan."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    out = {}
    for name, case in inputs["cases"].items():
        cfg = case["cfg"]
        sc = ServeConfig(**case["sc"])
        local = ctx.with_plan(sc.decode_plan).shard(case["params"],
                                                    lm.lm_defs(cfg))
        eng = ServeEngine(local, cfg, sc, device="cpu", ctx=ctx)
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in case["trace"]]
        eng.run()
        page = eng.kv.reshard(eng.kv.new_page())
        out[name] = {
            "streams": [list(r.tokens) for r in reqs],
            "done": all(r.done for r in reqs), "stats": dict(eng.stats),
            "pool_shape": tuple(tree_leaves(eng.kv.cache)[0].shape),
            "pool_shapes": [tuple(t.shape)
                            for t in tree_leaves(eng.kv.cache)],
            "page_shape": tuple(tree_leaves(page)[0].shape),
            "slot_axes": eng.kv.slot_axes, "seq_axes": eng.kv.seq_axes}
    return out


# The ring bytes a rank sends of a collective's tensor in a group of g
# (launch/analytic.py's convention): g - 1 x an all-gather's input,
# 2 (g - 1) / g x an all-reduce's tensor, (g - 1) / g x an all-to-all's.
_RING_SHARE = {"all_gather": lambda g: g - 1,
               "all_reduce": lambda g: 2 * (g - 1) / g,
               "all_to_all_single": lambda g: (g - 1) / g}


def case_decode_wire(ctx: MeshContext, inputs: dict) -> dict:
    """Each case: the rank's engine on the case's trace, with the ring
    bytes this rank sends of every collective's tensor summed inside
    ``lm.lm_decode`` calls (``_RING_SHARE`` of its group's size);
    returns those bytes and the number of calls (one a decode step)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    real = {n: getattr(dist, n) for n in _RING_SHARE}
    real_decode = lm.lm_decode
    seen = {"on": False}

    def counted(name):
        def call(*args, **kw):
            if seen["on"]:
                t = args[0] if name == "all_reduce" else args[1]
                g = dist.get_world_size(kw.get("group"))
                seen["bytes"] += (t.numel() * t.element_size()
                                  * _RING_SHARE[name](g))
            return real[name](*args, **kw)
        return call

    def decode(*args, **kw):
        seen["on"] = True
        try:
            return real_decode(*args, **kw)
        finally:
            seen["on"] = False
            seen["calls"] += 1
    out = {}
    try:
        for name in real:
            setattr(dist, name, counted(name))
        lm.lm_decode = decode
        for name, case in inputs["cases"].items():
            cfg = case["cfg"]
            sc = ServeConfig(**case["sc"])
            local = ctx.with_plan(sc.decode_plan).shard(case["params"],
                                                        lm.lm_defs(cfg))
            eng = ServeEngine(local, cfg, sc, device="cpu", ctx=ctx)
            for p, m, a in case["trace"]:
                eng.submit(p, m, arrival=a)
            seen.update(bytes=0, calls=0)
            eng.run()
            out[name] = {"bytes": seen["bytes"], "calls": seen["calls"]}
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        lm.lm_decode = real_decode
    return out


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def case_pipeline(ctx: MeshContext, inputs: dict) -> dict:
    """Each case: the pipelined loss of the global batch on this rank,
    back-propagated as a training step does (``loss / world``, then the
    replica sums); this rank's loss, xent and aux and the full
    gradients.  With ``pad`` the port's ``zero_identity_padding`` cuts
    the padding layers first.  Then ``steps`` steps of
    ``make_pipeline_train_step`` (noiseless gates): the ranks' mean
    losses."""
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import pipeline as pp_lib
    out = {}
    for name, case in inputs["cases"].items():
        cfg, n_stages, n_micro = case["cfg"], case["n_stages"], case["n_micro"]
        pp = pp_lib.pipeline_context(ctx)
        defs = pp_lib.pipeline_param_defs(cfg, n_stages)
        params = case["params"]
        if case.get("pad"):
            params = dict(params, blocks=pp_lib.zero_identity_padding(
                params["blocks"], cfg, n_stages))
        local = _grad_leaves(pp.shard(params, defs))
        loss, m = pp_lib.pipeline_lm_loss(
            local, case["batch"], cfg, ctx=ctx, n_stages=n_stages,
            n_micro=n_micro, draws=case.get("draws"), train=case["train"])
        (loss / pp.world).backward()
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                    else p.grad), local)
        trainer_lib._sum_replicas(pp, grads, pp.specs(defs))
        res = {k: float(v) for k, v in m.items()}
        res["grads"] = _full(pp, grads, defs)
        if case.get("steps"):
            oc = opt_lib.OptConfig(kind="adam", learning_rate=1e-2,
                                   warmup_steps=1)
            state = {"params": _grad_leaves(pp.shard(case["params"], defs))}
            state["opt"] = opt_lib.init(state["params"], oc)
            step = pp_lib.make_pipeline_train_step(
                cfg, oc, ctx=ctx, n_stages=n_stages, n_micro=n_micro)
            res["step_losses"] = [
                float(step(state, case["batch"], None)[1]["loss"])
                for _ in range(case["steps"])]
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# MoA and the hierarchical MoE on a mesh (their global plan)
# ---------------------------------------------------------------------------

def _routed_layer(ctx: MeshContext, case: dict) -> dict:
    """One MoA or hierarchical-MoE layer on this mesh at train=True: the
    rank's rows of x (and of the positions), the global noise, the
    parameters sharded by the plan and gathered on use; ``sum(y * dy) +
    aux_loss`` back-propagated as a sum over the ranks (as
    :func:`_moe_case`).  Returns the rank's y, aux, metrics, telemetry
    and the full gradients of the parameters and of x."""
    from repro_torch.core import hierarchical as hmoe_lib
    from repro_torch.core import moa as moa_lib
    if case["kind"] == "moa":
        a = moa_lib.MoAArgs(**case["args"])
        defs = moa_lib.moa_defs(a)
    else:
        a = hmoe_lib.HMoEArgs(**case["args"])
        defs = hmoe_lib.hmoe_defs(a)
    local = _grad_leaves(ctx.shard(case["params"], defs))
    used = ep_lib.gather_on_use(local, defs, ctx)
    x = ctx.local_rows(case["x"]).clone().requires_grad_(True)
    if case["kind"] == "moa":
        y, aux = moa_lib.moa_apply(used, x, a,
                                   positions=ctx.local_rows(case["pos"]),
                                   train=True, noise=case["noise"], ctx=ctx)
    else:
        y, aux = hmoe_lib.hmoe_apply(used, x, a, train=True,
                                     noise=case["noise"], ctx=ctx)
    loss = torch.sum(y * ctx.local_rows(case["dy"])) \
        + aux["aux_loss"] / ctx.world
    loss.backward()
    grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                else p.grad), local)
    trainer_lib._sum_replicas(ctx, grads, ctx.specs(defs))
    return {"y": y.detach(), "aux_loss": aux["aux_loss"].detach(),
            "metrics": {k: v.detach() for k, v in aux["metrics"].items()},
            "telemetry": aux["telemetry"], "grads": _full(ctx, grads, defs),
            "dx": x.grad}


def _routed_logits(ctx: MeshContext, case: dict) -> dict:
    """lm_prefill of the whole prompt rows on every rank (the prefill
    plan, a whole page), the page relaid onto the decode plan fitted to
    the cache, then one lm_decode step of this rank's slots: both calls'
    logits."""
    from repro_torch.common import param as pm
    from repro_torch.models import transformer
    from repro_torch.serve.kv_cache import fit_decode_plan
    cfg = case["cfg"]
    defs = lm.lm_defs(cfg)
    tokens = case["tokens"]
    b, s = tokens.shape
    cdefs = transformer.cache_defs(cfg, b, case["max_len"])
    pre = ctx.with_plan("prefill_tp")
    dec = fit_decode_plan(ctx.with_plan("decode_std"), cdefs)
    params = ep_lib.serve_layout(dec.shard(case["params"], defs), defs, dec)
    with torch.no_grad():
        cache = pm.materialize(cdefs, torch.Generator(), "cpu")
        logits, cache = lm.lm_prefill(params, {"tokens": tokens}, cache, cfg,
                                      ctx=pre)
        cache = dec.reshard(cache, cdefs)
        nxt = dec.shard_leaf(case["next"], dec.resolve((b,), ("batch",)))
        step, _ = lm.lm_decode(params, nxt, cache, s, cfg, ctx=dec)
    return {"prefill": logits, "decode": step}


def _routed_record(ctx: MeshContext, case: dict) -> dict:
    """One training step (``launch/steps.py``'s train step at the
    cell's shape) under the collective recorder; beside it what this
    rank handed torch.distributed, in the recorder's convention (the
    bytes a rank sends of each call's tensors in its group)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import analytic, steps
    from repro_torch.sharding.context import record_collectives
    cfg = case["cfg"]
    shape = ShapeSpec("t", "train", case["seq"], case["batch"])
    oc = opt_lib.OptConfig(kind="factored")
    defs = lm.lm_defs(cfg)
    local = _grad_leaves(ctx.shard(case["params"], defs))
    state = {"params": local, "opt": opt_lib.init(local, oc)}
    fn = steps.make_train_step_fn(
        cfg, oc, ctx, microbatches=analytic.cfg_microbatches(cfg, shape,
                                                             ctx.world))
    real = {n: getattr(dist, n) for n in ("all_gather", "all_reduce",
                                          "all_to_all_single")}
    sent: dict = {}

    def counted(name, op, share):
        def call(*args, **kw):
            t = args[0] if name == "all_reduce" else args[1]
            g = dist.get_world_size(kw.get("group"))
            row = sent.setdefault(op, {"calls": 0, "bytes": 0})
            row["calls"] += 1
            row["bytes"] += t.numel() * t.element_size() * share(g)
            return real[name](*args, **kw)
        return call
    try:
        dist.all_gather = counted("all_gather", "all_gather",
                                  lambda g: g - 1)
        dist.all_reduce = counted("all_reduce", "all_reduce",
                                  lambda g: 2 * (g - 1) / g)
        dist.all_to_all_single = counted("all_to_all_single", "all_to_all",
                                         lambda g: (g - 1) / g)
        with record_collectives() as table:
            fn(state, case["batch_data"], 0)
    finally:
        for name, f in real.items():
            setattr(dist, name, f)
    return {"recorded": table, "sent": sent}


def case_routed(ctx: MeshContext, inputs: dict) -> dict:
    """MoA and the hierarchical MoE on this mesh: each layer case, each
    model's step-0 gradients and metrics from the JAX draws (as
    :func:`case_train`), each serving case (as :func:`case_serve`), the
    prefill / decode logits and the recorded train steps."""
    out = {"layers": {name: _routed_layer(ctx, case)
                      for name, case in inputs.get("layers", {}).items()}}
    out["train"] = {}
    for name, model in inputs.get("models", {}).items():
        defs = _defs(model)
        local = _grad_leaves(ctx.shard(model["params"], defs))
        grads_fn = trainer_lib.make_grad_fn(
            _loss_fn(model, ctx, draws=model["jax_draws"]), ctx=ctx,
            defs=defs)
        grads, metrics = grads_fn(local, model["batch"], None)
        out["train"][name] = {
            "grads0": _full(ctx, grads, defs),
            "metrics0": {k: float(v) for k, v in metrics.items()}}
    if inputs.get("serve"):
        out["serve"] = case_serve(ctx, {"cases": inputs["serve"]})
    out["logits"] = {name: _routed_logits(ctx, case)
                     for name, case in inputs.get("logits", {}).items()}
    out["record"] = {name: _routed_record(ctx, case)
                     for name, case in inputs.get("record", {}).items()}
    return out


# ---------------------------------------------------------------------------
# rows that do not divide over the ranks
# ---------------------------------------------------------------------------

def case_rows(ctx: MeshContext, inputs: dict) -> dict:
    """For each model, a global batch whose rows do not divide over the
    ranks: the trainer's gradients and metrics from the JAX draws (full
    gradients), and the metrics from a generator seeded with ``seed``
    (the rank draws the global batch's noise)."""
    out = {}
    for name, model in inputs["models"].items():
        defs = _defs(model)
        res = {}
        for how, draws in (("draws", model["jax_draws"]), ("gen", None)):
            local = _grad_leaves(ctx.shard(model["params"], defs))
            grads_fn = trainer_lib.make_grad_fn(
                _loss_fn(model, ctx, draws=draws), ctx=ctx, defs=defs)
            gen = torch.Generator().manual_seed(inputs["seed"])
            grads, metrics = grads_fn(local, model["batch"], gen)
            res[how] = {k: float(v) for k, v in metrics.items()}
            if draws is not None:
                res["grads"] = _full(ctx, grads, defs)
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# a prefill step's rows
# ---------------------------------------------------------------------------

def case_prefill_rows(ctx: MeshContext, inputs: dict) -> dict:
    """For each case, ``launch/steps.py``'s prefill step on this rank's
    rows of the case's prompts (``steps.prefill_rows`` on the
    ``prefill_tp`` plan, as ``build_step`` splits them) into pages of
    those rows (``transformer.tp_cache_defs``: an attention page holds
    the rank's key / value heads where they run tensor-parallel): the
    rows' global indices, the split's axes, the last logits, the cache
    and the rank's index among the key / value heads' ranks (None where
    they are whole)."""
    from repro_torch.common import param as pm
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    out = {}
    for name, case in inputs.items():
        cfg, tokens = case["cfg"], case["tokens"]
        b, s = tokens.shape
        pre = steps.prefill_rows(ctx.with_plan("prefill_tp"), b, s)
        defs = lm.lm_defs(cfg)
        params = ep_lib.serve_layout(pre.shard(case["params"], defs), defs,
                                     pre)
        rows = pre.local_rows(torch.arange(b))
        cache = pm.zeros(transformer.tp_cache_defs(
            cfg, rows.numel(), case["max_len"], pre), "cpu")
        with torch.no_grad():
            logits, cache = steps.make_prefill_step_fn(cfg, pre)(
                params, {"tokens": tokens[rows]}, cache)
        kv = transformer.dense_tp(cfg, pre)["kv_heads"]
        out[name] = {"rows": rows, "row_axes": pre.row_axes,
                     "logits": logits, "cache": cache,
                     "kv_index": pre.index(kv) if kv else None}
    return out


# ---------------------------------------------------------------------------
# the experts served tensor-parallel (d_ff over data)
# ---------------------------------------------------------------------------

def _moe_leaves(params) -> dict:
    """The first MoE layer's FFN leaves of a stacked tree."""
    moe = params["blocks"]["periods"]["pos0"]["moe"]
    return {k: moe[k][0] for k in ("w1", "w2", "w3") if k in moe}


def case_expert_tp(ctx: MeshContext, inputs: dict) -> dict:
    """The flat MoE's serving layout and the engine on it: for each
    layout case, ``serve_layout`` of the decode plan's slices, of that
    layout again (kept) and of the whole tree (the same layout), with
    this rank's coordinates; for each
    serving case, the rank's engine on the trace (its streams, stats
    and the expert leaves' shapes it serves from); each logits case as
    :func:`_routed_logits`."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    dec = ctx.with_plan("decode_std")
    out = {"coords": {"data": dec.index(("data",)),
                      "model": dec.index(("model",))},
           "layout": {}, "serve": {}}
    for name, case in inputs["layout"].items():
        defs = lm.lm_defs(case["cfg"])
        params = ep_lib.serve_layout(dec.shard(case["params"], defs), defs,
                                     dec)
        again = ep_lib.serve_layout(params, defs, dec)
        whole = ep_lib.serve_layout(case["params"], defs, dec)
        out["layout"][name] = {
            "leaves": _moe_leaves(params),
            "kept": all(a is b for a, b in zip(tree_leaves(params),
                                               tree_leaves(again))),
            "from_whole": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(params), tree_leaves(whole)))}
    for name, case in inputs["serve"].items():
        cfg, sc = case["cfg"], ServeConfig(**case["sc"])
        local = ctx.with_plan(sc.decode_plan).shard(case["params"],
                                                    lm.lm_defs(cfg))
        eng = ServeEngine(local, cfg, sc, device="cpu", ctx=ctx)
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in case["trace"]]
        eng.run()
        out["serve"][name] = {
            "streams": [list(r.tokens) for r in reqs],
            "done": all(r.done for r in reqs), "stats": dict(eng.stats),
            "expert_shapes": {k: tuple(v.shape) for k, v in
                              _moe_leaves(eng.params).items()}}
    out["logits"] = {name: _routed_logits(ctx, case)
                     for name, case in inputs["logits"].items()}
    return out


# ---------------------------------------------------------------------------
# the dense layers tensor-parallel where a step's rows are whole
# ---------------------------------------------------------------------------

def _shapes(tree) -> dict:
    """``{path: shape}`` of a tree's leaves."""
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: v for k in sorted(tree)
                for p, v in _shapes(tree[k]).items()}
    return {"": tuple(tree.shape)}


def case_dense_tp(ctx: MeshContext, inputs: dict) -> dict:
    """For each model, the trainer's gradients and metrics from the JAX
    draws (full gradients), the tensor-parallel axes of its step's rows
    (``transformer.dense_tp``), the leaf shapes ``gather_on_use`` hands
    the loss under that split and under one that splits the rows over
    every rank; for each prefill case, ``launch/steps.py``'s prefill
    step on this rank's rows (``tp_cache_defs``'s pages, as
    ``build_step`` lays them out): its logits, cache and the key / value
    heads' axes."""
    from repro_torch.common import param as pm
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    out = {"train": {}, "prefill": {}}
    for name, model in inputs["models"].items():
        cfg, defs = model["cfg"], _defs(model)
        local = _grad_leaves(ctx.shard(model["params"], defs))
        grads_fn = trainer_lib.make_grad_fn(
            _loss_fn(model, ctx, draws=model["jax_draws"]), ctx=ctx,
            defs=defs)
        grads, metrics = grads_fn(local, model["batch"], None)
        b, s = model["batch"]["tokens"].shape
        rows = ctx.split_rows(b, s)
        with torch.no_grad():
            used = ep_lib.gather_on_use(local, defs, rows, tp=True)
            split = ep_lib.gather_on_use(
                local, defs, ctx.split_rows(ctx.world, s), tp=True)
        out["train"][name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _full(ctx, grads, defs),
            "tp": transformer.dense_tp(cfg, rows),
            "shapes": _shapes(used), "split_shapes": _shapes(split)}
    for name, case in inputs["prefill"].items():
        cfg, tokens = case["cfg"], case["tokens"]
        b, s = tokens.shape
        pre = steps.prefill_rows(ctx.with_plan("prefill_tp"), b, s)
        defs = lm.lm_defs(cfg)
        params = ep_lib.serve_layout(pre.shard(case["params"], defs), defs,
                                     pre)
        rows = pre.local_rows(torch.arange(b))
        cache = pm.zeros(transformer.tp_cache_defs(
            cfg, rows.numel(), case["max_len"], pre), "cpu")
        with torch.no_grad():
            logits, cache = steps.make_prefill_step_fn(cfg, pre)(
                params, {"tokens": tokens[rows]}, cache)
        kv = transformer.dense_tp(cfg, pre)["kv_heads"]
        out["prefill"][name] = {
            "rows": rows, "logits": logits, "cache": cache, "kv": kv,
            "kv_index": pre.index(kv) if kv else 0,
            "shapes": _shapes(params)}
    return out


CASES = {"moe": case_moe, "train": case_train, "restore": case_restore,
         "serve": case_serve, "decode_wire": case_decode_wire,
         "pipeline": case_pipeline, "routed": case_routed,
         "rows": case_rows, "prefill_rows": case_prefill_rows,
         "expert_tp": case_expert_tp, "dense_tp": case_dense_tp}


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _rank(rank: int, case: str, path: str, world: int, model: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    try:
        ctx = MeshContext.for_mesh(make_host_mesh(model, device="cpu"),
                                   "dp_tp_ep")
        inputs = torch.load(os.path.join(path, "inputs.pt"),
                            weights_only=False)
        out = CASES[case](ctx, inputs)
        torch.save(out, os.path.join(path, f"out{rank}.pt"))
        # Every rank done with its groups before any tears them down (a
        # rank that destroys the groups while another still holds them
        # can abort the other).
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    case, path, world, _data, model = argv
    mp.spawn(_rank, args=(case, path, int(world), int(model)),
             nprocs=int(world), join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))


def start(case: str, path, inputs: dict, data: int, model: int,
          timeout: float = 300.0):
    """Start ``case`` on ``data * model`` spawned ranks (the test side):
    writes ``inputs`` and runs this module in a fresh interpreter with
    the port on its path.  The returned function waits for it and
    returns every rank's output in rank order."""
    import subprocess
    path = str(path)
    torch.save(inputs, os.path.join(path, "inputs.pt"))
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    world = data * model
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, path, str(world),
         str(data), str(model)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def wait() -> list:
        _, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, err[-4000:]
        return [torch.load(os.path.join(path, f"out{r}.pt"),
                           weights_only=False) for r in range(world)]
    return wait


def spawn(*args, **kw) -> list:
    """:func:`start`, waited for."""
    return start(*args, **kw)()
