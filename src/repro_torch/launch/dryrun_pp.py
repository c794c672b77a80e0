"""Pipeline-parallel dry run (counterpart of ``repro.launch.dryrun_pp``).

Traces the GPipe train step (``train/pipeline.py::
make_pipeline_train_step``) on the production pod mesh with the data
axis as 16 pipeline stages (the model axis stays expert-parallel inside
each stage), on ``meta`` tensors under a fake process group, as
``launch/dryrun.py`` traces a cell: the rank's peak, FLOPs and
collectives; and the analytic roofline terms of the schedule
(:func:`pp_analytic`, the reference's formula with the H100's
constants).

The port traces in the config's own dtype (bf16).  The reference lowers
in f32 to work round an XLA CPU partitioner fault (its ``dtype_note``),
which a trace of eager PyTorch does not have.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_pp \\
           [--arch kimi-k2-1t-a32b] [--shape train_4k] [--micro 64] \\
           [--out results/pp_torch.jsonl]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.launch.roofline import H100


def pp_analytic(cfg, shape, mesh, n_stages: int, n_micro: int) -> dict:
    """Roofline terms for the GPipe schedule (per device).  ``mesh``: a
    ``DeviceMesh`` or an ``{axis: size}`` mapping."""
    from repro_torch.configs.base import count_params
    from repro_torch.core.dispatch import capacity_for
    from repro_torch.sharding import partition

    sizes = partition.axis_sizes(mesh)
    n_dev = math.prod(sizes.values())
    M = sizes["model"]
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    tokens = B * S
    tokens_mb = tokens // n_micro
    per = -(-cfg.n_layers // n_stages)
    total = per * n_stages
    pad_ratio = total / cfg.n_layers
    ticks = n_micro + n_stages - 1
    bubble = ticks / n_micro

    n_act = count_params(cfg)["active_excl_embed"]
    # per-device FLOPs: global useful x remat(4/3) x capacity waste x
    # padding x bubble, spread over all devices (each tick all devices
    # run).
    cap = capacity_for(tokens_mb, cfg.n_experts, cfg.moe_k,
                       cfg.capacity_factor)
    cap_waste = (cfg.n_experts * cap) / (cfg.moe_k * tokens_mb) \
        if cfg.n_experts else 1.0
    flops_dev = (6 * n_act * tokens) * (4 / 3) * cap_waste * pad_ratio \
        * bubble / n_dev
    # xent + embed remat
    flops_dev += 4 * 2 * d * cfg.vocab_size / M * tokens / (
        sizes.get("data", 1))

    # collectives per device:
    bytes_p = 2
    boundary = tokens_mb * d * bytes_p / M          # stage shift per tick
    wire = 2 * boundary * ticks                      # fwd + bwd shifts
    if cfg.n_experts:
        t_loc = tokens_mb / M
        a2a = (2 * cfg.moe_k * t_loc * d * bytes_p * cfg.capacity_factor
               * (M - 1) / M)
        ag_back = tokens_mb / M * d * bytes_p * (M - 1)
        wire += (2 * (a2a + ag_back)) * per * n_micro
    # in-stage attention TP all-reduce
    ar = tokens_mb * d * bytes_p * 2 * (M - 1) / M
    wire += 2 * ar * per * n_micro
    # grads: none across stages (weights resident); opt local.

    params_loc = count_params(cfg)["total"] * bytes_p / n_dev
    hbm = 6 * params_loc + ticks * boundary * 4
    return {
        "flops_per_dev": flops_dev,
        "hbm_bytes_per_dev": hbm,
        "wire_bytes_per_dev": wire,
        "compute_s": flops_dev / H100["peak_flops"]["bfloat16"],
        "memory_s": hbm / H100["hbm_bandwidth"],
        "collective_s": wire / H100["nvlink_bandwidth"],
        "bubble_overhead": bubble,
        "pad_ratio": pad_ratio,
        "resident_bytes_per_dev": params_loc * 3.05
        + ticks * tokens_mb * d * bytes_p / M,
    }


def build_pp_step(cfg, shape, mesh, n_micro: int, oc=None):
    """The pipelined step and each rank's ``meta`` arguments on
    ``mesh`` with its ``data`` axis as the stages: ``(step, (state,
    batch, generator))``."""
    from repro_torch.common import param as pm
    from repro_torch.configs import shapes as shp
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding.context import MeshContext
    from repro_torch.train import pipeline as pp

    oc = oc or opt_lib.OptConfig(kind="factored")
    ctx = MeshContext.for_mesh(mesh, "dp_tp_ep")
    n_stages = ctx.sizes["data"]
    pctx = pp.pipeline_context(ctx)
    defs = pp.pipeline_param_defs(cfg, n_stages)
    opt_defs = opt_lib.state_defs(defs, oc)
    params = pctx.shard(pm.abstract(defs), defs)
    for p in pm.tree_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    opt = pctx.shard(pm.abstract(opt_defs), opt_defs)
    step = pp.make_pipeline_train_step(cfg, oc, ctx=ctx, n_stages=n_stages,
                                       n_micro=n_micro)
    gen = torch.Generator().manual_seed(0)
    return step, ({"params": params, "opt": opt},
                  shp.batch_inputs(cfg, shape), gen)


def main(argv=None):
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import StepSpec

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kimi-k2-1t-a32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--micro", type=int, default=64)
    ap.add_argument("--out", default="results/pp_torch.jsonl")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = shp.SHAPES[args.shape]
    sizes = dict(dryrun.MESHES["pod"])      # (data=16 -> stages, model=16)
    n_stages = sizes["data"]
    ana = pp_analytic(cfg, shape, sizes, n_stages, args.micro)
    rec = {"arch": args.arch, "shape": args.shape, "mesh": "pod",
           "plan": f"pipeline_s{n_stages}_m{args.micro}", "kind": "train",
           "n_devices": math.prod(sizes.values()),
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "dtype_note": f"traced in the config's {cfg.param_dtype}",
           "analytic": ana}
    print(f"[pp] tracing {args.arch} x {args.shape}: {n_stages} stages x "
          f"{args.micro} microbatches ...", flush=True)
    t0 = time.perf_counter()
    try:
        step, step_args = build_pp_step(cfg, shape, dryrun.fake_mesh(sizes),
                                        args.micro)
        tr = dryrun.trace_step(StepSpec(fn=step, args=step_args,
                                        kind="train",
                                        microbatches=args.micro,
                                        fallbacks=[]))
        peak = tr["memory"]["peak_bytes_per_device"]
        rec.update(status="ok", trace_s=round(tr["trace_s"], 2),
                   memory=tr["memory"], fits=peak <= H100["hbm_bytes"],
                   cost={"flops": tr["flops"]},
                   collectives=tr["collectives"])
    except Exception as e:  # recorded: a finding, not a crash
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    traced = (f"traced peak {rec['memory']['peak_bytes_per_device'] / 2**30:.1f}"
              f" GiB/rank (trace {rec['trace_s']:.0f} s)"
              if rec["status"] == "ok" else f"trace ERROR: {rec['error']}")
    print(f"[pp] compute {ana['compute_s']*1e3:.0f} ms, "
          f"collective {ana['collective_s']*1e3:.0f} ms, "
          f"memory {ana['memory_s']*1e3:.0f} ms, "
          f"bubble x{ana['bubble_overhead']:.2f}, "
          f"resident {ana['resident_bytes_per_dev']/2**30:.1f} GiB/dev, "
          f"{traced}", flush=True)


if __name__ == "__main__":
    main()
