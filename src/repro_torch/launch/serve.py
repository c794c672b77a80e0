"""Serving launcher for the port: initialize a model and serve a request
trace through the continuous-batching engine.

Example (one H100; kimi-k2 at full width fits the card at 2 layers):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --arch kimi-k2-1t-a32b --n-layers 2 --requests 8 --new-tokens 16
  # a tiny model of the same family on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch kimi-k2-1t-a32b --reduce --requests 4 --stagger 1

  # one fused launch per MoE layer at decode, any routing policy:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch kimi-k2-1t-a32b --reduce --fused-decode \
      --router-policy expert_choice
  # Mixture-of-Attention-Heads:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch moa-demo --reduce --fused-decode --moa-k 2

  # chunked prefill and the shared-prefix KV cache: every request opens
  # with the same 32 tokens and arrives after the one before retired
  # (the chunk must be a multiple of the reduced config's kv_block, 32):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch kimi-k2-1t-a32b --reduce --requests 3 --new-tokens 4 \
      --stagger 6 --prompt-len 48 --prefill-chunk 32 --prefill-budget 64 \
      --admission aware --prefix-cache --shared-prefix 32

  # serve what launch.train trained (its <workdir>/ckpt):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch kimi-k2-1t-a32b --reduce --ckpt /tmp/w/ckpt

  # a chrome trace with the device waited for inside the prefill and
  # decode spans, and the scheduler's decision log (what
  # repro_torch.obs.replay fits and replays):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch kimi-k2-1t-a32b --reduce --requests 4 --stagger 1 \
      --trace /tmp/serve_trace.json --trace-sync --log-decisions

  # on a mesh: two ranks under torchrun (gloo on the CPU, NCCL on the
  # cards), the host mesh on the decode_std plan; rank 0 prints:
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc_per_node 2 -m repro_torch.launch.serve --device cpu \
      --arch kimi-k2-1t-a32b --reduce --requests 4 --stagger 1

The flags are the reference launcher's, plus ``--device``,
``--kernel-backend``, ``--n-layers`` and ``--seed``.  Under ``torchrun``
(``WORLD_SIZE`` set) every rank draws the same weights from ``--seed``,
keeps its slices by the decode plan and serves the same requests
(``ServeEngine(ctx=)``); only rank 0 prints.
"""
from __future__ import annotations

import argparse
import builtins
import os
import time

import numpy as np
import torch

from repro_torch.common import param as pm
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core import router as router_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import reduced
from repro_torch.models import lm
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.sharding.context import MeshContext
from repro_torch.train.checkpoint import CheckpointManager


def init_distributed(device: torch.device) -> tuple[torch.device,
                                                    MeshContext | None]:
    """Under torchrun: the process group (NCCL on the cards, gloo on the
    CPU, as ``launch.train`` does), this rank's device and the host mesh
    on the decode_std plan.  Without it: the device and no mesh."""
    if "WORLD_SIZE" not in os.environ:
        return device, None
    import torch.distributed as dist
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    ctx = MeshContext.for_mesh(make_host_mesh(device=device.type),
                               "decode_std")
    return device, ctx


def _slicer(ctx: MeshContext):
    """``materialize``'s cut: a leaf's slice by ``ctx``'s plan."""
    return lambda d, t: ctx.shard_leaf(t, ctx.resolve(d.shape, d.axes))


def main(argv=None) -> list:
    """Returns each request's generated tokens, in submission order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=("cuda", "ref"),
                    help="cuda = the hand-written kernels; ref = plain "
                         "PyTorch")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (full width kimi-k2 fits one "
                         "80 GB card at 2 layers)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to restore params from "
                         "(launch.train's <workdir>/ckpt)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slots", type=int, default=None,
                    help="slot-pool size (default: min(requests, 8))")
    ap.add_argument("--stagger", type=int, default=0,
                    help="admit one request every N engine steps")
    ap.add_argument("--policy", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--router-policy", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--moa-k", type=int, default=None)
    ap.add_argument("--no-dead-slot-mask", action="store_true")
    ap.add_argument("--no-prefill-buckets", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-budget", type=int, default=0)
    ap.add_argument("--admission", choices=("fcfs", "aware"),
                    default="fcfs")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-cache-bytes", type=int, default=1 << 30)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--fused-decode", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--trace-sync", action="store_true")
    ap.add_argument("--log-decisions", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)

    device, ctx = init_distributed(resolve_device(args.device))
    try:
        return _serve(args, device, ctx)
    finally:
        if ctx is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, device: torch.device, ctx: MeshContext | None) -> list:
    # Only rank 0 prints (every rank serves the same requests).
    print = (builtins.print if ctx is None or ctx.is_writer
             else lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    cfg = cfg.replace(kernel_backend=args.kernel_backend)
    if args.router_policy is not None or args.capacity_factor is not None:
        spec = router_lib.resolve_spec(cfg)
        if args.router_policy is not None:
            spec = spec.replace(policy=args.router_policy)
        if args.capacity_factor is not None:
            spec = spec.replace(capacity_factor=args.capacity_factor)
        router_lib.get_policy(spec.policy)
        cfg = cfg.replace(router=spec)
        print(f"[serve] router: {spec}")
    if args.moa_k is not None:
        if not cfg.moa_positions:
            raise SystemExit(f"--moa-k: arch {cfg.name!r} has no MoA layers "
                             "(moa_positions is empty)")
        cfg = cfg.replace(moa_k=args.moa_k)
        print(f"[serve] moa_k: {cfg.moa_k}/{cfg.moa_experts} head groups")
    n_slots = args.slots or min(args.requests, 8)
    max_len = args.prompt_len + args.new_tokens + 1
    if args.prefill_chunk > 0:
        # Chunk writes land in [start, start + chunk) windows: size the
        # page to a chunk multiple so the final padded window fits.
        max_len = -(-max_len // args.prefill_chunk) * args.prefill_chunk
    sc = ServeConfig(
        max_len=max_len,
        temperature=args.temperature, n_slots=n_slots, policy=args.policy,
        mask_dead_slots=not args.no_dead_slot_mask,
        prefill_buckets=not args.no_prefill_buckets,
        prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, admission=args.admission,
        prefix_cache=args.prefix_cache,
        prefix_cache_bytes=args.prefix_cache_bytes,
        trace_path=args.trace, trace_sync=args.trace_sync,
        log_decisions=args.log_decisions, fused_decode=args.fused_decode,
        seed=args.seed)
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"--ckpt {args.ckpt}: no checkpoint")
        like = {"params": pm.zeros(lm.lm_defs(cfg), device)}
        params = mgr.restore(step, like)[0]["params"]
        print(f"[serve] restored checkpoint step {step}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        # On a mesh each rank keeps its slices by the decode plan as the
        # leaves are drawn (the draws are the whole tree's).
        params = pm.materialize(lm.lm_defs(cfg), gen, device, cut=(
            None if ctx is None else _slicer(ctx.with_plan(sc.decode_plan))))
    if ctx is not None:
        if args.ckpt:
            params = ctx.with_plan(sc.decode_plan).shard(params,
                                                         lm.lm_defs(cfg))
        print(f"[serve] {ctx.world} rank(s) over "
              f"{torch.distributed.get_backend()}, mesh {dict(ctx.sizes)}")
    engine = ServeEngine(params, cfg, sc, device=device, ctx=ctx)
    rng = np.random.RandomState(args.seed)
    shared = rng.randint(1, cfg.vocab_size,
                         (min(args.shared_prefix, args.prompt_len),))
    reqs = [engine.submit(
                np.concatenate([shared, rng.randint(
                    1, cfg.vocab_size,
                    (args.prompt_len - shared.shape[0],))]),
                args.new_tokens, arrival=i * args.stagger)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = engine.stats["generated_tokens"]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {args.requests} requests x {args.new_tokens} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s on {where}, "
          f"backend={cfg.kernel_backend}, policy={args.policy}, "
          f"fused_decode={'on' if args.fused_decode else 'off'}, "
          f"slots={n_slots}, steps={engine.stats['decode_steps']}, "
          f"util={engine.slot_utilization:.2f})")
    print(f"[serve] prefill shapes: {sorted(engine.prefill_lengths)} "
          f"(buckets={'on' if engine._can_bucket else 'off'}, dead-slot "
          f"mask={'on' if engine.sc.mask_dead_slots else 'off'})")
    if engine._chunk:
        print(f"[serve] chunked prefill: chunk={engine._chunk}, "
              f"budget={engine.sc.prefill_budget or 'unlimited'}, "
              f"admission={engine.sc.admission}, "
              f"chunks={engine.stats['prefill_chunks']} in "
              f"{engine.stats['prefill_calls']} calls, "
              f"offsets={sorted(engine.chunk_offsets)}")
    if engine.prefix is not None:
        ps = engine.prefix.stats
        print(f"[serve] prefix cache: {ps['hits']} hits / "
              f"{ps['hits'] + ps['misses']} lookups, "
              f"{ps['hit_tokens']} prompt tokens reused, "
              f"{engine.prefix.n_pages} pages "
              f"({engine.prefix.bytes / 1e6:.1f} MB, "
              f"{ps['evictions']} evictions)")
    for key, name, total in (("expert_load", "expert", "overflow_total"),
                             ("moa_load", "MoA head-group",
                              "moa_overflow_total")):
        rows = [t[key] for t in engine.telemetry if key in t]
        if rows:
            load = np.sum(rows, axis=0)
            print(f"[serve] {name} load (decode): "
                  f"{load.astype(int).tolist()} (capacity overflow: "
                  f"{engine.stats[total]:.0f})")
    if args.trace:
        print(f"[serve] trace written: {args.trace} "
              f"({len(engine.tracer.events)} events; load in Perfetto)")
    if args.log_decisions:
        print(f"[serve] decision log: {len(engine.sched.decision_log)} "
              "scheduling steps recorded")
    print(f"[serve] sample: {reqs[0].tokens[:10]}")
    return [list(r.tokens) for r in reqs]


if __name__ == "__main__":
    main()
