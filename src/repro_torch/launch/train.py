"""Training launcher for the port: ``--arch <id>`` trains a registered
transformer architecture through the port's Trainer (counterpart of
``repro.launch.train``).

Fault tolerance is the Trainer's: atomic checkpoints every
``--checkpoint-every`` steps under ``<workdir>/ckpt``, auto-resume from
the newest one, straggler events.  ``launch.serve --ckpt
<workdir>/ckpt`` serves the trained parameters.

Example:
  # a tiny model of the kimi-k2 family on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch kimi-k2-1t-a32b --reduce --device cpu --steps 6 --batch 4 \\
      --seq 32
  # smollm-135m at full size on one H100
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 8 --batch 8 --seq 2048 --workdir /tmp/smollm

  # the MoA demo on the CPU, one head group a token
  PYTHONPATH=src python -m repro_torch.launch.train --arch moa-demo \
      --reduce --device cpu --steps 4 --batch 2 --seq 32 --moa-k 1

  # a chrome trace of the run (train.* spans, kernel.* inside them):
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch kimi-k2-1t-a32b --reduce --device cpu --steps 4 --batch 4 \
      --seq 32 --trace /tmp/train_trace.json

The flags are the reference launcher's, plus ``--device``.  Two of them
raise: ``--dispatch-vmem-limit`` and ``--no-gmm-autotune`` have no
counterpart in the port (the card has no VMEM budget, and the port has
no GMM tuning table).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common import param as pm
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import router as router_lib
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.models import lm
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.trainer import Trainer, TrainLoopConfig

# Flags of the reference launcher that the port refuses, with the reason.
REFUSED = {
    "dispatch_vmem_limit": "--dispatch-vmem-limit: the port has no VMEM "
                           "budget (the card has no VMEM; the resident "
                           "kernels run unless --dispatch-e-block forces "
                           "the e-blocked ones)",
    "no_gmm_autotune": "--no-gmm-autotune: the port has no GMM tuning "
                       "table (the reference's was measured in CPU "
                       "interpret mode)",
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference launcher's smoke-test shape of a config's family."""
    kw = dict(n_layers=(2 * cfg.period) if cfg.period > 1 else 2,
              d_model=64, vocab_size=512, param_dtype=torch.float32,
              compute_dtype=torch.float32, q_block=32, kv_block=32)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=2, head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.n_experts:
        kw.update(n_experts=8, moe_k=2, moe_d_ff=64)
    if cfg.moa_experts:
        kw.update(moa_experts=4, moa_k=2, moa_heads_per_expert=2)
    if cfg.ssm_d_state:
        kw.update(ssm_d_state=4)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.n_prefix:
        kw.update(n_prefix=0, frontend="none")
    return cfg.replace(**kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", default="factored",
                    choices=["factored", "adam"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--reduce", action="store_true",
                    help="shrink the config (a tiny model of the family)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-backend", default=None,
                    choices=["cuda", "ref"],
                    help="cuda = the hand-written kernels; ref = plain "
                         "PyTorch; default: the arch config's choice")
    ap.add_argument("--dispatch-vmem-limit", type=int, default=None)
    ap.add_argument("--dispatch-e-block", type=int, default=None,
                    help="force the expert-blocked dispatch / combine "
                         "(kernels 3 and 5) with this slab")
    ap.add_argument("--no-gmm-autotune", action="store_true")
    ap.add_argument("--router-policy", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--eval-capacity-factor", type=float, default=None)
    ap.add_argument("--moa-k", type=int, default=None,
                    help="head groups per token of the MoA mixers")
    ap.add_argument("--workdir", default="repro_train")
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    for flag, why in REFUSED.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(why)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    if args.kernel_backend is not None:
        cfg = cfg.replace(kernel_backend=args.kernel_backend)
    if args.dispatch_e_block is not None:
        cfg = cfg.replace(dispatch_e_block=args.dispatch_e_block)
    if (args.router_policy is not None or args.capacity_factor is not None
            or args.eval_capacity_factor is not None):
        spec = router_lib.resolve_spec(cfg)
        if args.router_policy is not None:
            spec = spec.replace(policy=args.router_policy)
        if args.capacity_factor is not None:
            spec = spec.replace(capacity_factor=args.capacity_factor)
        if args.eval_capacity_factor is not None:
            spec = spec.replace(
                eval_capacity_factor=args.eval_capacity_factor)
        router_lib.get_policy(spec.policy)
        cfg = cfg.replace(router=spec)
        print(f"[train] router: {spec}")
    if args.moa_k is not None:
        if not cfg.moa_positions:
            raise SystemExit(f"--moa-k: arch {cfg.name!r} has no MoA layers "
                             "(moa_positions is empty)")
        cfg = cfg.replace(moa_k=args.moa_k)
        print(f"[train] moa_k: {cfg.moa_k}/{cfg.moa_experts} head groups")
    gen = torch.Generator(device=device).manual_seed(0)
    params = pm.materialize(lm.lm_defs(cfg), gen, device)
    n = sum(p.numel() for p in pm.tree_leaves(params))
    print(f"[train] {cfg.name}: {n / 1e6:.1f}M params on {device}")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch, n_clusters=64)
    trainer = Trainer(
        loss_fn=lambda p, b, g: lm.lm_loss(p, b, cfg, generator=g),
        params=params,
        oc=OptConfig(kind=args.optimizer, learning_rate=args.lr,
                     warmup_steps=max(args.steps // 10, 10)),
        loop=TrainLoopConfig(total_steps=args.steps,
                             microbatches=args.microbatches,
                             checkpoint_every=args.checkpoint_every,
                             log_every=10),
        data_iter=DataIterator(dc, device=device), workdir=args.workdir,
        kernel_backend=cfg.kernel_backend, router=cfg.router,
        trace_path=args.trace, device=device)
    final = trainer.run()
    if args.trace:
        print(f"[train] trace written: {args.trace} "
              f"({len(trainer.tracer.events)} events; load in Perfetto)")
    print(f"[train] done: {final}")
    return final


if __name__ == "__main__":
    main()
