"""Training loop: microbatched step builder + fault-tolerant driver,
counterpart of ``repro.train.trainer``.

``make_train_step`` builds one step: gradient accumulation over
``microbatches`` (a loop of backward passes; ``.grad`` is the
accumulator), then global-norm clipping and the Adam / factored update
(``optim/optimizers.py``, in place).  The loss is the token xent plus
the paper's §4 balancing losses (already summed into the model loss).

``Trainer`` is the fault-tolerance harness, as in the reference:

* auto-restore from the newest complete checkpoint (params, optimizer,
  data-iterator step);
* async checkpoint every ``checkpoint_every`` steps;
* heartbeat file, step times, and straggler events (a step slower than
  ``straggler_factor`` x the running median);
* ``crash_at_step`` for the fault-tolerance tests;
* ``metrics.jsonl`` at the end of a run;
* with ``trace_path``, a chrome trace of the reference's spans
  (``train.data``, ``train.step``, ``train.checkpoint``, with the kernel
  backend's ``kernel.*`` spans inside the step), written at the end of
  ``run()``.  ``train.step`` ends after the loss's copy to the host,
  which waits for the device (the reference's ``block_until_ready``);
  the kernel spans record the host side of each forward call, again in
  the backward pass where remat recomputes a layer.

Each step draws its randomness from a ``torch.Generator`` on the device
seeded by :func:`step_seed` from ``(seed, step)``, as the reference
folds the step into its key, so a resumed run draws the same numbers.

Data-parallel steps (``ctx``, a ``MeshContext`` with a mesh, and the
parameters' ParamDef tree ``defs``): the state holds this rank's slices
(``ctx.shard``).  The step splits the global batch into microbatches
and each rank takes its rows of each by the one row-split rule
(``MeshContext.split_rows``): over every rank (the ranks flattened in
mesh order, the token sharding's order) where a microbatch's rows
divide, else over the plan's ``batch`` axes, each row whole on the
ranks of the others (``model``), whose flat MoE layers split its tokens
(the reference's ``batch`` and ``tokens`` axes).  The loss function
runs under ``step_rows`` and reads that split
(``sharding.context.with_step_rows``); given ``ctx``, it draws the
global microbatch's noise from the step's generator and keeps the
rank's tokens, and gathers the parameters it uses from their shards
(``expert_parallel.gather_on_use``).

The loss scale.  With W ranks, R row groups (the product of the axes
the rows split over) and M = W / R ranks holding each group's rows
whole, the global loss is the mean over the R groups of their mean
xent, plus the combined batch's balance losses.  Each rank
back-propagates its own loss divided by W, and the gradients then sum
over every rank: the gathers' backward passes sum over the ranks that
hold shards of a leaf, an all-reduce sums over the ranks that hold
replicas of it (``_sum_replicas``).  A row held on M ranks is in M of
those losses, each at 1/W: M / W = 1/R, its weight in the global mean.
This holds through every layer because each copy's backward pass is
linear in its cotangent and the M copies ran the same forward pass, so
the sum over ranks is the backward pass of the summed cotangent; where
the copies' paths part (a flat MoE's token share, whose exit
all-gather's backward pass sums the M ranks' cotangents of each token,
or a global plan's gather over the row axes only), every token's
cotangent still arrives M times at 1/W.  The combined batch's balance
loss, which every rank adds, counts once: its statistics are summed
over all W ranks (each token once), each rank adds it at 1/W, and the
backward pass of that all-reduce sums the W cotangents; a global
plan's balance loss is computed whole on every rank, so its W copies
at 1/W add to one.  So the rule is ``loss / W`` with the replica sums,
whether rows divide or not (``tests/test_torch_row_split.py`` holds it
to JAX's one process on (1, 4) and (2, 2) with 2 rows).

It holds too where the M ranks of a row group run the dense layers
tensor-parallel (``MeshContext.tp_axes``: each holds a slice of the
heads, d_ff and vocabulary, and the partial outputs meet in an
all-reduce).  The step is then one computation over the M ranks, and
each collective's backward pass is its adjoint across them: the exit
all-reduce's backward sums the M ranks' cotangents, so a slice's
gradient gets all M copies' share at 1/W, M / W = 1/R of its row
group, as a whole leaf does through the replica sums.  A leaf whose
spec shards ``model`` (a tensor-parallel slice) is left alone by
``_sum_replicas``; one that stays whole on ``model`` (the norms'
scales, the key / value projections where their heads do not divide,
of which each rank used the groups its query heads read, an
``embed_fsdp``-only leaf) holds each rank's partial gradient, and the
replica sum over ``model`` adds them (``tests/test_torch_dense_tp.py``
holds it to JAX's one process on (1, 2), (1, 4) and (2, 2)).  Metrics are
the ranks' mean (each group's xent on M ranks: the global mean); rank 0
alone prints and writes the checkpoint (gathered: the same files as a
single-process run), the heartbeat and ``metrics.jsonl``.
On the CPU a resumed run is bit-identical to an uninterrupted one; on
the card the embedding's backward pass accumulates with atomics, so a
step there is not bit-reproducible.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.param import tree_leaves, tree_map
from repro_torch.obs import trace as trace_lib
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding.context import MeshContext, on_mesh, step_rows
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    microbatches: int = 1
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


def step_seed(seed: int, step: int) -> int:
    """The generator seed of ``step`` (the reference's
    ``fold_in(PRNGKey(seed), step)``)."""
    return (seed * 1_000_003 + step) % (2 ** 63 - 1)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n != 0:
        raise ValueError(
            f"batch size {b} not divisible into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_grad_fn(loss_fn: Callable, *, microbatches: int = 1,
                 ctx: MeshContext | None = None, defs=None):
    """``grads(params, batch, generator) -> (grads, metrics)``: the
    gradient tree of the loss over ``batch`` (accumulated over
    ``microbatches``) and its metrics.  On a mesh (``ctx``; ``defs`` the
    parameters' ParamDef tree) ``params`` are this rank's slices,
    ``batch`` the global batch, ``loss_fn`` runs the model with the same
    ``ctx`` (gathering what it uses), and the gradients are this rank's
    slices of the global batch's (see the module docstring)."""
    mesh = on_mesh(ctx)
    if mesh and defs is None:
        raise ValueError("a step on a mesh needs the parameters' defs")
    specs = ctx.specs(defs) if mesh else None

    def grads_fn(params, batch, generator):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        mbs = (_split_microbatches(batch, microbatches)
               if microbatches > 1 else [batch])
        metrics = {}
        for mb in mbs:
            if mesh:
                tokens = mb["tokens"] if "tokens" in mb else next(
                    iter(mb.values()))
                rows = ctx.split_rows(*tokens.shape[:2])
                mb = {k: rows.local_rows(v) for k, v in mb.items()}
                with step_rows(rows):
                    loss, m = loss_fn(params, mb, generator)
                (loss / ctx.world).backward()
            else:
                loss, m = loss_fn(params, mb, generator)
                loss.backward()
            for k, v in m.items():
                v = v.detach()
                metrics[k] = v if k not in metrics else metrics[k] + v
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                    else p.grad), params)
        if mesh:
            _sum_replicas(ctx, grads, specs)
            metrics = _rank_mean(ctx, metrics)
        if microbatches > 1:
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        return grads, metrics

    return grads_fn


def make_train_step(loss_fn: Callable, oc: opt_lib.OptConfig, *,
                    microbatches: int = 1, ctx: MeshContext | None = None,
                    defs=None):
    """loss_fn(params, batch, generator) -> (loss, metrics dict of
    scalars).  The step is ``step(state, batch, generator) -> (state,
    metrics)``; ``state = {"params", "opt"}`` is updated in place.  On a
    mesh (``ctx``; ``defs`` the parameters' ParamDef tree) ``batch`` is
    the global batch and the state this rank's slices (see the module
    docstring); ``loss_fn`` must run the model with the same ``ctx``."""
    grads_fn = make_grad_fn(loss_fn, microbatches=microbatches, ctx=ctx,
                            defs=defs)

    def step(state, batch, generator):
        params = state["params"]
        grads, metrics = grads_fn(params, batch, generator)
        _, _, info = opt_lib.apply_updates(params, grads, state["opt"], oc,
                                           ctx=ctx, defs=defs)
        for p in tree_leaves(params):
            p.grad = None
        return state, dict(metrics, **info)

    return step


def _sum_replicas(ctx: MeshContext, grads, specs) -> None:
    """Sum each gradient, in place, over the mesh axes that shard none of
    its leaf's dimensions (the ranks holding replicas of it)."""
    if isinstance(grads, dict):
        for k in sorted(grads):
            _sum_replicas(ctx, grads[k], specs[k])
        return
    ctx.all_reduce_(grads, ctx.replicated_axes(specs))


def _rank_mean(ctx: MeshContext, metrics: dict) -> dict:
    """Each scalar metric's mean over the ranks, in one all-reduce (the
    ranks' batches are equal shares, so the mean of their mean xent is
    the global batch's); a perplexity is the exp of that xent."""
    keys = sorted(metrics)
    if not keys:
        return metrics
    total = ctx.all_reduce_(torch.stack([metrics[k].float() for k in keys]))
    out = {k: v / ctx.world for k, v in zip(keys, total)}
    if "perplexity" in out and "xent" in out:
        out["perplexity"] = torch.exp(out["xent"])
    return out


class Trainer:
    def __init__(self, *, loss_fn, params, oc: opt_lib.OptConfig,
                 loop: TrainLoopConfig, data_iter, workdir: str,
                 crash_at_step: int | None = None,
                 kernel_backend: str | None = None, router=None,
                 trace_path: str | None = None, device="cuda",
                 ctx: MeshContext | None = None, defs=None):
        # Fail-fast validation of the backend and router policy the model
        # config is expected to use (selection stays in the config).
        if kernel_backend is not None:
            from repro_torch.kernels import backend as backend_lib
            backend_lib.get(kernel_backend)
        if router is not None:
            from repro_torch.core import router as router_lib
            router_lib.get_policy(router.policy)
        self.device = resolve_device(device)
        self.ctx = ctx
        self.writer = ctx is None or ctx.is_writer
        # On a mesh: the ParamDefs of the state, which the checkpoint
        # gathers and restores by.
        self.state_defs = ({"params": defs,
                            "opt": opt_lib.state_defs(defs, oc)}
                           if on_mesh(ctx) else None)
        self.loop = loop
        self.data_iter = data_iter
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(workdir, "ckpt"),
                                      keep=loop.keep_checkpoints)
        for p in tree_leaves(params):
            if p.is_floating_point():
                p.requires_grad_(True)
        self.state = {"params": params, "opt": opt_lib.init(params, oc)}
        self.step_fn = make_train_step(loss_fn, oc,
                                       microbatches=loop.microbatches,
                                       ctx=ctx, defs=defs)
        self.start_step = 0
        self.crash_at_step = crash_at_step
        # None => the shared null tracer (one no-op context manager a
        # span site).
        self.tracer = (trace_lib.Tracer(trace_path, process_name="train")
                       if trace_path else trace_lib.NULL)
        self.metrics_log: list[dict] = []
        self.step_times: list[float] = []
        self.straggler_events: list[dict] = []
        self._maybe_restore()

    # -- fault tolerance --------------------------------------------------
    def _maybe_restore(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        restored, extra, step = self.ckpt.restore(
            latest, self.state_defs or self.state, ctx=self.ctx)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.state),
                                tree_leaves(restored)):
                dst.copy_(src)
        self.start_step = step
        self.data_iter.restore(extra["data"])
        self._log(f"[trainer] restored checkpoint at step {step}")

    def _log(self, msg: str) -> None:
        if self.writer:
            print(msg)

    def _save(self, step: int, *, wait: bool) -> None:
        save = self.ckpt.save if wait else self.ckpt.save_async
        save(step, self.state, {"data": self.data_iter.state()},
             ctx=self.ctx, defs=self.state_defs)

    def _heartbeat(self, step: int):
        if not self.writer:
            return
        with open(os.path.join(self.workdir, "heartbeat.json"), "w") as f:
            json.dump({"step": step, "time": time.time()}, f)

    def _check_straggler(self, step: int, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = float(np.median(self.step_times[-32:]))
            if dt > self.loop.straggler_factor * med:
                ev = {"step": step, "duration": dt, "median": med}
                self.straggler_events.append(ev)
                self._log(f"[trainer] STRAGGLER step {step}: {dt:.3f}s vs "
                      f"median {med:.3f}s")

    # -- main loop ---------------------------------------------------------
    def run(self) -> dict:
        last_metrics = {}
        for step in range(self.start_step, self.loop.total_steps):
            if self.crash_at_step is not None and step == self.crash_at_step:
                # Test hook: let an in-flight async checkpoint complete so
                # the crash point is deterministic.
                self.ckpt.wait()
                raise RuntimeError(f"injected crash at step {step}")
            tr = self.tracer
            with tr.span("train.data", step=step):
                batch = next(self.data_iter)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(step_seed(self.loop.seed, step))
            t0 = time.perf_counter()
            with trace_lib.use(tr), tr.span(
                    "train.step", step=step,
                    microbatches=self.loop.microbatches):
                self.state, metrics = self.step_fn(self.state, batch, gen)
                loss = float(metrics["loss"])     # waits for the device
            dt = time.perf_counter() - t0
            self._heartbeat(step)
            self._check_straggler(step, dt)
            if (step + 1) % self.loop.log_every == 0 or \
                    step == self.loop.total_steps - 1:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                last_metrics["step"] = step + 1
                last_metrics["step_time_s"] = dt
                self.metrics_log.append(last_metrics)
                self._log(f"[trainer] step {step+1} loss={loss:.4f} "
                          f"({dt:.3f}s)")
            if (step + 1) % self.loop.checkpoint_every == 0:
                with tr.span("train.checkpoint", step=step + 1):
                    self._save(step + 1, wait=False)
        self.ckpt.wait()
        self._save(self.loop.total_steps, wait=True)
        if self.tracer.enabled and self.tracer.path:
            self.tracer.save()
        if self.writer:
            with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
                for m in self.metrics_log:
                    f.write(json.dumps(m) + "\n")
        return last_metrics
