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


def make_train_step(loss_fn: Callable, oc: opt_lib.OptConfig, *,
                    microbatches: int = 1):
    """loss_fn(params, batch, generator) -> (loss, metrics dict of
    scalars).  The step is ``step(state, batch, generator) -> (state,
    metrics)``; ``state = {"params", "opt"}`` is updated in place."""

    def step(state, batch, generator):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        mbs = (_split_microbatches(batch, microbatches)
               if microbatches > 1 else [batch])
        metrics = {}
        for mb in mbs:
            loss, m = loss_fn(params, mb, generator)
            loss.backward()
            for k, v in m.items():
                v = v.detach()
                metrics[k] = v if k not in metrics else metrics[k] + v
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                    else p.grad), params)
        if microbatches > 1:
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        _, _, info = opt_lib.apply_updates(params, grads, state["opt"], oc)
        for p in leaves:
            p.grad = None
        return state, dict(metrics, **info)

    return step


class Trainer:
    def __init__(self, *, loss_fn, params, oc: opt_lib.OptConfig,
                 loop: TrainLoopConfig, data_iter, workdir: str,
                 crash_at_step: int | None = None,
                 kernel_backend: str | None = None, router=None,
                 trace_path: str | None = None, device="cuda"):
        # Fail-fast validation of the backend and router policy the model
        # config is expected to use (selection stays in the config).
        if kernel_backend is not None:
            from repro_torch.kernels import backend as backend_lib
            backend_lib.get(kernel_backend)
        if router is not None:
            from repro_torch.core import router as router_lib
            router_lib.get_policy(router.policy)
        self.device = resolve_device(device)
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
                                       microbatches=loop.microbatches)
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
        restored, extra, step = self.ckpt.restore(latest, self.state)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.state),
                                tree_leaves(restored)):
                dst.copy_(src)
        self.start_step = step
        self.data_iter.restore(extra["data"])
        print(f"[trainer] restored checkpoint at step {step}")

    def _heartbeat(self, step: int):
        with open(os.path.join(self.workdir, "heartbeat.json"), "w") as f:
            json.dump({"step": step, "time": time.time()}, f)

    def _check_straggler(self, step: int, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = float(np.median(self.step_times[-32:]))
            if dt > self.loop.straggler_factor * med:
                ev = {"step": step, "duration": dt, "median": med}
                self.straggler_events.append(ev)
                print(f"[trainer] STRAGGLER step {step}: {dt:.3f}s vs "
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
                print(f"[trainer] step {step+1} loss={loss:.4f} "
                      f"({dt:.3f}s)")
            if (step + 1) % self.loop.checkpoint_every == 0:
                with tr.span("train.checkpoint", step=step + 1):
                    self.ckpt.save_async(step + 1, self.state,
                                         {"data": self.data_iter.state()})
        self.ckpt.wait()
        self.ckpt.save(self.loop.total_steps, self.state,
                       {"data": self.data_iter.state()})
        if self.tracer.enabled and self.tracer.path:
            self.tracer.save()
        with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
            for m in self.metrics_log:
                f.write(json.dumps(m) + "\n")
        return last_metrics
