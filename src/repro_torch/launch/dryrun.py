"""Dry run of every (arch x shape x mesh) cell on ``meta`` tensors
under a fake process group (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder devices
and reads XLA's ``memory_analysis()``.  The port has no compiler: per
cell this

  1. initializes a ``fake`` process group of 256 or 512 ranks in this
     process (``FakeStore``; its collectives move nothing) and builds
     the production mesh (``launch/mesh.py``) on it, as rank 0;
  2. builds the step and each rank's slices of its arguments as
     ``meta`` tensors (``launch/steps.py::build_step``);
  3. calls the step once on them inside ``cuda_lib.meta_trace()`` (each
     kernel wrapper allocates what its launch allocates and launches
     nothing) under :class:`MemTrace` (every storage an op creates,
     rounded to the CUDA caching allocator's 512-byte blocks, live until
     it is freed: the rank's peak and what it holds there), under
     ``FlopCounterMode`` and under ``sharding.context``'s collective
     recorder (calls and bytes sent a rank, backward passes included);
  4. appends a JSON line with the reference's keys where they mean
     something here (``launch/report.py`` prints it), with ``trace_s``
     for ``lower_s`` / ``compile_s`` and ``fits`` (the peak within the
     H100's 80 GB).  Resumable: cells already in the file are skipped
     unless --force; a cell that raises is recorded with its error.

It refuses to run in a process whose process group is already a real
one (the counterpart of the reference's "import before jax" guard): a
fake group would otherwise silently not be the one the collectives use.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape decode_32k --mesh pod --out results/dryrun_torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --out results/dryrun_torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.report \\
      results/dryrun_torch.jsonl

``--mesh`` also takes axis sizes (``1x2``: data 1, model 2; ``2x16x16``
adds pod), ``--shape`` a ``kind:BxS`` cell (``decode:8x48``: 8 slots, a
page of 48), ``--set key=value`` config overrides (a JSON value).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

ALL_ARCHS = (
    "pixtral-12b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "arctic-480b",
    "qwen3-1.7b", "gemma3-27b", "smollm-135m", "llama3-8b",
    "musicgen-large", "falcon-mamba-7b",
)
ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}

# The CUDA caching allocator's block: every allocation is a multiple.
ALLOC_BLOCK = 512
CATEGORIES = ("parameters", "optimizer_state", "inputs", "gradients",
              "activations", "temporaries")


def alloc_bytes(nbytes: int) -> int:
    """Bytes the caching allocator takes for ``nbytes`` (0 for none)."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


class MemTrace(TorchDispatchMode):
    """Live bytes of every storage that ops create inside the mode (and
    of the trees given to :meth:`track`), each rounded by
    :func:`alloc_bytes`, counted until its storage is freed.  ``peak``
    is the most held at once, ``at_peak`` what each category held then:
    ``activations`` are made in a forward pass, ``temporaries`` in a
    backward pass or, with ``train``, with gradients off (the update);
    a parameter's gradient moves to ``gradients`` when autograd
    accumulates it.  The same ops give the same bytes on any device, so
    a trace on ``meta`` is a trace of the card's allocations.

    ``torch.distributed._tools.mem_tracker.MemTracker`` does not do
    this for the port's steps: it rounds only storages on a CUDA device
    (not ``meta``), and it takes backward, gradient and optimizer
    categories from ``nn.Module`` and ``torch.optim`` hooks, which the
    port's functional steps (parameter trees, ``optim/optimizers.py``)
    never fire, so its categories do not follow the step's passes."""

    def __init__(self, train: bool = False):
        super().__init__()
        self.train = train
        self.live: dict = {}
        self.totals = dict.fromkeys(CATEGORIES, 0)
        self.current = self.peak = 0
        self.at_peak = dict(self.totals)
        self._hooks: list = []

    def _add(self, st: torch.UntypedStorage, category: str) -> None:
        key = id(st)
        if key in self.live:
            return
        n = alloc_bytes(st.nbytes())
        self.live[key] = [category, n, weakref.ref(
            st, functools.partial(self._free, key))]
        self.totals[category] += n
        self.current += n
        if self.current > self.peak:
            self.peak = self.current
            self.at_peak = dict(self.totals)

    def _free(self, key, _ref) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            self.totals[entry[0]] -= entry[1]
            self.current -= entry[1]

    def _move(self, t: torch.Tensor, category: str) -> None:
        entry = self.live.get(id(t.untyped_storage()))
        if entry is None:
            self._add(t.untyped_storage(), category)
        elif entry[0] != category:
            self.totals[entry[0]] -= entry[1]
            self.totals[category] += entry[1]
            entry[0] = category

    def track(self, tree, category: str) -> None:
        """Count the tensors of ``tree`` (made before the trace) as
        ``category``; a parameter that takes gradients gets a hook that
        moves its gradient to ``gradients``."""
        for t in _pytree.tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            self._add(t.untyped_storage(), category)
            if category == "parameters" and t.requires_grad:
                self._hooks.append(t.register_post_accumulate_grad_hook(
                    lambda p: self._move(p.grad, "gradients")))

    def _category(self) -> str:
        if torch._C._current_graph_task_id() != -1 or (
                self.train and not torch.is_grad_enabled()):
            return "temporaries"
        return "activations"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        category = self._category()
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage(), category)
        return out

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
        return super().__exit__(*exc)

    def snapshot(self) -> dict:
        """What each category held at the peak, and the peak."""
        return dict(self.at_peak, peak_bytes_per_device=self.peak)


def trace_step(spec, *, flops: bool = True) -> dict:
    """One call of ``spec`` (``launch/steps.py``'s StepSpec, ``meta``
    arguments) under :class:`MemTrace`, ``FlopCounterMode`` and the
    collective recorder: ``trace_s``, ``memory``, ``flops`` and
    ``collectives``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import cuda_lib
    from repro_torch.sharding.context import record_collectives
    mt = MemTrace(train=spec.kind == "train")
    if spec.kind == "train":
        state, *rest = spec.args
        mt.track(state["params"], "parameters")
        mt.track(state["opt"], "optimizer_state")
    else:
        params, *rest = spec.args
        mt.track(params, "parameters")
    mt.track(rest, "inputs")
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with cuda_lib.meta_trace(), record_collectives() as coll:
        with (counter if flops else contextlib.nullcontext()), mt:
            out = spec.fn(*spec.args)
        del out
    return {"trace_s": time.perf_counter() - t0, "memory": mt.snapshot(),
            "flops": counter.get_total_flops() if flops else None,
            "collectives": coll}


# ---------------------------------------------------------------------------
# the fake process group and the cell
# ---------------------------------------------------------------------------

def fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``world``
    ranks (one already of that size is kept, one of another size
    replaced).  Refuses when a real process group is initialized."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(
                f"launch.dryrun builds a fake process group of its own, but "
                f"a {backend!r} group of {dist.get_world_size()} ranks is "
                "already initialized in this process; run the dry run as "
                "a fresh process: python -m repro_torch.launch.dryrun ...")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_sizes(mesh_kind: str) -> dict:
    """``pod`` / ``multipod``, or axis sizes ``DxM`` / ``PxDxM``."""
    if mesh_kind in MESHES:
        return dict(MESHES[mesh_kind])
    sizes = [int(n) for n in mesh_kind.split("x")]
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                       "model")
    if len(sizes) not in (2, 3):
        raise ValueError(f"mesh {mesh_kind!r}: pod, multipod, DxM or PxDxM")
    return dict(zip(names, sizes))


def fake_mesh(sizes: dict):
    """A CPU ``DeviceMesh`` of ``sizes`` over a fake group of as many
    ranks, this process rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(math.prod(sizes.values()))
    return init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def parse_shape(shape_name: str):
    """A ``configs/shapes.py`` name, or ``kind:BxS``."""
    from repro_torch.configs import shapes as shp
    if shape_name in shp.SHAPES:
        return shp.SHAPES[shape_name]
    kind, bs = shape_name.split(":")
    b, s = (int(n) for n in bs.split("x"))
    return shp.ShapeSpec(shape_name, kind, s, b)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             plan: str | None = None, overrides: dict | None = None) -> dict:
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding import partition

    cfg = get_config(arch, **(overrides or {}))
    shape = parse_shape(shape_name)
    ok, why = shp.cell_supported(cfg, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "plan": plan, "kind": shape.kind,
              "global_batch": shape.global_batch, "seq_len": shape.seq_len}
    if overrides:
        record["overrides"] = overrides
    if not ok:
        record.update(status="skipped", reason=why)
        return record
    sizes = mesh_sizes(mesh_kind)
    spec = build_step(cfg, shape, fake_mesh(sizes), plan=plan)
    return cell_record(record, cfg, shape, sizes,
                       plan or partition.plan_for(shape.name), spec,
                       trace_step(spec))


def cell_record(record: dict, cfg, shape, sizes: dict, plan_name: str,
                spec, tr: dict) -> dict:
    """``record`` completed with a traced step (``tr``, of
    :func:`trace_step`) and the cell's analytic and roofline terms on a
    mesh of ``sizes`` (``{"data": 1, "model": 1}``: one card)."""
    from repro_torch.configs.base import count_params
    from repro_torch.launch import analytic as an
    from repro_torch.launch import roofline as rl

    n_dev = math.prod(sizes.values())
    ana = an.analyze_cell(cfg, shape, sizes, plan_name)
    peak = tr["memory"]["peak_bytes_per_device"]
    record.update(
        status="ok",
        n_devices=n_dev,
        trace_s=round(tr["trace_s"], 2),
        microbatches=spec.microbatches,
        memory=tr["memory"],
        fits=peak <= rl.H100["hbm_bytes"],
        cost={} if tr["flops"] is None else {"flops": tr["flops"]},
        cost_caveat=("FlopCounterMode sees aten ops only: the port's "
                     "kernels (GMM, fused decode) are launches it cannot "
                     "see; use 'analytic'"),
        collectives=tr["collectives"],
        analytic={"flops_per_dev": ana.flops_per_dev,
                  "hbm_bytes_per_dev": ana.hbm_bytes_per_dev,
                  "wire_bytes_per_dev": ana.wire_bytes_per_dev,
                  **ana.detail},
        params=count_params(cfg),
        sharding_fallbacks=[f"{s} axis={a} mesh_axis={x} dim={d}"
                            for (s, a, x, d) in spec.fallbacks][:20],
    )
    roof = rl.analyze(record, cfg)
    record["roofline"] = {
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s, "dominant": roof.dominant,
        "model_flops": roof.model_flops,
        "useful_ratio": round(roof.useful_ratio, 4),
        "roofline_fraction": round(rl.roofline_fraction(roof, n_dev), 4),
    }
    return record


def collective_bytes(record: dict) -> float:
    """Bytes a rank sends in the traced step, every op."""
    return sum(r["bytes"] for r in record.get("collectives", {}).values())


def _override(text: str) -> tuple:
    key, value = text.split("=", 1)
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--plan", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) for --mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[], type=_override,
                    metavar="KEY=VALUE", help="config override")
    args = ap.parse_args(argv)
    overrides = dict(args.set) or None

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("plan")))
                except json.JSONDecodeError:
                    pass

    if args.all:
        meshes = ["pod", "multipod"] if args.both_meshes else [args.mesh]
        cells = [(a, s, m) for m in meshes for a in ALL_ARCHS
                 for s in ALL_SHAPES]
    else:
        cells = [(args.arch, args.shape, args.mesh)]

    t_all = time.perf_counter()
    for arch, shape, mesh_kind in cells:
        key = (arch, shape, mesh_kind, args.plan)
        if key in done:
            print(f"[dryrun] skip (done): {key}")
            continue
        print(f"[dryrun] {arch} x {shape} x {mesh_kind} "
              f"plan={args.plan or 'auto'} ...", flush=True)
        t0 = time.perf_counter()
        try:
            rec = run_cell(arch, shape, mesh_kind, plan=args.plan,
                           overrides=overrides)
        except Exception as e:  # record failures; they are findings
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "plan": args.plan, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] ERROR: {rec['error'][:300]}", flush=True)
        rec["wall_s"] = round(time.perf_counter() - t0, 2)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if rec.get("status") == "ok":
            m = rec["memory"]["peak_bytes_per_device"] / 2**30
            r = rec["roofline"]
            print(f"[dryrun]   ok: peak {m:.2f} GiB/rank "
                  f"({'fits' if rec['fits'] else 'does not fit'} 80 GB), "
                  f"compute {r['compute_s']*1e3:.1f} ms, "
                  f"memory {r['memory_s']*1e3:.1f} ms, "
                  f"collective {r['collective_s']*1e3:.1f} ms "
                  f"-> {r['dominant']}-bound; collectives "
                  f"{json.dumps(rec['collectives'])} "
                  f"(trace {rec['trace_s']:.1f} s)", flush=True)
    print(f"[dryrun] {len(cells)} cell(s) in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
