"""The port's dry run (``launch/steps``, ``launch/dryrun``,
``launch/dryrun_pp``) on the CPU.

* ``launch/steps.py``'s train (1 and 2 microbatches), prefill and
  decode steps on f32 CPU tensors against the JAX package's
  ``make_train_step_fn`` / ``make_prefill_step_fn`` /
  ``make_decode_step_fn`` on the same parameters (a JAX tree moved
  across with ``from_jax_tree``), inputs and gate noise (the reference's
  draws, passed in as tensors), at 1e-5.
* Every kernel wrapper's meta branch (``cuda_lib.meta_trace``; rows 1-8
  and the VJPs B5-B8) against its plain version on CPU tensors: the same
  shapes and dtypes; the fused kernels' meta branches allocate their
  workspace.
* ``core/dispatch.py::plan``'s scatter count against the bincount it
  replaced, integer for integer, and the plan and the ref dispatch on
  ``meta``.
* ``MemTrace`` on ``meta`` against the same step on real CPU tensors
  (the "ref" backend): the same peak and the same bytes in every
  category.
* In one subprocess with fake process groups: the reference's smoke cell
  (smollm-135m x decode_32k on (4, 4)) through ``run_cell``, rendered by
  ``launch/report.py``; a (1, 2) decode cell of the reduced kimi-k2,
  whose recorded collective bytes equal ``analyze_cell``'s wire bytes
  and what two gloo ranks send (``torch_dist_workers.case_decode_wire``);
  a pipelined step traced on (2, 2).
* A prefill step with its rows split (``steps.prefill_rows``) on two
  gloo ranks (``torch_dist_workers.case_prefill_rows``, mesh (1, 2)):
  2 rows (one a rank) and 1 row (whole on both ``model`` ranks) of a
  flat-MoE (kimi-k2) and a MoA (moa-demo) config; each rank's last
  logits and cache rows against JAX's ``lm_prefill`` of the whole
  batch, at 1e-5.  On a fake (2, 2) group a ``prefill`` cell of 8 and
  of 2 rows gives a rank 8 / 4 and 2 / 2 rows of the batch and of the
  cache.
* ``pp_analytic`` against the reference's on the production sizes (the
  reference's module in a fresh interpreter: it must be imported before
  jax).
* The dry run refuses a process whose process group is a real one.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_dist_workers as workers
from conftest import small_config
from test_torch_lm import (B, S, _dc, _jax_draws, _params, _tcfg,
                           _torch_params)
from test_torch_roofline import (WIRE_NEW, WIRE_PROMPT, WIRE_SLOTS,
                                 _wire_cfg)

from repro.common import param as jpm
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs import shapes as tshp
from repro_torch.configs.base import get_config
from repro_torch.core import dispatch as tdsp
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import topk_gating as ttopk
from repro_torch.launch import analytic as tana
from repro_torch.launch import dryrun, dryrun_pp
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIMI = "kimi-k2-1t-a32b"
TOL = 1e-5
REL = 1e-12


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"),
         os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _leaves(tree) -> list:
    return sorted(((jax.tree_util.keystr(p), leaf) for p, leaf in
                   jax.tree_util.tree_flatten_with_path(tree)[0]),
                  key=lambda kv: kv[0])


@pytest.fixture(scope="module")
def kimi():
    jcfg = small_config(KIMI)
    return jcfg, _tcfg(jcfg), _params(jcfg)


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# launch/steps.py against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(kimi, microbatches):
    """One step from the same state, batch and draws: the updated
    parameters and the metrics."""
    jcfg, tcfg, tree = kimi
    kw = dict(kind="factored", learning_rate=1e-3, warmup_steps=1)
    joc, toc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    batch = tdata.batch_at(tdata.DataConfig(**_dc(jcfg.vocab_size)), 0,
                           device="cpu")
    tokens, labels = batch["tokens"].numpy(), batch["labels"].numpy()
    seed = 3
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jstate["opt"] = jopt.init(jstate["params"], joc)
    jnew, jmet = jax.jit(jsteps.make_train_step_fn(
        jcfg, joc, None, microbatches))(
        jstate, {"tokens": jnp.asarray(tokens),
                 "labels": jnp.asarray(labels)}, seed)
    key = jax.random.PRNGKey(seed)
    keys = [key] if microbatches == 1 else list(
        jax.random.split(key, microbatches))
    draws = [_jax_draws(k, tcfg, t=B * S // microbatches) for k in keys]
    tp = _torch_params(tree)
    state = {"params": tp, "opt": topt.init(tp, toc)}
    _, tmet = tsteps.make_train_step_fn(tcfg, toc, None, microbatches)(
        state, {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)}, seed, draws=draws)
    assert {"loss", "xent", "aux_loss", "grad_norm"} <= set(tmet) & set(jmet)
    for k in set(tmet) & set(jmet):
        _close(tmet[k].detach(), jmet[k], f"metric {k}")
    got, want = _leaves(tp), _leaves(jnew["params"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        _close(g.detach(), w, f"updated {path}")


def test_prefill_and_decode_steps_match_jax(kimi):
    """A 32-token prefill, then three decode steps: logits and caches."""
    jcfg, tcfg, tree = kimi
    b, s, max_len = 2, 32, 40
    tokens = _tokens(jcfg.vocab_size, (b, s))
    jcache = jpm.materialize(jtransformer.cache_defs(jcfg, b, max_len),
                             jax.random.PRNGKey(0))
    tcache = tpm.zeros(ttransformer.cache_defs(tcfg, b, max_len), "cpu")
    tparams = from_jax_tree(tree, device="cpu")
    jl, jcache = jax.jit(jsteps.make_prefill_step_fn(jcfg, None))(
        tree, {"tokens": jnp.asarray(tokens)}, jcache)
    tl, tcache = tsteps.make_prefill_step_fn(tcfg, None)(
        tparams, {"tokens": torch.from_numpy(tokens)}, tcache)
    _close(tl, jl, "prefill logits")
    jdecode = jax.jit(jsteps.make_decode_step_fn(jcfg, None))
    tdecode = tsteps.make_decode_step_fn(tcfg, None)
    for i in range(3):
        nxt = _tokens(jcfg.vocab_size, (b,), seed=10 + i)
        cur = np.int32(s + i)
        jl, jcache = jdecode(tree, jnp.asarray(nxt), jcache, jnp.asarray(cur))
        tl, tcache = tdecode(tparams, torch.from_numpy(nxt), tcache,
                             torch.tensor(cur))
        _close(tl, jl, f"decode step {i} logits")
    for (path, g), (_, w) in zip(_leaves(tcache), _leaves(jcache)):
        _close(g, w, f"cache {path}")


def test_build_step_inputs_are_meta_at_full_width():
    """kimi-k2 x train_4k on one process: the whole state on meta, the
    microbatches of ``analytic.cfg_microbatches``."""
    cfg = get_config(KIMI)
    spec = tsteps.build_step(cfg, tshp.SHAPES["train_4k"])
    state, batch, seed = spec.args
    leaves = tpm.tree_leaves(state)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in tpm.tree_leaves(state["params"])) == \
        tpm.param_count(tlm.lm_defs(cfg))
    assert spec.microbatches == tana.cfg_microbatches(
        cfg, tshp.SHAPES["train_4k"], 1)
    assert tsteps._DONATE == {"train": (0,), "prefill": (2,), "decode": (2,)}


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branches
# ---------------------------------------------------------------------------

T, E, K, D, F, C = 12, 6, 2, 16, 24, 8


def _problem():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(T, E, generator=g)
    w, idx, _ = ttopk.topk_gating_plain(logits, K, K)
    p = tdsp.plan(idx, w, E, C)
    x = torch.randn(T, D, generator=g)
    return dict(
        logits=logits, w=p.weight, eidx=p.expert_index, pos=p.position,
        x=x, buf=torch.randn(E, C, D, generator=g),
        w1=torch.randn(E, D, F, generator=g) / 4,
        w2=torch.randn(E, F, D, generator=g) / 4,
        w3=torch.randn(E, D, F, generator=g) / 4,
        wg=torch.randn(D, E, generator=g), valid=torch.ones(T),
        rows=tdsp.filled_rows(p), dy=torch.randn(T, D, generator=g),
        dbuf=torch.randn(E, C, D, generator=g),
        dh=torch.randn(E, C, F, generator=g))


def _grads(fn, inputs, cotangent):
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, cotangent)


CASES = {
    "1 topk_gating": lambda a: ttopk.topk_gating(a["logits"], K, K + 1),
    "B5 topk_gating_bwd": lambda a: ttopk.topk_gating_bwd(
        a["w"], a["eidx"], a["dy"][:, :K].contiguous(),
        a["dy"][:, :K].contiguous(), E),
    "2 dispatch": lambda a: tdispatch.dispatch(
        a["x"], a["eidx"], a["pos"], n_experts=E, capacity=C),
    "3 dispatch_eblock": lambda a: tdispatch.dispatch_eblock(
        a["x"], a["eidx"], a["pos"], a["w"], n_experts=E, capacity=C,
        e_block=4),
    "4 combine": lambda a: tdispatch.combine(
        a["buf"], a["w"], a["eidx"], a["pos"]),
    "5 combine_eblock": lambda a: tdispatch.combine_eblock(
        a["buf"], a["w"], a["eidx"], a["pos"], e_block=4),
    "6 gmm": lambda a: tgmm.gmm(a["buf"], a["w1"], activation="silu",
                                rows=a["rows"]),
    "7 fused_decode": lambda a: tfd.decode_step(
        a["x"], a["valid"], a["wg"], a["w1"], a["w2"], a["w3"], k=K,
        capacity=C, activation="swiglu"),
    "8 fused_routed ffn": lambda a: tfd.routed_apply(
        a["x"], a["eidx"], a["pos"], a["eidx"], a["pos"], a["w"], a["w1"],
        a["w2"], n_experts=E, capacity=C),
    "8 fused_routed proj": lambda a: tfd.routed_apply(
        a["x"], a["eidx"], a["pos"], a["eidx"], a["pos"], a["w"], a["w1"],
        n_experts=E, capacity=C, mode="proj"),
    "B6 dispatch_bwd": lambda a: _grads(
        lambda x: tdispatch.DispatchFn.apply(x, a["eidx"], a["pos"], E, C,
                                             None), [a["x"]], a["dbuf"]),
    "B7 combine_bwd": lambda a: _grads(
        lambda buf, w: tdispatch.CombineFn.apply(buf, w, a["eidx"], a["pos"],
                                                 torch.float32, None),
        [a["buf"], a["w"]], a["dy"]),
    "B8 gmm_bwd": lambda a: _grads(
        lambda x, w: tgmm.GMMFn.apply(x, w, "silu", a["rows"]),
        [a["buf"], a["w1"]], a["dh"]),
}


def _specs(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_meta_branch_matches_the_plain_version(case):
    """The meta branch returns what the plain version returns (shapes
    and dtypes), launches nothing, and traces only in ``meta_trace``."""
    cpu = _problem()
    meta = {k: v.to("meta") for k, v in cpu.items()}
    want = _specs(CASES[case](cpu))
    cuda_lib.reset_launch_counts()
    mt = dryrun.MemTrace()
    mt.track(list(meta.values()), "inputs")
    base = mt.current
    with cuda_lib.meta_trace(), mt:
        got = _specs(CASES[case](meta))
    assert got == want
    assert cuda_lib.launch_counts() == {}
    assert mt.peak > base
    if case.startswith(("7", "8")):
        d_out = D if "proj" not in case else F
        decode = int(case.startswith("7"))
        mode = 0 if decode else tfd.MODES["proj" if "proj" in case
                                          else "ffn"]
        ws = tfd.workspace_bytes(decode, T, K, D, d_out,
                                 0 if "proj" in case else F, E, C, mode,
                                 tfd.ACTIVATIONS["swiglu"] if decode else 0,
                                 cuda_lib.DTYPE_CODES[torch.float32])
        assert mt.peak - base >= dryrun.alloc_bytes(ws) + \
            dryrun.alloc_bytes(T * d_out * 4)
    if not case.startswith("B"):
        with pytest.raises(cuda_lib.KernelLaunchError):
            CASES[case](meta)


def test_workspace_grows_with_its_regions():
    """The host mirror of the fused kernels' workspace layout: each
    region rounded to 256 bytes; the decode kernel's gate partials
    scale with ceil(d / 1024)."""
    f32 = cuda_lib.DTYPE_CODES[torch.float32]
    small = tfd.workspace_bytes(1, 8, 2, 1024, 1024, 64, 16, 8, 0, 1, f32)
    wide = tfd.workspace_bytes(1, 8, 2, 1025, 1025, 64, 16, 8, 0, 1, f32)
    assert small % 256 == 0 and wide - small >= 8 * 16 * 4
    assert tfd.workspace_bytes(0, 0, 1, 8, 8, 0, 1, 1, 2, 0, f32) > 1
    with pytest.raises(cuda_lib.KernelLaunchError):
        tfd.workspace_bytes(0, 4, 0, 8, 8, 0, 2, 8, 1, 0, f32)


# ---------------------------------------------------------------------------
# the plan's count and the ref dispatch
# ---------------------------------------------------------------------------

def _plan_by_bincount(expert_index, weight, n_experts, capacity, priority):
    """``core.dispatch.plan`` as it counted before: ``torch.bincount``."""
    t, k = expert_index.shape
    flat_e = expert_index.reshape(-1).long()
    flat_w = weight.float().reshape(-1)
    if priority:
        by_w = torch.argsort(-flat_w, stable=True)
        order = by_w[torch.argsort(flat_e[by_w], stable=True)]
    else:
        order = torch.argsort(flat_e * 2 + (flat_w <= 0).long(), stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k) - starts[sorted_e]
    pos_sorted = torch.where(flat_w[order] > 0, rank,
                             torch.full_like(rank, capacity))
    position = torch.empty_like(pos_sorted)
    position[order] = pos_sorted
    return position.reshape(t, k).to(torch.int32)


@pytest.mark.parametrize("priority", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_plan_count_equals_bincount(seed, priority):
    rs = np.random.RandomState(seed)
    t, k, e = 64, 3, 7
    eidx = torch.from_numpy(rs.randint(0, e, (t, k)).astype(np.int32))
    w = torch.from_numpy(rs.rand(t, k).astype(np.float32))
    w[torch.from_numpy(rs.rand(t) < 0.2)] = 0.0
    cap = 16
    p = tdsp.plan(eidx, w, e, cap, priority=priority)
    assert torch.equal(p.position,
                       _plan_by_bincount(eidx, w, e, cap, priority))
    m = tdsp.plan(eidx.to("meta"), w.to("meta"), e, cap, priority=priority)
    assert m.position.shape == p.position.shape and \
        m.position.dtype == torch.int32


def test_ref_dispatch_is_the_masked_scatter():
    a = _problem()
    p = tdsp.plan(a["eidx"], a["w"], E, 2)           # some dropped
    want = torch.zeros(E, 2, D)
    kept = p.position.reshape(-1) < 2
    rows = a["x"].repeat_interleave(K, dim=0)
    want[p.expert_index.reshape(-1)[kept].long(),
         p.position.reshape(-1)[kept].long()] = rows[kept]
    assert bool(kept.logical_not().any())
    assert torch.equal(tdsp.dispatch(a["x"], p), want)
    meta = tdsp.dispatch(a["x"].to("meta"), p._replace(
        expert_index=p.expert_index.to("meta"),
        position=p.position.to("meta")))
    assert meta.shape == want.shape


# ---------------------------------------------------------------------------
# MemTrace: meta against real CPU tensors
# ---------------------------------------------------------------------------

def _real(spec, cfg, seed=0):
    """``spec``'s arguments as real CPU tensors (random parameters,
    tokens in the vocabulary, zero caches)."""
    gen = torch.Generator().manual_seed(seed)
    defs = tlm.lm_defs(cfg)
    params = tpm.materialize(defs, gen, "cpu")

    def tok(t):
        return torch.randint(1, cfg.vocab_size, t.shape, generator=gen,
                             dtype=t.dtype)
    if spec.kind == "train":
        for p in tpm.tree_leaves(params):
            p.requires_grad_(True)
        state = {"params": params,
                 "opt": topt.init(params, topt.OptConfig())}
        batch = {k: tok(v) for k, v in spec.args[1].items()}
        return (state, batch, spec.args[2])
    _, inputs, cache, *rest = spec.args
    cache = tpm.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                         cache)
    if spec.kind == "prefill":
        return (params, {k: tok(v) for k, v in inputs.items()}, cache)
    return (params, tok(inputs), cache, *rest)


@pytest.mark.parametrize("kind,b,s", [("train", 2, 64), ("prefill", 2, 32),
                                      ("decode", 2, 48)])
def test_meta_trace_peak_equals_the_cpu_run(kind, b, s):
    cfg = _tcfg(small_config(KIMI)).replace(kernel_backend="ref")
    spec = tsteps.build_step(cfg, tshp.ShapeSpec(kind, kind, s, b))
    on_meta = dryrun.trace_step(spec)
    real = tsteps.StepSpec(**dict(vars(spec), args=_real(spec, cfg)))
    on_cpu = dryrun.trace_step(real)
    assert on_meta["memory"] == on_cpu["memory"]
    assert on_meta["memory"]["peak_bytes_per_device"] > 0
    if kind == "train":
        assert on_meta["memory"]["gradients"] > 0
    assert on_meta["flops"] == on_cpu["flops"] > 0


# ---------------------------------------------------------------------------
# cells under fake process groups (one subprocess)
# ---------------------------------------------------------------------------

_CELLS = """
import json, sys
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, dryrun_pp
from repro_torch.common.param import tree_leaves
from repro_torch.launch.steps import StepSpec, build_step, prefill_rows
from repro_torch.launch.train import reduced
from repro_torch.sharding.context import MeshContext
out = {"smoke": dryrun.run_cell("smollm-135m", "decode_32k", "4x4")}
slots, page = (int(a) for a in sys.argv[1:])
for fused in (False, True):
    cfg = reduced(get_config("kimi-k2-1t-a32b")).replace(
        kernel_backend="ref", fused_decode=fused)
    spec = build_step(cfg, ShapeSpec("decode", "decode", page, slots),
                      dryrun.fake_mesh({"data": 1, "model": 2}))
    out[f"fused={fused}"] = dryrun.trace_step(spec)["collectives"]
cfg = reduced(get_config("kimi-k2-1t-a32b")).replace(n_layers=3)
step, args = dryrun_pp.build_pp_step(
    cfg, ShapeSpec("t", "train", 32, 8), dryrun.fake_mesh(
        {"data": 2, "model": 2}), n_micro=2)
out["pp"] = dryrun.trace_step(StepSpec(step, args, "train", 2, []))
out["jamba"] = dryrun.run_cell("jamba-v0.1-52b", "decode_32k", "pod",
                               overrides={"n_layers": 8})
cfg = reduced(get_config("kimi-k2-1t-a32b")).replace(kernel_backend="ref")
mesh = dryrun.fake_mesh({"data": 2, "model": 2})
for rows in (8, 2):
    spec = build_step(cfg, ShapeSpec("prefill", "prefill", 32, rows), mesh)
    params, batch, cache = spec.args
    rec = dryrun.trace_step(spec)
    split = prefill_rows(MeshContext.for_mesh(mesh, "prefill_tp"), rows, 32)
    out[f"prefill{rows}"] = {
        "tokens": list(batch["tokens"].shape), "row_axes": split.row_axes,
        "cache": [list(t.shape) for t in tree_leaves(cache)],
        "peak": rec["memory"]["peak_bytes_per_device"],
        "gathers": rec["collectives"]["all_gather"]["calls"]}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The subprocess's records, and what two gloo ranks send in the
    (1, 2) decode cell."""
    params = tpm.materialize(tlm.lm_defs(_wire_cfg(False)),
                             torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    trace = [(rs.randint(1, _wire_cfg(False).vocab_size, (WIRE_PROMPT,)),
              WIRE_NEW, i) for i in range(WIRE_SLOTS)]
    sc = {"max_len": WIRE_PROMPT + WIRE_NEW, "n_slots": WIRE_SLOTS}
    wait = workers.start("decode_wire", tmp_path_factory.mktemp("wire"), {
        "cases": {f"fused={f}": {"cfg": _wire_cfg(f), "params": params,
                                 "sc": dict(sc, fused_decode=f),
                                 "trace": trace} for f in (False, True)}},
        1, 2)
    proc = subprocess.run([sys.executable, "-c", _CELLS, str(WIRE_SLOTS),
                           str(WIRE_PROMPT + WIRE_NEW)], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout), wait()


def test_smoke_cell_runs_and_renders(cells):
    from repro_torch.launch import report
    rec = cells[0]["smoke"]
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 16 and rec["fits"]
    assert rec["memory"]["peak_bytes_per_device"] > \
        rec["memory"]["parameters"] > 0
    assert rec["collectives"]["all_gather"]["calls"] > 0
    table = report.dryrun_table([rec], "4x4")
    assert "| smollm-135m | decode_32k | ok |" in table
    assert "smollm-135m" in report.roofline_table([rec], "4x4")
    assert report.summary([rec]).startswith("1 compiled ok")
    head, _, row = table.splitlines()
    assert head.endswith("| dry-run peak GiB/dev | fits 80 GB "
                         "| measured peak GiB/dev | fallbacks | trace s |")
    peak = report.fmt_bytes(rec["memory"]["peak_bytes_per_device"])
    assert f"| {peak} | yes | — |" in row
    assert row.endswith(f"| {rec['trace_s']} |")


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
def test_decode_cell_sends_the_analytic_and_the_gloo_bytes(cells, fused):
    traced, ranks = cells
    got = sum(r["bytes"] for r in traced[f"fused={fused}"].values())
    want = tana.analyze_cell(
        _wire_cfg(fused), tshp.ShapeSpec("decode", "decode",
                                         WIRE_PROMPT + WIRE_NEW, WIRE_SLOTS),
        {"data": 1, "model": 2}, "decode_std").wire_bytes_per_dev
    assert got == pytest.approx(want, rel=REL) and got > 0
    for rank in ranks:
        sent = rank[f"fused={fused}"]
        assert sent["bytes"] / sent["calls"] == pytest.approx(got, rel=REL)


def test_jamba_decode_cell_traces_on_a_fake_mesh(cells):
    """jamba at full width cut to one period (8 layers: 7 mamba, 1
    attention, 4 MoE) at decode_32k on the (16, 16) pod: the decode step
    traces, its state whole and its attention page over model (the
    inputs: 8 slots a rank of 7 whole states and 2,048 positions of one
    page), the experts' slab outputs and the attention merge gathered."""
    rec = cells[0]["jamba"]
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 256 and rec["fits"]
    cfg = get_config("jamba-v0.1-52b")
    d_in, slots = cfg.ssm_expand * cfg.d_model, 128 // 16
    state = 7 * slots * (d_in * cfg.ssm_d_state * 4
                         + (cfg.ssm_d_conv - 1) * d_in * 2)
    page = 2 * slots * (32768 // 16) * cfg.n_kv_heads * cfg.head_dim * 2
    assert rec["memory"]["inputs"] == pytest.approx(state + page, rel=1e-3)
    assert rec["memory"]["peak_bytes_per_device"] > \
        rec["memory"]["parameters"] > 0
    assert rec["collectives"]["all_gather"]["calls"] > 0


@pytest.mark.parametrize("rows,mine,axes", [(8, 2, ["data", "model"]),
                                             (2, 1, ["data"])])
def test_prefill_cell_holds_its_rows_on_a_fake_mesh(cells, rows, mine,
                                                    axes):
    """The reduced kimi-k2 (32 tokens a row) on a fake (2, 2) group: 8
    rows split over every rank, 2 rows over ``data`` (whole on both
    ``model`` ranks); a rank's tokens and cache are its ``rows / n``
    rows (the cache of that many rows, leaf for leaf; where the rows are
    whole on ``model`` an attention page holds half the key / value
    heads, which run tensor-parallel there), the step traces and the
    MoE layers gather the rows they route."""
    from repro_torch.launch.train import reduced
    rec = cells[0][f"prefill{rows}"]
    assert rec["row_axes"] == axes
    assert rec["tokens"] == [mine, 32]
    cfg = reduced(get_config(KIMI))
    want = [list(d.shape) for d in tpm.tree_leaves(
        ttransformer.cache_defs(cfg, mine, 32))]
    if "model" not in axes:
        for shape in want:
            shape[-2] //= 2
    assert rec["cache"] == want
    assert rec["peak"] > 0 and rec["gathers"] > 0


def test_pipelined_step_traces_on_a_fake_mesh(cells):
    pp = cells[0]["pp"]
    assert pp["memory"]["peak_bytes_per_device"] > 0
    assert pp["collectives"]["shift"]["calls"] > 0
    assert pp["memory"]["activations"] > 0


# ---------------------------------------------------------------------------
# a prefill step's rows on two gloo ranks
# ---------------------------------------------------------------------------

PREFILL_MAX_LEN = 40


@pytest.fixture(scope="module")
def prefill_ranks(tmp_path_factory, kimi):
    """The ranks' rows of each case (started first), and JAX's
    ``lm_prefill`` of each case's whole batch."""
    moa_j = small_config("moa-demo")
    models = {"kimi": kimi, "moa": (moa_j, _tcfg(moa_j), _params(moa_j))}
    cases, want = {}, {}
    for name, (jcfg, tcfg, tree) in models.items():
        for b in (2, 1):
            tokens = _tokens(jcfg.vocab_size, (b, 32), seed=b)
            cases[f"{name}-{b}"] = {"cfg": tcfg, "tokens": torch.from_numpy(
                tokens), "params": from_jax_tree(tree, device="cpu"),
                "max_len": PREFILL_MAX_LEN}
            want[f"{name}-{b}"] = (jcfg, tree, tokens)
    wait = workers.start("prefill_rows", tmp_path_factory.mktemp("prefill"),
                         cases, 1, 2)
    for key, (jcfg, tree, tokens) in want.items():
        cache = jpm.materialize(jtransformer.cache_defs(
            jcfg, tokens.shape[0], PREFILL_MAX_LEN), jax.random.PRNGKey(0))
        want[key] = jax.jit(jsteps.make_prefill_step_fn(jcfg, None))(
            tree, {"tokens": jnp.asarray(tokens)}, cache)
    return wait(), want


@pytest.mark.parametrize("case", ["kimi-2", "kimi-1", "moa-2", "moa-1"])
def test_prefill_rows_on_two_ranks_match_jax(prefill_ranks, case):
    """2 rows split one a rank (over ``data`` and ``model``), or 1 row
    whole on both ``model`` ranks (over ``data``, of size 1): each
    rank's last logits and cache rows are JAX's one process's rows (of
    an attention page, the rank's key / value heads where the whole
    rows run them tensor-parallel)."""
    ranks, want = prefill_ranks
    jl, jcache = want[case]
    b = int(case[-1])
    for rank in ranks:
        got = rank[case]
        rows = got["rows"].numpy()
        assert got["row_axes"] == (("data", "model") if b == 2
                                   else ("data",))
        assert len(rows) == (1 if b == 2 else b)
        _close(got["logits"], np.asarray(jl)[rows], f"{case} logits")
        for (path, g), (_, w) in zip(_leaves(got["cache"]),
                                     _leaves(jcache)):
            # The stacked periods lead with the layers, the tail with
            # the rows.
            w = np.asarray(w)
            w = w[rows] if "tail" in path else w[:, rows]
            if g.shape[-2] < w.shape[-2]:
                n = g.shape[-2]
                w = w[..., got["kv_index"] * n:(got["kv_index"] + 1) * n, :]
            _close(g, w, f"{case} cache {path}")
    if b == 2:
        assert [int(r[case]["rows"][0]) for r in ranks] == [0, 1]


# ---------------------------------------------------------------------------
# pp_analytic against the reference
# ---------------------------------------------------------------------------

_PP_REF = """
import json, sys, types
import repro.launch.dryrun_pp as pp
from repro.configs import shapes as shp
from repro.configs.base import get_config
mesh = types.SimpleNamespace(shape={"data": 16, "model": 16}, size=256)
out = {a: pp.pp_analytic(get_config(a), shp.SHAPES["train_4k"], mesh, 16, 64)
       for a in sys.argv[1:]}
json.dump(out, sys.stdout)
"""
PP_ARCHS = (KIMI, "qwen3-1.7b")
PP_COUNTS = ("flops_per_dev", "hbm_bytes_per_dev", "wire_bytes_per_dev",
             "bubble_overhead", "pad_ratio", "resident_bytes_per_dev")


@pytest.fixture(scope="module")
def pp_reference():
    proc = subprocess.run([sys.executable, "-c", _PP_REF, *PP_ARCHS],
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)


@pytest.mark.parametrize("arch", PP_ARCHS)
def test_pp_analytic_matches_reference(pp_reference, arch):
    got = dryrun_pp.pp_analytic(get_config(arch), tshp.SHAPES["train_4k"],
                                {"data": 16, "model": 16}, 16, 64)
    want = pp_reference[arch]
    for k in PP_COUNTS:
        assert got[k] == pytest.approx(want[k], rel=REL), k
    assert got["compute_s"] == pytest.approx(
        got["flops_per_dev"] / 989e12, rel=REL)
    assert got["collective_s"] == pytest.approx(
        got["wire_bytes_per_dev"] / 450e9, rel=REL)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def test_dry_run_refuses_a_real_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.run_cell("smollm-135m", "decode_32k", "1x1")
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
