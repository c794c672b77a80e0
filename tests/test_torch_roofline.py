"""The port's roofline arithmetic against the JAX package's.

* ``launch.analytic.analyze_cell`` equals the reference's (wide
  dispatch off) for every arch of ``repro.launch.dryrun.ALL_ARCHS`` x
  the shapes ``cell_supported`` admits x the meshes (16, 16) and (2, 16,
  16), with the reference's ``resolve_spec`` fed a stand-in mesh that
  carries only ``shape`` and ``size``.  Three terms are the port's own
  and are held to hand counts here: a training step's dense
  tensor-parallel wire bytes (``_train_tp_counts``, in place of the
  reference's two all-reduces a layer), the serving wire bytes
  (``moe_apply_serve``'s gathers, its all-reduce of the d_ff slices'
  f32 partial sums and its fused all-reduce, the decode rows' gathers,
  ``attend_cached_sharded``'s three gathers; a prefill step whose rows
  stay whole on ``model`` all-reduces its dense layers' outputs and
  all-gathers its last logits there, ``_prefill_tp_counts``) and the
  serving MoE weight bytes (``min(E, k x T)`` experts read).
* ``configs.shapes`` and the ``common.param`` helpers equal the
  reference's; ``abstract`` builds ``meta`` tensors of a full kimi-k2.
* ``launch.roofline``'s terms with the H100's constants, its
  ``model_flops`` against the reference's, and ``chip_smoke.py``'s
  bound against the same table.
* ``launch.report``'s tables against the reference's strings.
* The analytic FLOPs against ``torch.utils.flop_counter.FlopCounterMode``
  on the CPU, one train step and one prefill per layer kind at
  ``--reduce`` widths.
"""
import ast
import importlib.util
import json
import math
import os
import types

import jax  # noqa: F401  (the reference's modules import it)
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from torch.utils.flop_counter import FlopCounterMode

from repro.common import param as jpm
from repro.configs import shapes as jshp
from repro.configs.base import get_config as jget
from repro.core.dispatch import capacity_for as jcapacity
from repro.launch import analytic as jana
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro.models import lm as jlm
from repro.sharding import partition as jpart
from repro_torch.common import param as tpm
from repro_torch.configs import shapes as tshp
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import layer_kinds, n_periods
from repro_torch.launch import analytic as tana
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as trl
from repro_torch.launch.train import reduced
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-12


def _all_archs() -> tuple:
    """``ALL_ARCHS`` of the reference's dryrun, read from its source:
    importing that module forces 512 host devices and refuses to load
    after jax."""
    with open(os.path.join(REPO, "src/repro/launch/dryrun.py")) as f:
        tree = ast.parse(f.read())
    return next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "ALL_ARCHS")


ARCHS = _all_archs()
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(arch, shape, mesh) for mesh in MESHES for arch in ARCHS
         for shape in jshp.SHAPES if jshp.cell_supported(jget(arch),
                                                         shape)[0]]


def _jmesh(sizes: dict):
    """What the reference's analytic reads of a mesh."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 size=math.prod(sizes.values()))


def _nshards(plan, sizes, shape, axes, dim=None) -> int:
    """Devices a tensor (or its dimension ``dim``) is split across, by
    the reference's resolve_spec."""
    spec = jpart.resolve_spec(jpart.PLANS[plan], _jmesh(sizes), shape, axes)
    entries = spec if dim is None else [spec[dim]]
    n = 1
    for e in entries:
        for ax in (() if e is None else (e,) if isinstance(e, str) else e):
            n *= sizes[ax]
    return n


def _train_tp_counts(cfg, shape, sizes, plan) -> tuple[float, float]:
    """(the reference's tensor-parallel train charge, the port's) by
    hand.  The reference charges 2 all-reduces of [tokens, d] a step for
    each attention, mamba and dense FFN layer on every cell.  The port
    runs them only where a microbatch's rows do not divide over the
    devices (whole on ``model``): an attention layer whose heads divide
    over ``model`` forward and backward, and again in remat's recompute
    of a stacked period's layer; a dense FFN whose d_ff divides, forward
    and backward; a vocabulary that divides, the embedding forward and
    backward and each loss chunk's f32 max (twice) and packed sums
    (three times)."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    bs = _nshards(plan, sizes, (B,), ("batch",))
    m = sizes["model"]
    share = 2 * (m - 1) / m
    nbytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    ref = port = 0.0
    mbs = tana.cfg_microbatches(cfg, shape, bs)
    rows = B // mbs
    whole = rows % math.prod(sizes.values()) != 0
    rows_loc = rows // _nshards(plan, sizes, (rows,), ("batch",))
    exit_b = rows_loc * S * d * nbytes
    for pos, lk in enumerate(kinds):
        r = full + (1 if pos < rem else 0)
        n = (lk.mixer in ("attn", "attn_local", "mamba")) + (
            lk.ffn in ("dense", "moe+dense"))
        ref += r * n * 2 * (B * S / bs) * d * nbytes * share
        if whole and lk.mixer in ("attn", "attn_local") \
                and cfg.n_heads % m == 0:
            port += (2 * r + (full if cfg.remat else 0)) * share * exit_b
        if whole and lk.ffn in ("dense", "moe+dense") and cfg.d_ff % m == 0:
            port += 2 * r * share * exit_b
    if whole and cfg.vocab_size % m == 0:
        port += share * (2 * exit_b + 8 * rows_loc * S * 4)
    return ref, mbs * port


def _prefill_tp_counts(cfg, B, S, sizes, plan) -> float:
    """A prefill step's dense tensor parallelism by hand: where its B
    rows do not divide over the devices they stay whole on ``model``,
    and each attention layer whose heads divide over it, each dense FFN
    whose d_ff does and the embedding all-reduce the rank's [B / bs, S,
    d] in the compute dtype; a vocabulary that divides all-gathers the
    last logits, [B / bs, V / M] f32."""
    if B % math.prod(sizes.values()):
        bs = _nshards(plan, sizes, (B,), ("batch",))
        m = sizes["model"]
        share = 2 * (m - 1) / m
        exit_b = (B // bs) * S * cfg.d_model * torch.empty(
            (), dtype=cfg.compute_dtype).element_size()
        kinds = layer_kinds(cfg)
        full, rem = n_periods(cfg)
        wire = 0.0
        for pos, lk in enumerate(kinds):
            r = full + (1 if pos < rem else 0)
            if lk.mixer in ("attn", "attn_local") and cfg.n_heads % m == 0:
                wire += r * share * exit_b
            if lk.ffn in ("dense", "moe+dense") and cfg.d_ff % m == 0:
                wire += r * share * exit_b
        if cfg.vocab_size % m == 0:
            wire += share * exit_b + (m - 1) * (B // bs) * (
                cfg.vocab_size // m) * 4
        return wire
    return 0.0


def _serve_counts(cfg, shape, sizes, plan) -> tuple[float, float]:
    """The port's serving charges by hand: (wire bytes a device sends,
    expert bytes a step does not read)."""
    kind, B, S, d = shape.kind, shape.global_batch, shape.seq_len, \
        cfg.d_model
    bs = _nshards(plan, sizes, (B,), ("batch",))
    tokens = B if kind == "decode" else B * S
    kinds = layer_kinds(cfg)
    full, rem = n_periods(cfg)
    wire = unread = 0.0
    for pos, lk in enumerate(kinds):
        r = full + (1 if pos < rem else 0)
        if lk.mixer in ("attn", "attn_local") and kind == "decode":
            length = min(cfg.sliding_window, S) if (
                lk.mixer == "attn_local" and cfg.sliding_window) else S
            g = _nshards(plan, sizes, (B, length, cfg.n_kv_heads,
                                       cfg.head_dim),
                         ("batch", "kv_seq", "kv_heads", "head_dim"), 1)
            # maxima [B, H] + sums [B, H] + values [B, H, hd], f32
            wire += r * (g - 1) * (B // bs) * cfg.n_heads * 4 \
                * (1 + 1 + cfg.head_dim)
        if lk.ffn in ("moe", "moe+dense"):
            E, k, ff = cfg.n_experts, cfg.moe_k, cfg.moe_d_ff
            g = _nshards(plan, sizes, (E, d, ff),
                         ("experts", "expert_embed", "expert_mlp"), 0)
            # the d_ff slices of each expert (expert_mlp over data)
            f_sh = _nshards(plan, sizes, (E, d, ff),
                            ("experts", "expert_embed", "expert_mlp"), 2)
            cap = jcapacity(tokens, E, k, cfg.capacity_factor)
            if kind == "decode":
                # this rank's rows [B/bs, d] bf16 and mask [B/bs] f32
                wire += r * (bs - 1) * (B // bs) * (2 * d + 4)
            if kind == "decode" and cfg.fused_decode:
                # [T, d] f32 over the g x f_sh ranks in one group where
                # they are the whole mesh, else over each axis in turn
                n = g * f_sh
                spread = math.prod(v for v in sizes.values() if v > 1)
                share = (2 * (n - 1) / n if n == spread else
                         2 * (g - 1) / g + 2 * (f_sh - 1) / f_sh)
                wire += r * share * tokens * d * 4
            else:
                wire += r * (g - 1) * (E // g) * cap * d * 2
                # the slices' f32 partial sums [E/g, C, d], all-reduced
                wire += r * 2 * (f_sh - 1) / f_sh * (E // g) * cap * d * 4
            m_e = _nshards(plan, sizes, (E, d, ff),
                           ("experts", "expert_embed", "expert_mlp"))
            n_mat = 3 if cfg.activation in ("swiglu", "geglu") else 2
            unread += r * (E - min(E, k * tokens)) * d * ff * n_mat * 2 / m_e
    if kind == "prefill":
        wire += _prefill_tp_counts(cfg, B, S, sizes, plan)
    return wire, unread


def _close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1.0), (what, got, want)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_analyze_cell_matches_reference(arch, shape, mesh):
    sizes = MESHES[mesh]
    plan = jpart.plan_for(shape)
    want = jana.analyze_cell(jget(arch).replace(moe_wide_dispatch=False),
                             jshp.SHAPES[shape], _jmesh(sizes), plan)
    tcfg = tget(arch)
    got = tana.analyze_cell(tcfg, tshp.SHAPES[shape], sizes, plan)
    _close(got.flops_per_dev, want.flops_per_dev, "flops")
    assert got.detail.keys() == want.detail.keys()
    for k, v in want.detail.items():
        _close(got.detail[k], v, k)
    if jshp.SHAPES[shape].kind == "train":
        ref_tp, port_tp = _train_tp_counts(tcfg, tshp.SHAPES[shape], sizes,
                                           plan)
        _close(got.wire_bytes_per_dev,
               want.wire_bytes_per_dev - ref_tp + port_tp, "wire")
        _close(got.hbm_bytes_per_dev, want.hbm_bytes_per_dev, "hbm")
    else:
        wire, unread = _serve_counts(tcfg, tshp.SHAPES[shape], sizes, plan)
        _close(got.wire_bytes_per_dev, wire, "serving wire")
        _close(got.hbm_bytes_per_dev, want.hbm_bytes_per_dev - unread,
               "serving hbm")
    rec = {"n_devices": math.prod(sizes.values()),
           "kind": jshp.SHAPES[shape].kind,
           "global_batch": jshp.SHAPES[shape].global_batch,
           "seq_len": jshp.SHAPES[shape].seq_len,
           "analytic": {"flops_per_dev": got.flops_per_dev,
                        "hbm_bytes_per_dev": got.hbm_bytes_per_dev,
                        "wire_bytes_per_dev": got.wire_bytes_per_dev}}
    frac = trl.roofline_fraction(trl.analyze(rec, tcfg), rec["n_devices"])
    assert 0.0 < frac <= 1.0, frac


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
@pytest.mark.parametrize("sizes", [{"data": 1, "model": 2},
                                   {"data": 2, "model": 4}],
                         ids=["1x2", "2x4"])
def test_serving_wire_of_a_decode_step(sizes, fused):
    """kimi-k2 (one layer) decoding 8 slots of 48 positions, as the mesh
    serving phase of chip_smoke runs it, unfused and fused."""
    cfg = tget("kimi-k2-1t-a32b", n_layers=1, fused_decode=fused)
    shape = tshp.ShapeSpec("decode", "decode", 48, 8)
    got = tana.analyze_cell(cfg, shape, sizes, "decode_std")
    wire, _ = _serve_counts(cfg, shape, sizes, "decode_std")
    _close(got.wire_bytes_per_dev, wire, "wire")
    if sizes == {"data": 1, "model": 2}:
        # One MoE layer's expert outputs [192, 8, 7168] bf16, or its
        # partial sums [8, 7168] f32; the attention's gathers [8, 64]
        # x 2 and [8, 64, 128] f32.
        moe = 8 * 7168 * 4 if fused else 192 * 8 * 7168 * 2
        assert got.wire_bytes_per_dev == moe + 8 * 64 * 130 * 4


WIRE_MESHES = ((1, 2), (2, 2))
WIRE_SLOTS, WIRE_PROMPT, WIRE_NEW = 8, 32, 4


def _wire_cfg(fused: bool):
    return reduced(tget("kimi-k2-1t-a32b")).replace(
        kernel_backend="ref", fused_decode=fused)


@pytest.fixture(scope="module")
def decode_wire(tmp_path_factory):
    """Reduced kimi-k2 served on gloo ranks, meshes (1, 2) and (2, 2),
    unfused and fused: each rank's collective bytes inside its decode
    calls (torch_dist_workers.case_decode_wire)."""
    params = tpm.materialize(tlm.lm_defs(_wire_cfg(False)),
                             torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    vocab = _wire_cfg(False).vocab_size
    trace = [(rs.randint(1, vocab, (WIRE_PROMPT,)), WIRE_NEW, i)
             for i in range(WIRE_SLOTS)]
    sc = {"max_len": WIRE_PROMPT + WIRE_NEW, "n_slots": WIRE_SLOTS}
    cases = {f"fused={f}": {"cfg": _wire_cfg(f), "params": params,
                            "sc": dict(sc, fused_decode=f), "trace": trace}
             for f in (False, True)}
    waits = {mesh: workers.start(
        "decode_wire", tmp_path_factory.mktemp(f"wire{mesh[0]}x{mesh[1]}"),
        {"cases": cases}, *mesh) for mesh in WIRE_MESHES}
    return {mesh: wait() for mesh, wait in waits.items()}


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
@pytest.mark.parametrize("mesh", WIRE_MESHES, ids=["1x2", "2x2"])
def test_decode_wire_equals_what_the_ranks_send(decode_wire, mesh, fused):
    """The analytic wire bytes of a decode step against the ring bytes
    each rank's collectives send ((g-1) x the input of an all-gather,
    2(g-1)/g x an all-reduce's tensor, by the size g of the call's
    group): on (2, 2) the unfused step all-reduces the d_ff slices'
    partial sums over ``data`` (g = 2), the fused one its partial
    outputs over both axes (g = 4)."""
    shape = tshp.ShapeSpec("decode", "decode", WIRE_PROMPT + WIRE_NEW,
                           WIRE_SLOTS)
    want = tana.analyze_cell(_wire_cfg(fused), shape,
                             dict(zip(("data", "model"), mesh)),
                             "decode_std").wire_bytes_per_dev
    assert want > 0
    for rank in decode_wire[mesh]:
        got = rank[f"fused={fused}"]
        assert got["calls"] >= WIRE_NEW - 1
        assert got["bytes"] / got["calls"] == pytest.approx(want, rel=REL)


def test_shapes_match_reference():
    assert {k: vars(v) for k, v in tshp.SHAPES.items()} == \
        {k: vars(v) for k, v in jshp.SHAPES.items()}


def _dt(dtype) -> str:
    return str(np.dtype(dtype)) if not isinstance(dtype, torch.dtype) \
        else str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_specs_match_reference(arch):
    """cell_supported, logical_batch_axes, batch_inputs and cache_specs
    for every shape; the caches and inputs are meta tensors."""
    jcfg, tcfg = jget(arch), tget(arch)
    for name, shape in tshp.SHAPES.items():
        assert tshp.cell_supported(tcfg, name) == \
            jshp.cell_supported(jcfg, name)
        jshape = jshp.SHAPES[name]
        assert tshp.logical_batch_axes(tcfg, shape) == \
            jshp.logical_batch_axes(jcfg, jshape)
        got = tshp.batch_inputs(tcfg, shape)
        want = jshp.batch_inputs(jcfg, jshape)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _dt(got[k].dtype)) == \
                (tuple(want[k].shape), _dt(want[k].dtype))
        if name == "train_4k":
            continue
        tcache, tdefs = tshp.cache_specs(tcfg, shape)
        jcache, _ = jshp.cache_specs(jcfg, jshape)
        leaves = tpm.tree_leaves(tcache)
        assert all(t.device.type == "meta" for t in leaves)
        assert [(tuple(t.shape), _dt(t.dtype)) for t in leaves] == \
            [(tuple(a.shape), _dt(a.dtype))
             for a in jax.tree_util.tree_leaves(jcache)]
        assert tpm.param_count(tcache) == tpm.param_count(tdefs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_helpers_match_reference(arch):
    """param_count of the full model's defs, logical_specs, and
    abstract's meta tensors (a full kimi-k2 allocates nothing)."""
    tdefs, jdefs = tlm.lm_defs(tget(arch)), jlm.lm_defs(jget(arch))
    assert tpm.param_count(tdefs) == jpm.param_count(jdefs)
    got = tpm.abstract(tdefs)
    leaves = tpm.tree_leaves(got)
    assert all(t.device.type == "meta" for t in leaves)
    assert [(tuple(t.shape), _dt(t.dtype)) for t in leaves] == \
        [(tuple(a.shape), _dt(a.dtype))
         for a in jax.tree_util.tree_leaves(jpm.abstract(jdefs))]
    assert tpm.param_count(got) == tpm.param_count(tdefs)
    assert {_dt(t.dtype) for t in tpm.tree_leaves(
        tpm.abstract(tdefs, torch.float32))} == {"float32"}
    jspecs = jax.tree_util.tree_leaves(
        jpm.logical_specs(jdefs),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tspecs = tpm.tree_leaves(tpm.logical_specs(tdefs))
    assert tspecs == [tuple(p) for p in jspecs]


def _record(flops, hbm, wire, kind="train"):
    return {"n_devices": 256, "kind": kind, "global_batch": 256,
            "seq_len": 4096,
            "analytic": {"flops_per_dev": flops, "hbm_bytes_per_dev": hbm,
                         "wire_bytes_per_dev": wire}}


def test_roofline_terms_and_dominance():
    h = trl.H100
    rec = _record(989e12, 3.35e12 / 2, 450e9 * 2)   # 1 s, 0.5 s, 2 s
    r = trl.analyze(rec, tget("llama3-8b"))
    assert r.dominant == "collective"
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(2.0)
    assert r.bound_step_s == pytest.approx(2.0)
    assert 0 < trl.roofline_fraction(r, 256) < 1
    # The compute term runs at the peak of the config's compute dtype.
    f32 = trl.analyze(_record(67e12, 0.0, 0.0),
                      tget("llama3-8b", compute_dtype=torch.float32))
    assert f32.compute_s == pytest.approx(1.0) and f32.dominant == "compute"
    assert h["hbm_bandwidth"] == 3.35e12
    assert h["peak_flops"] == {"bfloat16": 989e12, "tf32": 495e12,
                               "float32": 67e12}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    for kind in ("train", "prefill", "decode"):
        assert trl.model_flops(tget(arch), kind, 8, 512) == \
            jrl.model_flops(jget(arch), kind, 8, 512)


def test_chip_smoke_bounds_use_the_roofline_table():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.h100() is trl.H100
    # 3.35 GB at 3.35 TB/s is 1 ms; 989 GFLOP in bf16 is 1 ms.
    ms, by = smoke.bound_ms(3.35e9, {"bfloat16": 0.5e9})
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = smoke.bound_ms(0.0, {"bfloat16": 989e9})
    assert ms == pytest.approx(1.0) and by == "operations"


def _report_records() -> list:
    ok = [{"arch": a, "shape": s, "mesh": "pod", "status": "ok",
           "analytic": {"resident_bytes_per_dev": 3.5 * 2**30},
           "roofline": {"compute_s": 0.0123, "memory_s": 0.00456,
                        "collective_s": 0.0789, "dominant": dom,
                        "model_flops": 1.234e15, "useful_ratio": 0.7512,
                        "roofline_fraction": 0.1234}}
          for a, s, dom in (("llama3-8b", "train_4k", "collective"),
                            ("qwen3-1.7b", "decode_32k", "memory"))]
    return ok + [
        {"arch": "smollm-135m", "shape": "long_500k", "mesh": "pod",
         "status": "skipped"},
        {"arch": "kimi-k2-1t-a32b", "shape": "train_4k", "mesh": "pod",
         "status": "error", "error": "x" * 60},
        dict(ok[0], mesh="multipod")]


def test_report_matches_reference():
    recs = _report_records()
    for mesh in ("pod", "multipod"):
        assert treport.roofline_table(recs, mesh) == \
            jreport.roofline_table(recs, mesh)
    assert treport.summary(recs) == jreport.summary(recs)
    table = treport.dryrun_table(
        [dict(recs[0], measured_peak_bytes=4 * 2**30), recs[1]] + recs[2:],
        "pod").splitlines()
    assert table[2] == "| llama3-8b | train_4k | ok | 3.50 | 4.00 | 0 |"
    assert table[3] == "| qwen3-1.7b | decode_32k | ok | 3.50 | — | 0 |"
    assert len(table) == 6
    # The reference's report is pure Python over the records.
    with open(os.path.join(REPO, "src/repro/launch/report.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "jax" not in names


def test_report_cli(tmp_path, capsys):
    path = tmp_path / "records.jsonl"
    recs = _report_records()
    path.write_text("".join(json.dumps(r) + "\n"
                            for r in recs + [recs[0]]))
    treport.main([str(path)])
    out = capsys.readouterr().out
    assert treport.summary(recs) in out
    assert treport.roofline_table(recs, "multipod") in out
    assert out.count("| llama3-8b | train_4k |") == 4   # deduplicated


# A layer kind -> an arch that has it; at reduced widths (launch/train's
# reduced()), f32, the plain backend.
KIND_ARCH = {"attn": "llama3-8b", "attn_local": "gemma3-27b",
             "mamba": "falcon-mamba-7b", "dense": "qwen3-1.7b",
             "moe": "kimi-k2-1t-a32b", "moe+dense": "arctic-480b"}
FLOP_B, FLOP_S = 2, 64


@pytest.mark.parametrize("step", ["train", "prefill"])
@pytest.mark.parametrize("kind", list(KIND_ARCH))
def test_analytic_flops_match_flop_counter(kind, step):
    """The analytic FLOPs of one step over FlopCounterMode's count of the
    port's aten products, within the reference's band against XLA
    (0.7-1.45: the analytic counts elementwise scan work, capacity
    slots and the causal blocks' halves its own way)."""
    cfg = reduced(tget(KIND_ARCH[kind])).replace(kernel_backend="ref")
    assert any(kind in (lk.mixer, lk.ffn) for lk in layer_kinds(cfg))
    gen = torch.Generator().manual_seed(0)
    params = tpm.tree_map(lambda t: t.requires_grad_(step == "train"),
                          tpm.materialize(tlm.lm_defs(cfg), gen, "cpu"))
    tokens = torch.randint(1, cfg.vocab_size, (FLOP_B, FLOP_S),
                           generator=gen, dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        if step == "train":
            loss, _ = tlm.lm_loss(params, {"tokens": tokens,
                                           "labels": tokens}, cfg,
                                  generator=gen)
            loss.backward()
        else:
            cache = tpm.zeros(ttransformer.cache_defs(cfg, FLOP_B, FLOP_S),
                              "cpu")
            tlm.lm_prefill(params, {"tokens": tokens}, cache, cfg)
    counted = counter.get_total_flops()
    shape = tshp.ShapeSpec(step, step, FLOP_S, FLOP_B)
    plan = "dp_tp_ep" if step == "train" else "prefill_tp"
    ana = tana.analyze_cell(cfg, shape, {"data": 1, "model": 1}, plan)
    ratio = ana.flops_per_dev / counted
    assert 0.7 < ratio < 1.45, (ratio, ana.flops_per_dev, counted)
