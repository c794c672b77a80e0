"""The row split (``MeshContext.split_rows``) where a batch's rows do not
divide over the ranks, against the JAX package.

The reference's ``dp_tp_ep`` plan puts the batch over ``("pod", "data")``
and the MoE's flattened tokens over every axis, so a global batch of
fewer rows than ranks trains there.  The port splits such rows over the
plan's ``batch`` axes, each row whole on the ``model`` ranks, whose flat
MoE layers take their share of its tokens; MoA and the hierarchical MoE
gather the rows over the ``batch`` axes only.

* Four gloo ranks (``torch_dist_workers.py``, ``case_rows``) take a
  global batch of 2 rows on (1, 4), where every row is whole on all
  four, and on (2, 2), one row a ``data`` rank: the trainer's gradients
  (``make_grad_fn``, ``loss / world`` and the replica sums) and metrics
  from the JAX draws against JAX's one-process ``lm_loss`` /
  ``paper_lm_loss`` and ``jax.grad``, for the small kimi-k2 (flat MoE, no
  shard drops a token), the small paper LM (dropout masks split by row,
  gate noise by token) and the small moa-demo (MoA drops at its own
  capacity factor 1); and the metrics from a step generator against the
  single-process port's at the same seed (each rank draws the global
  batch's noise).
* The rule alone, on stand-in meshes: where rows do not divide, the
  axes they split over are the reference's resolved ``batch`` axes
  (with its divisibility fallback; none inside a pipeline stage), and
  where the tokens do not divide either the split raises.
* Under fake process groups, in one subprocess: ``run_cell`` of a
  training cell with 16 rows of 4,096 on a (2, 4, 4) mesh traces, with
  the reference's microbatch count (``cfg_microbatches`` of the 8 ranks
  of the ``batch`` axes: 2 microbatches of 8 rows over 32 ranks), and
  ``build_pp_step`` with 2 rows a microbatch over 4 ``model`` ranks
  traces.

Tolerances: ``test_torch_distributed_train.py``'s (1e-5).
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from conftest import small_config
from test_torch_lm import _jax_draws as lm_jax_draws
from test_torch_lm import _params as lm_params
from test_torch_lm import _tcfg
from test_torch_sharding import _as_spec
from test_torch_train import _cfgs as paper_cfgs
from test_torch_train import _jax_draws as paper_jax_draws
from test_torch_train import _params as paper_params

from repro.configs.base import get_config as jget_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.core.router import RouterSpec as JRouterSpec
from repro.data import pipeline as jdata
from repro.launch.analytic import cfg_microbatches as jcfg_microbatches
from repro.models import lm as jlm
from repro.models import paper_lm as jpl
from repro.sharding import context as jctx
from repro.sharding import partition as jpart
from repro_torch.common.bridge import from_jax_tree
from repro_torch.core.router import RouterSpec as TRouterSpec
from repro_torch.data import pipeline as tdata
from repro_torch.models import lm as tlm
from repro_torch.models import paper_lm as tpl
from repro_torch.models import transformer as ttransformer
from repro_torch.sharding import context as tctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 2
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
SEED = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lm_model(name, jcfg, tcfg, seq, seed):
    tree = lm_params(jcfg, seed=seed)
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=seq, batch_size=ROWS,
              n_clusters=4)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jdata.batch_at(jdata.DataConfig(**dc), 0),
                              jcfg, rng=rng), has_aux=True))(tree)
    draws = lm_jax_draws(rng, tcfg, t=ROWS * seq)
    if name == "moa":
        draws["moa_noise"] = [None] * tcfg.n_layers
        for layer, kind in ttransformer.layer_index(tcfg):
            if kind.mixer == "moa":
                key = jax.random.fold_in(jax.random.fold_in(rng, layer), 1)
                draws["moa_noise"][layer] = torch.from_numpy(np.array(
                    jax.random.normal(key, (ROWS * seq, tcfg.moa_experts))))
    params = from_jax_tree(tree, device="cpu")
    batch = tdata.batch_at(tdata.DataConfig(**dc), 0, device="cpu")
    one = tlm.lm_loss(params, batch, tcfg,
                      generator=torch.Generator().manual_seed(SEED))[1]
    model = dict(kind="lm", cfg=tcfg, params=params, jax_draws=draws,
                 batch=batch)
    return model, {"loss": float(jl),
                   "metrics": {k: float(v) for k, v in jm.items()},
                   "grads": _np(jg), "gen": float(one["loss"])}


def _models():
    kimi = small_config("kimi-k2-1t-a32b", capacity_factor=4.0)
    moa = small_config("moa-demo", capacity_factor=4.0,
                       moa_router=JRouterSpec(capacity_factor=1.0))
    models, want = {}, {}
    models["kimi"], want["kimi"] = _lm_model("kimi", kimi, _tcfg(kimi),
                                             32, 1)
    models["moa"], want["moa"] = _lm_model(
        "moa", moa, _tcfg(moa).replace(
            moa_router=TRouterSpec(capacity_factor=1.0)), 32, 3)
    jcfg, tcfg = paper_cfgs("moe", jax_backend="ref")
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=8, batch_size=ROWS,
              n_clusters=4)
    tree = paper_params(jcfg, seed=1)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jpl.paper_lm_loss(p, jdata.batch_at(
            jdata.DataConfig(**dc), 0), jcfg, rng=rng), has_aux=True))(tree)
    params = from_jax_tree(tree, device="cpu")
    batch = tdata.batch_at(tdata.DataConfig(**dc), 0, device="cpu")
    one = tpl.paper_lm_loss(params, batch, tcfg,
                            generator=torch.Generator().manual_seed(SEED))[1]
    models["paper"] = dict(kind="paper", cfg=tcfg, params=params,
                           jax_draws=paper_jax_draws(rng, tcfg, b=ROWS, s=8),
                           batch=batch)
    want["paper"] = {"loss": float(jl),
                     "metrics": {k: float(v) for k, v in jm.items()},
                     "grads": _np(jg), "gen": float(one["loss"])}
    return models, want


_CELLS = """
import json
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, dryrun_pp
from repro_torch.launch.steps import StepSpec
from repro_torch.launch.train import reduced
small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=512, n_experts=8, moe_k=2, moe_d_ff=64, d_ff=128)
out = {"cell": dryrun.run_cell("kimi-k2-1t-a32b", "train:16x4096", "2x4x4",
                               overrides=small)}
cfg = reduced(get_config("kimi-k2-1t-a32b")).replace(n_layers=3)
step, args = dryrun_pp.build_pp_step(
    cfg, ShapeSpec("t", "train", 32, 4), dryrun.fake_mesh(
        {"data": 2, "model": 4}), n_micro=2)
out["pp"] = dryrun.trace_step(StepSpec(step, args, "train", 2, []))
json.dump(out, open(__import__("sys").argv[1], "w"))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cells") / "cells.json")
    cells = subprocess.Popen(
        [sys.executable, "-c", _CELLS, out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    models, want = _models()
    waits = {name: workers.start("rows", tmp_path_factory.mktemp(name),
                                 {"models": models, "seed": SEED}, *mesh)
             for name, mesh in MESHES.items()}
    ranks = {name: w() for name, w in waits.items()}
    _, err = cells.communicate(timeout=600)
    assert cells.returncode == 0, err[-4000:]
    with open(out) as f:
        return {"ranks": ranks, "want": want, "cells": json.load(f)}


@pytest.mark.parametrize("model", ["kimi", "moa", "paper"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rows_that_do_not_divide_match_jax(run, mesh, model):
    """2 rows on four ranks: the loss, every metric (the ranks' mean,
    equal on every rank) and every gradient are JAX's one process's."""
    want = run["want"][model]
    if model == "moa":
        assert want["metrics"]["fraction_dropped"] > 0
    ranks = [r[model] for r in run["ranks"][mesh]]
    for r in ranks:
        got = r["draws"]
        assert got == ranks[0]["draws"]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
        flat = jax.tree_util.tree_flatten_with_path(r["grads"])[0]
        wflat = jax.tree_util.tree_flatten_with_path(want["grads"])[0]
        assert [p for p, _ in flat] == [p for p, _ in wflat]
        for (path, g), (_, w) in zip(flat, wflat):
            np.testing.assert_allclose(g.numpy(), w, **TOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("model", ["kimi", "moa", "paper"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_step_generator_draws_the_global_batch(run, mesh, model):
    """From a step generator each rank draws the global batch's noise
    (2 rows, not 2 a rank) and keeps its share: the loss is the
    single-process port's at the same seed."""
    for r in run["ranks"][mesh]:
        np.testing.assert_allclose(r[model]["gen"]["loss"],
                                   run["want"][model]["gen"], **TOL)


def test_training_cell_traces_with_the_reference_microbatches(run):
    """16 rows of 4,096 on (2, 4, 4): 2 microbatches (the reference's
    count over the 8 ranks of ``("pod", "data")``) of 8 rows, one a
    ``batch`` rank, whole on its 4 ``model`` ranks; the step traces."""
    rec = run["cells"]["cell"]
    assert rec["status"] == "ok", rec
    jcfg = jget_config("kimi-k2-1t-a32b")
    want = jcfg_microbatches(jcfg, JShapeSpec("t", "train", 4096, 16), 8)
    assert rec["microbatches"] == want == 2
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert rec["collectives"]["all_to_all"]["calls"] > 0


def test_pipelined_step_traces_with_whole_rows(run):
    """build_pp_step with 2 rows a microbatch over 4 ``model`` ranks (the
    rows whole on each, the MoE's tokens split) traces."""
    pp = run["cells"]["pp"]
    assert pp["memory"]["peak_bytes_per_device"] > 0
    assert pp["collectives"]["shift"]["calls"] > 0
    assert pp["collectives"]["all_gather"]["calls"] > 0


# (mesh sizes, manual axes, rows, tokens a row, the axes the rows split
# over, the axes that hold them whole)
SPLITS = [
    ({"pod": 2, "data": 16, "model": 16}, (), 32, 4096, ("pod", "data"),
     ("model",)),
    ({"pod": 2, "data": 16, "model": 16}, (), 512, 1,
     ("pod", "data", "model"), ()),
    ({"data": 16, "model": 16}, (), 16, 4096, ("data",), ("model",)),
    ({"data": 16, "model": 16}, (), 24, 4096, (), ("data", "model")),
    ({"data": 16, "model": 16}, ("data",), 4, 4096, (), ("model",)),
    ({"data": 1, "model": 4}, (), 2, 32, ("data",), ("model",)),
    ({"data": 2, "model": 2}, (), 2, 32, ("data",), ("model",)),
    ({"data": 2, "model": 2}, ("data",), 1, 16, (), ("model",)),
]


@pytest.mark.parametrize("case", range(len(SPLITS)))
def test_split_rows_takes_the_references_batch_axes(case):
    """``split_rows`` on a stand-in mesh: the axes the rows split over
    and those that hold them whole; where the rows do not divide over
    the ranks, the rows' axes are the reference's ``resolve`` of the
    ``batch`` axis, fallbacks and manual axes included."""
    sizes, manual, rows, seq, want, whole = SPLITS[case]
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()),
                                 get_local_rank=lambda axis: 0)
    ctx = tctx.MeshContext.for_mesh(mesh, "dp_tp_ep").manual(*manual)
    got = ctx.split_rows(rows, seq)
    assert (got.rows_over, got.whole_over) == (want, whole)
    assert got.token_axes == want + whole
    if rows % ctx.world:
        jc = jctx.MeshContext(mesh=types.SimpleNamespace(shape=sizes),
                              rules=jpart.PLANS["dp_tp_ep"],
                              manual_axes=frozenset(manual))
        assert (want,) == _as_spec(jc.resolve((rows,), ("batch",)))
    t = torch.arange(rows * seq)
    assert got.local_tokens(t).numel() * ctx.world == rows * seq


def test_split_rows_raises_where_the_tokens_do_not_divide():
    """3 rows of one token on (2, 2): no ``batch`` axis divides the rows,
    and their 3 tokens do not divide over the 4 ranks: a ValueError that
    names the rows, the tokens and the axes."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    ctx = tctx.MeshContext.for_mesh(mesh, "dp_tp_ep")
    with pytest.raises(ValueError) as err:
        ctx.split_rows(3, 1)
    msg = str(err.value)
    for part in ("3 rows", "3 tokens", "('data', 'model')"):
        assert part in msg, msg
