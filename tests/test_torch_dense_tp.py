"""The dense layers run tensor-parallel over the axes on which a step's
rows are whole (``MeshContext.tp_axes``: ``heads``, ``kv_heads``, ``mlp``
and ``vocab`` over ``model``, as the reference's ``dp_tp_ep`` and
``prefill_tp`` plans lay them out), against the JAX package.

* Gloo ranks (``torch_dist_workers.py``, ``case_dense_tp``) run the
  trainer's gradients (``make_grad_fn``: ``loss / world`` and the replica
  sums) and metrics from the JAX draws, against JAX's one-process
  ``lm_loss`` and ``jax.grad``:

  - small gemma3 (windowed and global layers, geglu, qk_norm) and small
    qwen3, one row on (1, 2): every dense dim splits;
  - the same two with 2 rows on (1, 4), where the 2 KV heads stay whole
    and each rank cuts the group its query head reads, and on (2, 2), one
    row a ``data`` rank;
  - small kimi-k2 (capacity factor 4: no shard drops a token) on (1, 2):
    the MoE's token share meets attention run tensor-parallel;
  - small qwen3 with 3 query heads on (1, 2): the heads divide over no
    axis, so attention stays whole while the FFN and the vocabulary
    split.

  A rank's gathered ``wq`` / ``w1`` / ``unembed`` carry H / M, d_ff / M
  and V / M; where the rows split over every rank every leaf is whole.
* The prefill step (``launch/steps.py``) of one row on (1, 2): its
  logits and its cache (each rank's key / value heads) against JAX's
  ``lm_prefill``.
* Under fake process groups, in one subprocess: gemma3-27b at full
  width, cut to one period, as a (16, 16) ``train_4k`` rank holds it (one
  4,096-token row a ``data`` rank, one microbatch): its dense leaves in
  the step are its 1/16 slices, and the traced peak is below the same
  cut's before the dense layers split.

Tolerance rtol 2e-4 / atol 2e-5 (sums split over ranks; the embedding is
exact).
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
import torch_dist_workers as workers
from conftest import small_config
from test_torch_lm import _jax_draws, _params, _tcfg

from repro.common import param as jpm
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro_torch.common.bridge import from_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
S = 64
MAX_LEN = 80
# mesh -> (rows, the models run there)
MESHES = {"1x2": (1, ("gemma", "qwen", "kimi", "heads3")),
          "1x4": (2, ("gemma", "qwen")),
          "2x2": (2, ("gemma", "qwen"))}
PREFILL = ("gemma", "qwen")
# The traced peak of the fake-group cut before the dense layers split:
# 19,627,360,768 B (the script of _CUT on commit 045d79b, traced on a
# CPU host in 8.0 s).
CUT_PEAK_BEFORE = 19_627_360_768


def _configs() -> dict:
    return {
        "gemma": small_config("gemma3-27b", n_layers=7),
        "qwen": small_config("qwen3-1.7b"),
        "kimi": small_config("kimi-k2-1t-a32b", capacity_factor=4.0),
        "heads3": small_config("qwen3-1.7b", n_heads=3, n_kv_heads=1)}


def _tokens(vocab, rows, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(1, vocab, (rows, S + 1)).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_train(jcfg, tree, seq, rng):
    batch = {"tokens": jnp.asarray(seq[:, :-1]),
             "labels": jnp.asarray(seq[:, 1:])}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng), has_aux=True))(tree)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np(grads)}


_CUT = """
import json, sys
import torch
from repro_torch.common import param as pm
from repro_torch.configs.base import get_config
from repro_torch.core import expert_parallel as ep_lib
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_step
from repro_torch.models import lm
from repro_torch.sharding.context import MeshContext
cfg = get_config("gemma3-27b", n_layers=6)
shape = dryrun.parse_shape("train:16x4096")
mesh = dryrun.fake_mesh({"data": 16, "model": 16})
spec = build_step(cfg, shape, mesh)
ctx = MeshContext.for_mesh(mesh, "dp_tp_ep").split_rows(16, 4096)
defs = lm.lm_defs(cfg)
with torch.no_grad():
    used = ep_lib.gather_on_use(spec.args[0]["params"], defs, ctx, tp=True)
layer = used["blocks"]["periods"]["pos0"]
out = {"shapes": {"wq": list(layer["attn"]["wq"].shape),
                  "wk": list(layer["attn"]["wk"].shape),
                  "wo": list(layer["attn"]["wo"].shape),
                  "w1": list(layer["mlp"]["w1"].shape),
                  "w2": list(layer["mlp"]["w2"].shape),
                  "table": list(used["embed"]["table"].shape),
                  "unembed": list(used["unembed"]["w"].shape)},
       "bytes": [pm.param_bytes(used), pm.param_bytes(pm.abstract(defs))],
       "microbatches": spec.microbatches,
       "trace": dryrun.trace_step(spec, flops=False)}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cut") / "cut.json")
    cut = subprocess.Popen(
        [sys.executable, "-c", _CUT, out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    cfgs = _configs()
    trees = {name: _params(jcfg, seed=i + 1)
             for i, (name, jcfg) in enumerate(cfgs.items())}
    rng = jax.random.PRNGKey(5)
    seqs = {rows: {name: _tokens(cfgs[name].vocab_size, rows, seed=rows)
                   for name in cfgs} for rows in (1, 2)}
    waits = {}
    for mesh, (rows, names) in MESHES.items():
        models = {}
        for name in names:
            tcfg, seq = _tcfg(cfgs[name]), seqs[rows][name]
            models[name] = {
                "kind": "lm", "cfg": tcfg,
                "params": from_jax_tree(trees[name], device="cpu"),
                "jax_draws": _jax_draws(rng, tcfg, t=rows * S),
                "batch": {"tokens": torch.from_numpy(seq[:, :-1]),
                          "labels": torch.from_numpy(seq[:, 1:])}}
        prefill = {} if mesh != "1x2" else {
            name: {"cfg": _tcfg(cfgs[name]), "max_len": MAX_LEN,
                   "params": from_jax_tree(trees[name], device="cpu"),
                   "tokens": torch.from_numpy(seqs[1][name][:, :-1])}
            for name in PREFILL}
        data, model = (int(n) for n in mesh.split("x"))
        waits[mesh] = workers.start(
            "dense_tp", tmp_path_factory.mktemp(mesh),
            {"models": models, "prefill": prefill}, data, model)
    want = {rows: {name: _jax_train(cfgs[name], trees[name],
                                    seqs[rows][name], rng)
                   for name in cfgs
                   if any(r == rows and name in n
                          for r, n in MESHES.values())}
            for rows in (1, 2)}
    prefill = {}
    for name in PREFILL:
        jcfg = cfgs[name]
        cache = jpm.materialize(jtransformer.cache_defs(jcfg, 1, MAX_LEN),
                                jax.random.PRNGKey(0))
        prefill[name] = _np(jax.jit(jsteps.make_prefill_step_fn(jcfg, None))(
            trees[name], {"tokens": jnp.asarray(seqs[1][name][:, :-1])},
            cache))
    ranks = {mesh: w() for mesh, w in waits.items()}
    _, err = cut.communicate(timeout=600)
    assert cut.returncode == 0, err[-4000:]
    with open(out) as f:
        return {"ranks": ranks, "want": want, "prefill": prefill,
                "cfgs": cfgs, "cut": json.load(f)}


CASES = [(mesh, name) for mesh, (_, names) in MESHES.items()
         for name in names]


@pytest.mark.parametrize("mesh,model", CASES)
def test_dense_tp_matches_jax(run, mesh, model):
    """The loss, every metric (the ranks' mean) and every gradient leaf
    on each rank are JAX's one process's."""
    rows = MESHES[mesh][0]
    want = run["want"][rows][model]
    for r in run["ranks"][mesh]:
        got = r["train"][model]
        np.testing.assert_allclose(got["metrics"]["loss"], want["loss"],
                                   **TOL)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, **TOL,
                                       err_msg=k)
        flat = jax.tree_util.tree_flatten_with_path(got["grads"])[0]
        wflat = jax.tree_util.tree_flatten_with_path(want["grads"])[0]
        assert [p for p, _ in flat] == [p for p, _ in wflat]
        for (path, g), (_, w) in zip(flat, wflat):
            np.testing.assert_allclose(g.numpy(), w, **TOL,
                                       err_msg=str(path))


# mesh, model -> the mesh axes of (heads, kv_heads, mlp, vocab)
AXES = {("1x2", "gemma"): ("model",) * 4,
        ("1x2", "qwen"): ("model",) * 4,
        ("1x2", "kimi"): ("model", "model", None, "model"),
        ("1x2", "heads3"): (None, None, "model", "model"),
        ("1x4", "gemma"): ("model", None, "model", "model"),
        ("1x4", "qwen"): ("model", None, "model", "model"),
        ("2x2", "gemma"): ("model",) * 4,
        ("2x2", "qwen"): ("model",) * 4}


@pytest.mark.parametrize("mesh,model", CASES)
def test_gathered_leaves_are_the_ranks_slices(run, mesh, model):
    """Where the rows are whole on ``model``, the leaves the loss gets
    carry H / M query heads, KV / M key / value heads where they divide,
    d_ff / M and V / M; under a split of the rows over every rank every
    leaf is whole."""
    cfg = run["cfgs"][model]
    m = int(mesh.split("x")[1])
    want_axes = AXES[(mesh, model)]
    for r in run["ranks"][mesh]:
        got = r["train"][model]
        tp = got["tp"]
        assert tuple((tp[k] or (None,))[0] for k in (
            "heads", "kv_heads", "mlp", "vocab")) == want_axes
        shapes = got["shapes"]

        def n(axis, size):
            return size // m if axis else size
        h, kv, ff, v = (n(a, s) for a, s in zip(
            want_axes, (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                        cfg.vocab_size)))
        assert shapes["embed.table"] == (v, cfg.d_model)
        assert shapes["unembed.w"] == (cfg.d_model, v)
        pos0 = "blocks.periods.pos0"
        assert shapes[f"{pos0}.attn.wq"][-2] == h
        assert shapes[f"{pos0}.attn.wo"][-3] == h
        assert shapes[f"{pos0}.attn.wk"][-2] == kv
        if f"{pos0}.mlp.w1" in shapes:
            assert shapes[f"{pos0}.mlp.w1"][-1] == ff
            assert shapes[f"{pos0}.mlp.w2"][-2] == ff
        split = got["split_shapes"]
        assert split["embed.table"] == (cfg.vocab_size, cfg.d_model)
        assert split[f"{pos0}.attn.wq"][-2] == cfg.n_heads


@pytest.mark.parametrize("model", PREFILL)
def test_prefill_step_matches_jax(run, model):
    """One row whole on both ``model`` ranks: each rank's last logits
    are JAX's, and its cache holds its half of the key / value heads,
    JAX's values."""
    jl, jcache = run["prefill"][model]
    kv_heads = run["cfgs"][model].n_kv_heads
    for r in run["ranks"]["1x2"]:
        got = r["prefill"][model]
        assert got["kv"] == ("model",)
        np.testing.assert_allclose(got["logits"].numpy(), jl, **TOL)
        flat = jax.tree_util.tree_flatten_with_path(got["cache"])[0]
        wflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
        assert [p for p, _ in flat] == [p for p, _ in wflat]
        for (path, g), (_, w) in zip(flat, wflat):
            n = kv_heads // 2
            assert g.shape[-2] == n
            i = got["kv_index"] * n
            np.testing.assert_allclose(g.numpy(), w[..., i:i + n, :], **TOL,
                                       err_msg=str(path))


def test_full_width_cut_holds_its_slices(run):
    """gemma3-27b at full width, one period, as a (16, 16) rank of
    ``train_4k`` holds it: the step's dense leaves are the rank's 1/16
    slices (32 / 16 query heads, 16 / 16 key / value heads, d_ff 21,504 /
    16, vocabulary 262,144 / 16), and the traced peak is under a quarter
    of the same cut's before the split (CUT_PEAK_BEFORE)."""
    cut = run["cut"]
    shapes = cut["shapes"]
    assert cut["microbatches"] == 1
    assert shapes["wq"][-2] == 2 and shapes["wo"][-3] == 2
    assert shapes["wk"][-2] == 1
    assert shapes["w1"][-1] == 1344 and shapes["w2"][-2] == 1344
    assert shapes["table"][0] == 16384 and shapes["unembed"][-1] == 16384
    used, whole = cut["bytes"]
    assert used * 8 < whole
    peak = cut["trace"]["memory"]["peak_bytes_per_device"]
    assert 0 < peak and 4 * peak < CUT_PEAK_BEFORE, peak
