"""Sharded training on CPU ranks over gloo against the JAX package and
the single-process port: data-parallel steps with the expert-parallel
MoE, the shard-aware optimizer, topology-changing checkpoints, int8
error-feedback sync and the launcher under torchrun.

Two models: a small MoE transformer (``conftest.small_config`` of
kimi-k2 at a capacity factor where no shard drops a token) and the
small paper LM of ``test_torch_train.py``.  Parameters come from a
JAX-materialized tree (gates redrawn) through ``from_jax_tree``.  Four
ranks run each model on mesh (2, 2) and on (4, 1)
(``torch_dist_workers.py``, which imports the port only):

* step 0's loss, metrics and every gradient (gathered from the shards)
  against JAX's single-device loss and ``jax.grad``, from the JAX draws
  split by rank, at 1e-5;
* two updates of the factored optimizer and one of Adam on the shards
  of JAX's step-0 gradients, against the single-process port's updates
  of the same gradients: the grad norm and every parameter at 1e-6 (a
  shard-local factored statistic or a norm that counts a replica once
  per rank would be off by orders of magnitude more);
* two training steps (factored) from the step generators (each rank
  draws the global batch's noise and keeps its rows) against the same
  steps of the single-process port: the losses at 1e-6; the parameters
  at 1e-5, since the two runs' gradients differ by their reductions'
  rounding (4e-7 of the largest at step 0) and the factored update,
  which divides each gradient by its row and column scale, carries that
  into the parameters at up to 1e-6 after one step;
* the (2, 2) run's checkpoint restored on (2, 1) and on one process,
  bitwise.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from conftest import small_config
from test_torch_lm import _jax_draws as lm_jax_draws
from test_torch_lm import _params as lm_params
from test_torch_lm import _tcfg
from test_torch_train import _cfgs as paper_cfgs
from test_torch_train import _jax_draws as paper_jax_draws
from test_torch_train import _params as paper_params

from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.models import paper_lm as jpl
from repro.train import compression as jcomp
from repro_torch.common.bridge import from_jax_tree
from repro_torch.common.param import tree_leaves, zeros
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import paper_lm as tpl
from repro_torch.optim import optimizers as topt
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import trainer as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = [(topt.OptConfig(kind="factored", learning_rate=1e-2,
                        warmup_steps=10), 2),
        (topt.OptConfig(kind="adam", learning_rate=1e-2, warmup_steps=10),
         1)]
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
EF_STEPS = 50


def _lm_model():
    """kimi-k2's small config at capacity factor 4: C = 2 T, so no shard
    (and no single-device call) drops a token."""
    jcfg = small_config("kimi-k2-1t-a32b", capacity_factor=4.0)
    tcfg = _tcfg(jcfg)
    dc = dict(vocab_size=tcfg.vocab_size, seq_len=32, batch_size=4,
              n_clusters=4)
    tree = lm_params(jcfg, seed=1)
    jbatch = jdata.batch_at(jdata.DataConfig(**dc), 0)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jbatch, jcfg, rng=rng),
        has_aux=True))(tree)
    return dict(kind="lm", cfg=tcfg, tree=tree, dc=dc,
                jax_draws=lm_jax_draws(rng, tcfg, t=4 * 32),
                want=(float(jl), {k: float(v) for k, v in jm.items()}, jg))


def _paper_model():
    jcfg, tcfg = paper_cfgs("moe", jax_backend="ref")
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=8, batch_size=4,
              n_clusters=4)
    tree = paper_params(jcfg, seed=1)
    jbatch = jdata.batch_at(jdata.DataConfig(**dc), 0)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jpl.paper_lm_loss(p, jbatch, jcfg, rng=rng),
        has_aux=True))(tree)
    return dict(kind="paper", cfg=tcfg, tree=tree, dc=dc,
                jax_draws=paper_jax_draws(rng, tcfg, b=4, s=8),
                want=(float(jl), {k: float(v) for k, v in jm.items()}, jg))


def _batches(dc, n=2):
    return [tdata.batch_at(tdata.DataConfig(**dc), i, device="cpu")
            for i in range(n)]


def _loss_fn(model):
    cfg = model["cfg"]
    if model["kind"] == "lm":
        return lambda p, b, g: tlm.lm_loss(p, b, cfg, generator=g)
    return lambda p, b, g: tpl.paper_lm_loss(p, b, cfg, generator=g)


def _single_process(model) -> dict:
    """The same updates and steps on one process, no mesh."""
    out = {}
    grads = from_jax_tree(jax.tree_util.tree_map(np.asarray,
                                                 model["want"][2]),
                          device="cpu")
    for oc, n_steps in OPTS:
        params = from_jax_tree(model["tree"], device="cpu")
        state = topt.init(params, oc)
        norms = [float(topt.apply_updates(params, grads, state, oc)[2][
            "grad_norm"]) for _ in range(n_steps)]
        out[oc.kind] = {"grad_norms": norms, "params": params}
    oc, n_steps = OPTS[0]
    params = from_jax_tree(model["tree"], device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    state = {"params": params, "opt": topt.init(params, oc)}
    step = ttrain.make_train_step(_loss_fn(model), oc)
    losses = []
    for i, batch in enumerate(_batches(model["dc"])[:n_steps]):
        gen = torch.Generator().manual_seed(ttrain.step_seed(0, i))
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
    out["steps"] = {"losses": losses, "params": state["params"]}
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both models on both meshes (the spawns run while the JAX and
    single-process sides run here)."""
    models = {"lm": _lm_model(), "paper": _paper_model()}
    inputs = {"models": {
        name: dict(kind=m["kind"], cfg=m["cfg"],
                   params=from_jax_tree(m["tree"], device="cpu"),
                   grads=from_jax_tree(jax.tree_util.tree_map(
                       np.asarray, m["want"][2]), device="cpu"),
                   batches=_batches(m["dc"]), jax_draws=m["jax_draws"],
                   opts=OPTS) for name, m in models.items()},
        "ckpt_model": "lm"}
    dirs, waits = {}, {}
    for mesh, (data, model) in MESHES.items():
        dirs[mesh] = str(tmp_path_factory.mktemp(f"train{mesh}"))
        ckpt = os.path.join(dirs[mesh], "ckpt")
        waits[mesh] = workers.start("train", dirs[mesh],
                                    dict(inputs, ckpt=ckpt), data, model)
    single = {name: _single_process(m) for name, m in models.items()}
    ranks = {mesh: wait() for mesh, wait in waits.items()}
    return {"models": models, "single": single, "ranks": ranks,
            "ckpt": os.path.join(dirs["2x2"], "ckpt")}


def _named(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["lm", "paper"])
def test_step0_loss_and_grads_match_jax(trained, model, mesh):
    jl, jm, jg = trained["models"][model]["want"]
    for r in trained["ranks"][mesh]:
        got = r[model]
        np.testing.assert_allclose(float(got["metrics0"]["loss"]), jl,
                                   rtol=1e-5)
        for key in ("xent", "aux_loss"):
            np.testing.assert_allclose(float(got["metrics0"][key]), jm[key],
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        flat, wflat = _named(got["grads0"]), _named(jg)
        assert [p for p, _ in flat] == [p for p, _ in wflat]
        for (path, g), (_, w) in zip(flat, wflat):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                       err_msg=str(path))


def _assert_trees_close(got, want, tol):
    flat, wflat = _named(got), _named(want)
    assert [p for p, _ in flat] == [p for p, _ in wflat]
    for (path, p), (_, w) in zip(flat, wflat):
        np.testing.assert_allclose(p.numpy(), w.detach().numpy(), **tol,
                                   err_msg=str(path))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["lm", "paper"])
@pytest.mark.parametrize("opt", ["factored", "adam"])
def test_sharded_optimizer_matches_single_process(trained, model, mesh,
                                                  opt):
    want = trained["single"][model][opt]
    for r in trained["ranks"][mesh]:
        got = r[model][opt]
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-6)
        _assert_trees_close(got["params"], want["params"], PARAM_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["lm", "paper"])
def test_sharded_steps_match_single_process(trained, model, mesh):
    want = trained["single"][model]["steps"]
    for r in trained["ranks"][mesh]:
        got = r[model]["steps"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        _assert_trees_close(got["params"], want["params"], STEP_TOL)


@pytest.fixture(scope="module")
def restored(trained, tmp_path_factory):
    """The (2, 2) checkpoint restored on (2, 1), and the int8 EF sync of
    EF_STEPS steps of per-rank gradients on the same two ranks."""
    model = trained["models"]["lm"]
    grads = np.random.RandomState(0).randn(EF_STEPS, 2, 64).astype(
        np.float32)
    inputs = {"model": {"kind": "lm", "cfg": model["cfg"]},
              "oc": OPTS[0][0], "ckpt": trained["ckpt"],
              "ef_grads": torch.from_numpy(grads)}
    ranks = workers.spawn("restore", str(tmp_path_factory.mktemp("rst")),
                          inputs, 2, 1)
    return {"ranks": ranks, "grads": grads}


def test_checkpoint_restores_under_another_topology(trained, restored):
    """Saved on (2, 2) (gathered, written by rank 0), restored on (2, 1)
    as each rank's slices and on one process: bitwise the saved state."""
    saved = trained["ranks"]["2x2"][0]["lm"]["state"]
    for r in restored["ranks"]:
        assert r["step"] == 2 and r["extra"] == {"mesh": {"data": 2,
                                                         "model": 2}}
        for (path, got), (_, want) in zip(_named(r["full"]), _named(saved)):
            assert torch.equal(got, want), path
    # A leaf sharded on (2, 1): the experts' d_ff over data, halved.
    w1 = restored["ranks"][0]["local_shapes"]["params"]["blocks"][
        "periods"]["pos0"]["moe"]["w1"]
    full = saved["params"]["blocks"]["periods"]["pos0"]["moe"]["w1"].shape
    assert w1 == (full[0], full[1], full[2], full[3] // 2)
    mgr = tckpt.CheckpointManager(trained["ckpt"])
    like = {"params": jax.tree_util.tree_map(torch.zeros_like,
                                             saved["params"]),
            "opt": jax.tree_util.tree_map(torch.zeros_like, saved["opt"])}
    one, _, step = mgr.restore(mgr.latest_step(), like)
    assert step == 2
    for (path, got), (_, want) in zip(_named(one), _named(saved)):
        assert torch.equal(got, want), path


def test_quantize_int8_is_the_references_bitwise():
    rs = np.random.RandomState(3)
    for x in (3.0 * rs.randn(1000), rs.randint(-254, 255, 512) / 2.0,
              np.array([0.0, 0.0]), 1e-3 * rs.randn(7, 9)):
        x = x.astype(np.float32)
        jq, js = jcomp.quantize_int8(x)
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert (tcomp.dequantize_int8(tq, ts).numpy().tobytes()
                == np.asarray(jcomp.dequantize_int8(jq, js)).tobytes())


def test_ef_compress_sync_over_two_ranks(restored):
    """Step 0's sync is the ranks' mean within one quantization step;
    error feedback keeps the accumulated sync within a step's error of
    the accumulated true mean (the reference tests' bounds)."""
    grads = restored["grads"]
    true = grads.mean(axis=1)
    for r in restored["ranks"]:
        synced = r["ef"]["synced"].numpy()
        scale = np.abs(grads[0]).max() / 127
        assert np.abs(synced[0] - true[0]).max() <= scale + 1e-5
        drift = np.abs(true.sum(axis=0) - synced.sum(axis=0)).max()
        assert drift < 0.2, drift
        np.testing.assert_array_equal(synced, restored["ranks"][0]["ef"][
            "synced"].numpy())


def _launched(args, workdir, stdout: str) -> dict:
    """The launcher's last logged metrics and final parameters."""
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    mgr = tckpt.CheckpointManager(os.path.join(workdir, "ckpt"))
    cfg = tlaunch.reduced(get_config(args[args.index("--arch") + 1]))
    like = {"params": zeros(tlm.lm_defs(cfg), "cpu")}
    tree, _, _ = mgr.restore(mgr.latest_step(), like)
    return {"stdout": stdout, "rows": rows, "params": tree["params"]}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_launcher_under_torchrun_matches_one_process(tmp_path, microbatches):
    """Two gloo ranks through ``torch.distributed.run`` train the losses
    and parameters of the one-process launcher (capacity factor 4: no
    shard drops a token), also when the step accumulates microbatches
    (each rank's rows of each global microbatch: the same tokens, noise
    and combined-batch balance losses as on one process)."""
    args = ["--device", "cpu", "--arch", "kimi-k2-1t-a32b", "--reduce",
            "--steps", "2", "--batch", "4", "--seq", "32",
            "--capacity-factor", "4", "--microbatches", str(microbatches)]
    two_dir, one_dir = str(tmp_path / "two"), str(tmp_path / "one")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", *args,
         "--workdir", two_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.path.join(REPO, "src")))
    tlaunch.main([*args, "--workdir", one_dir])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    one = _launched(args, one_dir, "")
    two = _launched(args, two_dir, out)
    assert ("2 rank(s) over gloo, mesh {'data': 2, 'model': 1}"
            in two["stdout"])
    assert two["stdout"].count("[train] done") == 1
    (a,), (b,) = one["rows"], two["rows"]
    assert a["step"] == b["step"] == 2
    for key in ("loss", "xent", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(b[key], a[key], rtol=1e-6, err_msg=key)
    for (path, p), (_, w) in zip(_named(two["params"]), _named(one["params"])):
        np.testing.assert_allclose(p.numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=str(path))
