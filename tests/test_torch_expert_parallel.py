"""The port's expert-parallel MoE (``core/expert_parallel.py``) on four
CPU ranks over gloo, mesh (data 2, model 2), against the JAX package.

One spawn of four ranks (``torch_dist_workers.py``, which imports the
port only) runs every case; the JAX side runs here, or for the
reference's own ``moe_apply_ep`` in one subprocess with four fake host
devices.  Parameters come from a JAX-materialized tree (gates redrawn),
moved across with ``from_jax_tree``; each rank takes its rows of the
tokens and of the JAX noise.  Tolerances: the reference test's ``rtol
2e-4, atol 2e-5`` (``tests/test_distributed.py``) for outputs, losses,
metrics and every gradient.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from conftest import small_config
from test_torch_lm import _params as lm_params
from test_torch_lm import _tcfg

from repro.common import param as jpm
from repro.core import moe as jmoe
from repro.core import router as jrouter
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.train import pipeline as jpp
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config
from repro_torch.core import router as trouter
from repro_torch.launch.train import reduced

E, K, D, F, T = 8, 2, 16, 32, 128      # 4 ranks x 32 tokens
TOL = dict(rtol=2e-4, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(activation="relu", cf=8.0, **kw):
    common = dict(n_experts=E, k=K, d_model=D, d_ff=F, activation=activation,
                  capacity_factor=cf, **kw)
    return (jmoe.MoEArgs(dtype=jnp.float32, kernel_backend="ref", **common),
            dict(dtype=torch.float32, **common))


def _params(ja, seed=0, wg=None):
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(jmoe.moe_defs(ja), jax.random.PRNGKey(seed)))
    tree["gate"]["wg"] = (0.5 * np.random.RandomState(seed + 7).randn(D, E)
                          if wg is None else wg).astype(np.float32)
    if "wnoise" in tree["gate"]:
        tree["gate"]["wnoise"] = (0.3 * np.random.RandomState(seed + 8)
                                  .randn(D, E)).astype(np.float32)
    return tree


def _skewed_inputs():
    """Each rank's 32 tokens all point along one feature, 2r, whose gate
    logits peak equally at experts (2r, 2r + 1): every rank is maximally
    skewed while the combined batch loads all 8 experts equally (the
    reference's construction, for four ranks instead of eight)."""
    wg = np.zeros((D, E), np.float32)
    for r in range(4):
        wg[2 * r, 2 * r] = wg[2 * r, 2 * r + 1] = 10.0
    x = np.zeros((T, D), np.float32)
    for r in range(4):
        x[r * 32:(r + 1) * 32, 2 * r] = 4.0
    x += 0.01 * np.random.RandomState(0).randn(T, D).astype(np.float32)
    return wg, x


def _jax_case(ja, params, x, dy, *, train, key):
    def loss(p, x_):
        y, aux = jmoe.moe_apply(p, x_, ja, train=train, rng=key)
        return jnp.sum(y * dy) + aux["aux_loss"], (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return {"y": np.asarray(y), "aux_loss": float(aux["aux_loss"]),
            "metrics": {k: float(v) for k, v in aux["metrics"].items()},
            "grads": jax.tree_util.tree_map(np.asarray, gp),
            "dx": np.asarray(gx)}


def _reference_ep(tmp, cases: dict):
    """Start the reference's ``moe_apply_ep`` (train=False) on four fake
    devices, mesh (2, 2), for each case; the returned function waits
    for it and gives each case's y, aux_loss and metrics."""
    np.savez(os.path.join(tmp, "ref_in.npz"), **{
        f"{name}/{k}": v for name, (_, p, x) in cases.items()
        for k, v in [("x", x), *[(f"p/{a}/{b}", w)
                                 for a, sub in p.items()
                                 for b, w in (sub.items()
                                              if isinstance(sub, dict)
                                              else [("", sub)])]]})
    arg_src = {name: repr({k: v for k, v in vars(ja).items()
                           if k not in ("dtype", "router")})
               for name, (ja, _, _) in cases.items()}
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from repro.core.moe import MoEArgs
        from repro.core.expert_parallel import moe_apply_ep
        from repro.sharding import context
        mesh = context.make_mesh((2, 2), ("data", "model"))
        ctx = context.MeshContext.for_mesh(mesh, "dp_tp_ep")
        data = np.load({os.path.join(tmp, "ref_in.npz")!r})
        out = {{}}
        for name, kw in {arg_src!r}.items():
            a = MoEArgs(dtype=jnp.float32, **eval(kw))
            p = {{}}
            for key in data.files:
                parts = key.split("/")
                if parts[0] == name and parts[1] == "p":
                    if parts[3]:
                        p.setdefault(parts[2], {{}})[parts[3]] = data[key]
                    else:
                        p[parts[2]] = data[key]
            y, aux = jax.jit(lambda p, x: moe_apply_ep(
                p, x, a, train=False, ctx=ctx))(p, data[name + "/x"])
            out[name + "/y"] = np.asarray(y)
            out[name + "/aux_loss"] = np.asarray(aux["aux_loss"])
            for k, v in aux["metrics"].items():
                out[name + "/m/" + k] = np.asarray(v)
        np.savez({os.path.join(tmp, "ref_out.npz")!r}, **out)
    """)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PYTHONPATH=(
                                os.path.join(REPO, "src"))))

    def wait() -> dict:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(os.path.join(tmp, "ref_out.npz"))
        return {name: {"y": got[name + "/y"],
                       "aux_loss": float(got[name + "/aux_loss"]),
                       "metrics": {k: float(got[f"{name}/m/{k}"])
                                   for k in ("cv_importance", "cv_load",
                                             "max_over_mean_load",
                                             "fraction_dropped")}}
                for name in cases}
    return wait


PP_B, PP_S, PP_MICRO = 2, 16, 2


def _pipeline_case(jcfg, seed):
    """A pipelined eval (``train=False``) of ``jcfg``'s 2 layers on (stage
    2 x model 2), one row a microbatch (whole on both ``model`` ranks):
    the ranks' case, and JAX's mean over the microbatches of its
    one-process ``lm_loss`` with its gradients (the blocks as the
    pipeline stacks them, [2, 1, ...])."""
    tree = lm_params(jcfg, seed=seed)
    tokens = np.random.RandomState(seed).randint(
        1, jcfg.vocab_size, (PP_B, PP_S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    b_mb = PP_B // PP_MICRO
    mbs = [{k: jnp.asarray(v[i * b_mb:(i + 1) * b_mb])
            for k, v in batch.items()} for i in range(PP_MICRO)]

    def mean_loss(p):
        out = [jlm.lm_loss(p, mb, jcfg, train=False) for mb in mbs]
        return sum(o[0] for o in out) / PP_MICRO, [o[1] for o in out]
    (loss, ms), g = jax.jit(jax.value_and_grad(mean_loss, has_aux=True))(
        tree)

    def staged(t):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a).reshape((2, 1) + a.shape[1:]),
            t["blocks"]["periods"]["pos0"])
    tcfg = _tcfg(jcfg)
    if jcfg.moa_router is not None:
        tcfg = tcfg.replace(moa_router=trouter.RouterSpec(
            capacity_factor=jcfg.moa_router.capacity_factor))
    case = dict(cfg=tcfg, n_stages=2, n_micro=PP_MICRO, train=False,
                params=from_jax_tree(dict(tree, blocks=staged(tree)),
                                     device="cpu"),
                batch={k: torch.from_numpy(v) for k, v in batch.items()})
    want = {"loss": float(loss),
            **{k: float(np.mean([float(m[k]) for m in ms]))
               for k in ("xent", "aux_loss", "fraction_dropped")},
            "grads": jax.tree_util.tree_map(
                np.asarray, dict(g, blocks=staged(g)))}
    return case, want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on the four ranks, and the JAX results beside them."""
    tmp = str(tmp_path_factory.mktemp("ep"))
    rs = np.random.RandomState(1)
    key = jax.random.PRNGKey(3)
    x = rs.randn(T, D).astype(np.float32)
    dy = rs.randn(T, D).astype(np.float32)
    noise = np.array(jax.random.normal(key, (T, E)))
    cases, want, ref_cases = {}, {}, {}
    for act in ("relu", "swiglu"):
        ja, targs = _args(act)
        params = _params(ja)
        cases[f"nodrop_{act}"] = dict(
            args=targs, params=from_jax_tree(params, device="cpu"),
            x=torch.from_numpy(x), dy=torch.from_numpy(dy),
            noise=torch.from_numpy(noise), train=True)
        want[f"nodrop_{act}"] = _jax_case(ja, params, x, dy, train=True,
                                          key=key)
        ja, targs = _args(act, cf=1.0)
        params = _params(ja, seed=2)
        cases[f"drops_{act}"] = dict(
            args=targs, params=from_jax_tree(params, device="cpu"),
            x=torch.from_numpy(x), dy=torch.from_numpy(dy), train=False)
        ref_cases[f"drops_{act}"] = (ja, params, x)
    wg, xs = _skewed_inputs()
    for policy in ("noisy_topk", "expert_choice"):
        spec = trouter.RouterSpec(policy=policy, capacity_factor=8.0)
        _, targs = _args(router=spec)
        ja, _ = _args()
        params = _params(ja, wg=wg)
        if policy == "expert_choice":
            params["gate"].pop("wnoise")
        cases[f"skewed_{policy}"] = dict(
            args=targs, params=from_jax_tree(params, device="cpu"),
            x=torch.from_numpy(xs), dy=torch.zeros(T, D), train=False,
            local_aux=True)
    # Tokens drop in the global-plan layers; moa-demo's flat MoE FFN
    # (per-shard capacity) at a factor where no shard drops.
    lm_eval = {}
    for feature, jcfg in (
            ("hierarchical", small_config("kimi-k2-1t-a32b",
                                          moe_hierarchical=(4, 4),
                                          capacity_factor=1.0)),
            ("moa", small_config("moa-demo", capacity_factor=4.0,
                                 moa_router=jrouter.RouterSpec(
                                     capacity_factor=1.0)))):
        tree = lm_params(jcfg, seed=5)
        dc = jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                              batch_size=4, n_clusters=4)
        jbatch = jdata.batch_at(dc, 0)
        _, jm = jax.jit(lambda p, b, c=jcfg: jlm.lm_loss(
            p, b, c, train=False))(tree, jbatch)
        want[f"lm_{feature}"] = {k: float(v) for k, v in jm.items()}
        tcfg = _tcfg(jcfg)
        if jcfg.moa_router is not None:
            tcfg = tcfg.replace(moa_router=trouter.RouterSpec(
                capacity_factor=1.0))
        lm_eval[feature] = dict(
            cfg=tcfg, params=from_jax_tree(tree, device="cpu"),
            batch={k: torch.from_numpy(np.array(v))
                   for k, v in jbatch.items()})
    # Fused decode at a decode shape (T = 8, two rows a rank, one dead).
    ja, targs = _args("swiglu", cf=2.0)
    ja = dataclasses.replace(ja, fused_decode=True)
    params = _params(ja, seed=3)
    xd = rs.randn(8, D).astype(np.float32)
    mask = np.ones((8,), np.float32)
    mask[5] = 0.0
    y, aux = jmoe.moe_apply(params, jnp.asarray(xd), ja, train=False,
                            mask=jnp.asarray(mask))
    want["fused_decode"] = {"y": np.asarray(y), **{
        k: np.asarray(v) for k, v in aux["telemetry"].items()}}
    # Mamba mixers and sliding-window attention served on the mesh:
    # prompts longer than gemma3's 32-token window, so its ring wraps.
    serve_logits = {}
    for feature, arch, s in (("mamba_serving", "falcon-mamba-7b", 16),
                             ("window_serving", "gemma3-27b", 64)):
        jcfg = small_config(arch)
        tree = lm_params(jcfg, seed=6)
        tokens = rs.randint(1, jcfg.vocab_size, (4, s)).astype(np.int32)
        cache = jpm.materialize(jtransformer.cache_defs(jcfg, 4, s + 8),
                                jax.random.PRNGKey(0))
        pre, cache = jlm.lm_prefill(tree, {"tokens": jnp.asarray(tokens)},
                                    cache, jcfg)
        nxt = np.asarray(jnp.argmax(pre, axis=-1)).astype(np.int32)
        step, _ = jlm.lm_decode(tree, jnp.asarray(nxt), cache, s, jcfg)
        want[feature] = {"prefill": np.asarray(pre),
                         "decode": np.asarray(step)}
        serve_logits[feature] = {
            "cfg": _tcfg(jcfg), "params": from_jax_tree(tree, device="cpu"),
            "tokens": torch.from_numpy(tokens),
            "next": torch.from_numpy(nxt), "max_len": s + 8}
    # MoA and the hierarchical MoE pipelined, tokens dropped in their
    # global plans; moa-demo's period-1 variant (every layer MoA and an
    # MoE FFN, the FFN at a factor where no shard drops).
    pipeline = {}
    for i, (feature, jcfg) in enumerate((
            ("pipeline_hierarchical", small_config(
                "kimi-k2-1t-a32b", n_layers=2, moe_hierarchical=(4, 4),
                capacity_factor=0.5)),
            ("pipeline_moa", small_config(
                "moa-demo", n_layers=2, period=1, moa_positions=(0,),
                moe_positions=(0,), capacity_factor=4.0,
                moa_router=jrouter.RouterSpec(capacity_factor=0.5))))):
        pipeline[feature], want[feature] = _pipeline_case(jcfg, seed=i + 7)
    inputs = dict(moe_cases=cases, lm_eval=lm_eval, pipeline=pipeline,
        pipeline_refusals={"pipeline_period2": reduced(
            get_config("moa-demo"))},
        serve_logits=serve_logits,
        fused_case=dict(args=targs, params=from_jax_tree(params,
                                                         device="cpu"),
                        x=torch.from_numpy(xd), mask=torch.from_numpy(mask)),
        batch={"tokens": torch.zeros(4, 32, dtype=torch.int32),
               "labels": torch.zeros(4, 32, dtype=torch.int32)})
    ref_ep = _reference_ep(tmp, ref_cases)
    ranks = workers.spawn("moe", tmp, inputs, 2, 2)
    return {"ranks": ranks, "want": want, "ref_ep": ref_ep()}


def _rows(run, name, key):
    return np.concatenate([r[name][key].numpy() for r in run["ranks"]])


def _same_on_every_rank(run, name):
    r0 = run["ranks"][0][name]
    for r in run["ranks"][1:]:
        assert float(r[name]["aux_loss"]) == float(r0["aux_loss"])
        for k, v in r0["metrics"].items():
            assert float(r[name]["metrics"][k]) == float(v), k
    return r0


@pytest.mark.parametrize("act", ["relu", "swiglu"])
def test_ep_matches_single_device_moe(run, act):
    """No drops, train=True with the JAX draws split by rank: y, the
    combined batch's aux loss and metrics, every parameter's gradient
    (the experts' gathered from their shards) and x's."""
    name = f"nodrop_{act}"
    want = run["want"][name]
    np.testing.assert_allclose(_rows(run, name, "y"), want["y"], **TOL)
    r0 = _same_on_every_rank(run, name)
    np.testing.assert_allclose(float(r0["aux_loss"]), want["aux_loss"],
                               **TOL)
    assert want["metrics"]["fraction_dropped"] == 0.0
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(r0["metrics"][k]), v, **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(_rows(run, name, "dx"), want["dx"], **TOL)
    for r in run["ranks"]:
        flat = jax.tree_util.tree_flatten_with_path(r[name]["grads"])[0]
        wflat = jax.tree_util.tree_flatten_with_path(want["grads"])[0]
        assert [p for p, _ in flat] == [p for p, _ in wflat]
        for (path, g), (_, w) in zip(flat, wflat):
            np.testing.assert_allclose(g.numpy(), w, **TOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("act", ["relu", "swiglu"])
def test_ep_with_drops_matches_reference_ep(run, act):
    """Capacity per shard at factor 1: tokens drop, and the port's
    schedule drops the ones the reference's ``moe_apply_ep`` does."""
    name = f"drops_{act}"
    want = run["ref_ep"][name]
    assert want["metrics"]["fraction_dropped"] > 0
    np.testing.assert_allclose(_rows(run, name, "y"), want["y"], **TOL)
    r0 = _same_on_every_rank(run, name)
    np.testing.assert_allclose(float(r0["aux_loss"]), want["aux_loss"],
                               **TOL)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(r0["metrics"][k]), v, **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("policy", ["noisy_topk", "expert_choice"])
def test_ep_balance_is_the_combined_batchs(run, policy):
    """Every rank routes its tokens to one expert pair (maximally skewed
    locally); the combined batch is balanced and the losses and metrics
    say so (the reference's thresholds)."""
    name = f"skewed_{policy}"
    r0 = _same_on_every_rank(run, name)
    global_aux = float(r0["aux_loss"])
    assert np.isfinite(global_aux)
    if policy == "noisy_topk":
        local_mean = float(np.mean([float(r[name]["local_aux"])
                                    for r in run["ranks"]]))
        assert local_mean > 0.5, local_mean
        assert global_aux < 0.05, global_aux
        assert global_aux < local_mean / 10.0, (global_aux, local_mean)
        assert float(r0["metrics"]["cv_load"]) < 0.2
        assert abs(float(r0["metrics"]["max_over_mean_load"]) - 1.0) < 0.3
    else:
        assert float(r0["metrics"]["cv_load"]) < 1e-3


@pytest.mark.parametrize("feature,why", [
    ("fused_decode", None),
    # Parity checks, under the ids of the refusals they replaced.
    pytest.param("hierarchical", None,
                 id="hierarchical-the hierarchical MoE is not distributed"),
    pytest.param("moa", None, id="moa-MoA is not distributed"),
    pytest.param("mamba_serving", None,
                 id="mamba_serving-serving mamba mixers is not distributed"),
    pytest.param("window_serving", None,
                 id="window_serving-serving sliding-window attention is not "
                    "distributed"),
    pytest.param("pipeline_hierarchical", None,
                 id="pipeline_hierarchical-the hierarchical MoE is not "
                    "pipelined"),
    pytest.param("pipeline_moa", None, id="pipeline_moa-MoA is not pipelined"),
    ("pipeline_period2", "pipeline stages require homogeneous layers")])
def test_unported_features_refuse_on_a_mesh(run, feature, why):
    """Each feature the port once refused on a mesh, now distributed and
    held to JAX, under the refusal's id (four ranks).  Fused decode is
    distributed: a decode-shaped eval call on the
    mesh (routed globally, kernel 8's plain version on each rank's
    experts, the partial outputs summed) gives the rows and the load /
    overflow telemetry of JAX's fused decode on one process.  So are the
    hierarchical MoE and MoA (their global plan): ``lm_loss`` on the
    mesh, with tokens dropped, gives JAX's one-process eval loss (the
    ranks' mean xent) and the same aux loss and metrics on every rank.
    So is serving mamba mixers (their state whole, each rank its slots)
    and sliding-window attention (the ring over ``model``): a whole
    prefill on every rank and a decode step of each rank's slots give
    JAX's one-process logits.  So is the pipeline of MoA mixers (moa-demo's
    period-1 variant) and of the hierarchical MoE, with tokens dropped and
    one row a microbatch, whole on both ``model`` ranks: the ranks' mean
    loss and xent, every rank's aux loss and every gradient are the mean
    over the microbatches of JAX's one-process ``lm_loss``.  A pipelined
    config of period 2 (moa-demo itself) raises the reference's
    ValueError."""
    if feature in ("mamba_serving", "window_serving"):
        want = run["want"][feature]
        for rank, r in enumerate(run["ranks"]):
            got = r["serve_logits"][feature]
            np.testing.assert_allclose(got["prefill"].numpy(),
                                       want["prefill"], **TOL)
            d = rank // 2
            np.testing.assert_allclose(got["decode"].numpy(),
                                       want["decode"][2 * d:2 * d + 2],
                                       **TOL)
        return
    if feature in ("hierarchical", "moa"):
        want = run["want"][f"lm_{feature}"]
        got = [r["lm_eval"][feature] for r in run["ranks"]]
        assert want["fraction_dropped"] > 0
        np.testing.assert_allclose(np.mean([g["xent"] for g in got]),
                                   want["xent"], **TOL)
        for k, v in want.items():
            if k in ("xent", "loss"):
                continue
            for g in got:
                np.testing.assert_allclose(g[k], v, **TOL, err_msg=k)
        return
    if feature in ("pipeline_hierarchical", "pipeline_moa"):
        want = run["want"][feature]
        got = [r["pipeline"][feature] for r in run["ranks"]]
        assert want["fraction_dropped"] > 0
        for k in ("loss", "xent"):
            np.testing.assert_allclose(np.mean([g[k] for g in got]), want[k],
                                       **TOL, err_msg=k)
        for g in got:
            np.testing.assert_allclose(g["aux_loss"], want["aux_loss"],
                                       **TOL)
            flat = jax.tree_util.tree_flatten_with_path(g["grads"])[0]
            wflat = jax.tree_util.tree_flatten_with_path(want["grads"])[0]
            assert [p for p, _ in flat] == [p for p, _ in wflat]
            for (path, t), (_, w) in zip(flat, wflat):
                np.testing.assert_allclose(t.numpy(), w, **TOL,
                                           err_msg=str(path))
        return
    if feature == "pipeline_period2":
        with pytest.raises(ValueError) as err:
            jpp.pipeline_block_defs(small_config("moa-demo"), 2)
        assert why in str(err.value)
        for r in run["ranks"]:
            assert r["refusals"][feature] == str(err.value)
        return
    if feature == "fused_decode":
        want = run["want"]["fused_decode"]
        got = np.concatenate([r["fused_decode"]["y"].numpy()
                              for r in run["ranks"]])
        np.testing.assert_allclose(got, want["y"], **TOL)
        for r in run["ranks"]:
            for k in ("expert_load", "overflow"):
                np.testing.assert_array_equal(
                    r["fused_decode"]["telemetry"][k].numpy(), want[k])
        return


def test_ep_refuses_experts_that_do_not_divide(run):
    """An expert count that does not divide over the plan's expert axis
    raises (the reference's check), not a silent fallback to replicated
    experts."""
    for r in run["ranks"]:
        msg = r["refusals"]["indivisible_experts"]
        assert msg is not None and "must divide over ep=2" in msg, msg
