"""MoA and the hierarchical MoE on a mesh (their global plan,
``core/expert_parallel.py::GlobalPlan``) on gloo CPU ranks, against the
JAX package's one process.

The reference runs both layers under GSPMD: its mesh run is its
one-process run, capacity counted from the global token count, so the
port's ranks are held to JAX's one process with tokens dropped.  One
spawn of ``torch_dist_workers.py`` (``case_routed``, which imports the
port only) a mesh, the three run concurrently while the JAX side runs
here:

* (2, 2): ``moa_apply`` with and without drops and ``hmoe_apply`` with
  drops at both levels, at ``train=True`` with the JAX noise (the
  global draw on every rank): each rank's rows of y, the aux loss,
  metrics and telemetry the same on every rank, every gradient and x's;
* (2, 2) and (4, 1): step 0 of the small moa-demo LM (MoA drops; its
  flat MoE FFN, which keeps the per-shard capacity of ``moe_apply_ep``,
  at a factor where no shard drops) and of the small paper LM with
  ``hierarchical=(2, 2)`` (drops at both levels): loss, metrics and
  every gradient from the JAX draws;
* (1, 2) and (2, 2): moa-demo (whole prompts, fused decode) and a small
  hierarchical transformer (whole and chunked prompts) served by
  ``ServeEngine(ctx=)``: greedy streams equal the JAX engine's; a
  prefill and a decode step's logits equal JAX's ``lm_prefill`` /
  ``lm_decode``;
* (2, 2): a training step of each reduced model under the collective
  recorder: the table equals what each rank handed torch.distributed
  and what the dry run traces on ``meta`` under a fake (2, 2) group.

Tolerances: layers and logits rtol 2e-4 / atol 2e-5 (the reference's
expert-parallel tolerance, ``tests/test_distributed.py``); a step's
loss, metrics and gradients 1e-5, as ``test_torch_distributed_train.py``.
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
from test_torch_hierarchical import _cp, _paper_draws, _redraw_gates
from test_torch_hierarchical import jax_noise
from test_torch_lm import _jax_draws as lm_jax_draws
from test_torch_lm import _params as lm_params
from test_torch_lm import _tcfg
from test_torch_serve_mesh import MAX_LEN, N_SLOTS, _jax_run, _traces

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.core import hierarchical as jh
from repro.core import moa as jmoa
from repro.core.router import RouterSpec as JRouterSpec
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.models import paper_lm as jpl
from repro.models import transformer as jtransformer
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import hierarchical as th
from repro_torch.core import moa as tmoa
from repro_torch.core.router import RouterSpec as TRouterSpec
from repro_torch.data import pipeline as tdata
from repro_torch.launch.train import reduced
from repro_torch.models import lm as tlm
from repro_torch.models import paper_lm as tpl
from repro_torch.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x2": (1, 2)}
TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
MB, MS = 4, 32                  # MoA layer: batch rows x sequence
HT = 64                         # hierarchical layer: tokens
SERVE = dict(n_layers=2, d_model=32, n_heads=4, head_dim=16, vocab_size=64,
             n_experts=4, moe_k=2, moe_d_ff=32, param_dtype=jnp.float32,
             compute_dtype=jnp.float32, q_block=16, kv_block=16,
             kernel_backend="ref")
SERVE_CFGS = {
    "moa": dict(n_kv_heads=1, d_ff=64, moa_experts=4, moa_k=2,
                moa_heads_per_expert=2),
    "hier": dict(n_kv_heads=2, moe_hierarchical=(2, 4)),
}
SERVE_TRAFFIC = {"moa": ("whole", "fused"), "hier": ("whole", "chunked")}
RECORD = {"moa": ("moa-demo", {}),
          "hier": ("kimi-k2-1t-a32b", {"moe_hierarchical": (2, 4)})}
RECORD_B, RECORD_S = 4, 32


def _named(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _moa_layer(cf: float, seed: int):
    kw = dict(n_experts=4, k=2, d_model=64, n_heads_per_expert=2,
              head_dim=16, n_kv_heads=1, qk_norm=True, q_block=32,
              kv_block=32, capacity_factor=cf)
    ja = jmoa.MoAArgs(dtype=jnp.float32, **kw)
    tree = _np(jpm.materialize(jmoa.moa_defs(ja), jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    tree["gate"]["wg"] = rs.randn(*tree["gate"]["wg"].shape).astype(
        np.float32)
    x = rs.randn(MB, MS, 64).astype(np.float32)
    dy = rs.randn(MB, MS, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(MS)[None], (MB, MS)).astype(np.int32)
    key = jax.random.PRNGKey(seed + 2)

    def loss(p, xx):
        y, aux = jmoa.moa_apply(p, xx, ja, positions=jnp.asarray(pos),
                                train=True, rng=key)
        return jnp.sum(y * dy) + aux["aux_loss"], (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(tree, jnp.asarray(x))
    case = dict(kind="moa", args=dict(dtype=torch.float32, **kw),
                params=from_jax_tree(tree, device="cpu"),
                x=torch.from_numpy(x), dy=torch.from_numpy(dy),
                pos=torch.from_numpy(pos),
                noise=torch.from_numpy(np.array(jax.random.normal(
                    key, (MB * MS, 4)))))
    return case, _want(y, aux, gp, gx)


def _hmoe_layer(seed: int):
    kw = dict(n_groups=4, n_experts_per_group=4, k_primary=2, k_secondary=2,
              d_model=16, d_ff=32, capacity_factor=1.0)
    ja = jh.HMoEArgs(dtype=jnp.float32, kernel_backend="ref", **kw)
    tree = _np(jpm.materialize(jh.hmoe_defs(ja), jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    _redraw_gates(tree, rs)
    x = rs.randn(HT, 16).astype(np.float32)
    dy = rs.randn(HT, 16).astype(np.float32)
    key = jax.random.PRNGKey(seed + 2)

    def loss(p, xx):
        y, aux = jh.hmoe_apply(p, xx, ja, train=True, rng=key)
        return jnp.sum(y * dy) + aux["aux_loss"], (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(tree, jnp.asarray(x))
    case = dict(kind="hmoe", args=dict(dtype=torch.float32, **kw),
                params=from_jax_tree(tree, device="cpu"),
                x=torch.from_numpy(x), dy=torch.from_numpy(dy),
                noise=jax_noise(key, HT, 4, 4, _cp(ja, t=HT)))
    return case, _want(y, aux, gp, gx)


def _want(y, aux, gp, gx) -> dict:
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "aux_loss": float(aux["aux_loss"]),
            "metrics": {k: float(v) for k, v in aux["metrics"].items()},
            "telemetry": {k: np.asarray(v)
                          for k, v in aux["telemetry"].items()},
            "grads": _np(gp)}


# ---------------------------------------------------------------------------
# the models' step 0
# ---------------------------------------------------------------------------

def _moa_model():
    """moa-demo's small config: MoA drops at capacity factor 1 (its own
    router), the flat MoE FFN at factor 4 drops on no shard."""
    jcfg = small_config("moa-demo", capacity_factor=4.0,
                        moa_router=JRouterSpec(capacity_factor=1.0))
    tcfg = _tcfg(jcfg).replace(moa_router=TRouterSpec(capacity_factor=1.0))
    tree = lm_params(jcfg, seed=3)
    dc = jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                          batch_size=4, n_clusters=4)
    rng = jax.random.PRNGKey(13)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jdata.batch_at(dc, 0), jcfg, rng=rng),
        has_aux=True))(tree)
    draws = lm_jax_draws(rng, tcfg, t=4 * 32)
    draws["moa_noise"] = [None] * tcfg.n_layers
    for layer, kind in ttransformer.layer_index(tcfg):
        if kind.mixer == "moa":
            key = jax.random.fold_in(jax.random.fold_in(rng, layer), 1)
            draws["moa_noise"][layer] = torch.from_numpy(np.array(
                jax.random.normal(key, (4 * 32, tcfg.moa_experts))))
    model = dict(kind="lm", cfg=tcfg,
                 params=from_jax_tree(tree, device="cpu"), jax_draws=draws,
                 batch=tdata.batch_at(tdata.DataConfig(
                     vocab_size=jcfg.vocab_size, seq_len=32, batch_size=4,
                     n_clusters=4), 0, device="cpu"))
    return model, (float(jl), {k: float(v) for k, v in jm.items()}, _np(jg))


def _paper_model():
    """The small paper LM with a (2, 2) hierarchy at capacity factor
    0.5: both levels drop."""
    common = dict(vocab_size=64, variant="moe", d_model=32, n_experts=4,
                  hierarchical=(2, 2), expert_hidden=48,
                  capacity_factor=0.5)
    jcfg = jpl.PaperLMConfig(kernel_backend="ref", **common)
    tcfg = tpl.PaperLMConfig(**common)
    tree = _np(jpm.materialize(jpl.paper_lm_defs(jcfg),
                               jax.random.PRNGKey(1)))
    _redraw_gates(tree["moe"], np.random.RandomState(1))
    dc = dict(vocab_size=64, seq_len=8, batch_size=4, n_clusters=4)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jpl.paper_lm_loss(p, jdata.batch_at(
            jdata.DataConfig(**dc), 0), jcfg, rng=rng),
        has_aux=True))(tree)
    cp = _cp(jpl._hmoe_args(jcfg), t=32)
    model = dict(kind="paper", cfg=tcfg,
                 params=from_jax_tree(tree, device="cpu"),
                 jax_draws=_paper_draws(rng, tcfg, 4, 8, cp),
                 batch=tdata.batch_at(tdata.DataConfig(**dc), 0,
                                      device="cpu"))
    return model, (float(jl), {k: float(v) for k, v in jm.items()}, _np(jg))


# ---------------------------------------------------------------------------
# serving, logits, the recorder
# ---------------------------------------------------------------------------

def _serve_cfgs(name):
    base = "moa-demo" if name == "moa" else "kimi-k2-1t-a32b"
    jcfg = jget_config(base).replace(**SERVE, **SERVE_CFGS[name])
    return jcfg, _tcfg(jcfg)


def _serving():
    traces = _traces()
    cases, want, logits, want_logits = {}, {}, {}, {}
    for name in SERVE_CFGS:
        jcfg, tcfg = _serve_cfgs(name)
        tree = lm_params(jcfg, seed=2)
        tparams = from_jax_tree(tree, device="cpu")
        for traffic in SERVE_TRAFFIC[name]:
            trace, kw = traces[traffic]
            cases[f"{name}-{traffic}"] = {
                "cfg": tcfg, "params": tparams, "trace": trace,
                "sc": dict(max_len=MAX_LEN, n_slots=N_SLOTS, **kw)}
            # The JAX fused decode (ref backend) is its unfused path.
            want[f"{name}-{traffic}"] = _jax_run(
                jcfg, tree, traces["whole" if traffic == "fused"
                                   else traffic][0], kw)
        tokens = np.random.RandomState(4).randint(
            1, 64, (N_SLOTS, 16)).astype(np.int32)
        cache = jpm.materialize(jtransformer.cache_defs(jcfg, N_SLOTS,
                                                        MAX_LEN),
                                jax.random.PRNGKey(0))
        pre, cache = jlm.lm_prefill(tree, {"tokens": jnp.asarray(tokens)},
                                    cache, jcfg)
        nxt = np.asarray(jnp.argmax(pre, axis=-1)).astype(np.int32)
        step, _ = jlm.lm_decode(tree, jnp.asarray(nxt), cache, 16, jcfg)
        logits[name] = {"cfg": tcfg, "params": tparams,
                        "tokens": torch.from_numpy(tokens),
                        "next": torch.from_numpy(nxt), "max_len": MAX_LEN}
        want_logits[name] = {"prefill": np.asarray(pre),
                             "decode": np.asarray(step)}
    return cases, want, logits, want_logits


def _record_cfg(name):
    arch, kw = RECORD[name]
    return reduced(tget_config(arch)).replace(**kw)


_DRY = """
import json, sys
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_step
from repro_torch.launch.train import reduced
out = {}
mesh = dryrun.fake_mesh({"data": 2, "model": 2})
for name, (arch, kw) in json.loads(sys.argv[1]).items():
    kw = {k: tuple(v) for k, v in kw.items()}
    cfg = reduced(get_config(arch)).replace(**kw)
    spec = build_step(cfg, ShapeSpec("t", "train", %d, %d), mesh)
    out[name] = dryrun.trace_step(spec, flops=False)["collectives"]
json.dump(out, sys.stdout)
""" % (RECORD_S, RECORD_B)


def _recording():
    cases = {}
    for name in RECORD:
        cfg = _record_cfg(name)
        cases[name] = {
            "cfg": cfg, "seq": RECORD_S, "batch": RECORD_B,
            "params": tpm.materialize(tlm.lm_defs(cfg),
                                      torch.Generator().manual_seed(0),
                                      "cpu"),
            "batch_data": tdata.batch_at(tdata.DataConfig(
                vocab_size=cfg.vocab_size, seq_len=RECORD_S,
                batch_size=RECORD_B, n_clusters=4), 0, device="cpu")}
    return cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    layers, want_layers = {}, {}
    for name, (case, want) in {"moa_nodrop": _moa_layer(8.0, 0),
                               "moa_drops": _moa_layer(1.0, 4),
                               "hmoe_drops": _hmoe_layer(6)}.items():
        layers[name], want_layers[name] = case, want
    models, want_models = {}, {}
    for name, (model, want) in {"moa": _moa_model(),
                                "paper_h": _paper_model()}.items():
        models[name], want_models[name] = model, want
    cases, want_serve, logits, want_logits = _serving()
    record = _recording()
    inputs = {
        "2x2": dict(layers=layers, models=models, serve=cases,
                    logits=logits, record=record),
        "4x1": dict(models=models),
        "1x2": dict(serve=cases, logits=logits)}
    waits = {mesh: workers.start("routed", tmp_path_factory.mktemp(mesh),
                                 inputs[mesh], *MESHES[mesh], timeout=600)
             for mesh in MESHES}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    dry = subprocess.run(
        [sys.executable, "-c", _DRY,
         json.dumps({k: [a, kw] for k, (a, kw) in RECORD.items()})],
        env=env, capture_output=True, text=True, timeout=300)
    assert dry.returncode == 0, dry.stderr[-4000:]
    return {"ranks": {mesh: wait() for mesh, wait in waits.items()},
            "layers": want_layers, "models": want_models,
            "serve": want_serve, "logits": want_logits,
            "dry": json.loads(dry.stdout)}


def _grads_close(got, want, tol, what=""):
    flat, wflat = _named(got), _named(want)
    assert [p for p, _ in flat] == [p for p, _ in wflat]
    for (path, g), (_, w) in zip(flat, wflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", ["moa_nodrop", "moa_drops", "hmoe_drops"])
def test_layer_on_mesh_matches_jax(run, name):
    """Each rank's rows of y and of dx; the aux loss, metrics and
    telemetry equal on every rank and JAX's; every gradient."""
    want = run["layers"][name]
    ranks = [r["layers"][name] for r in run["ranks"]["2x2"]]
    y = np.concatenate([r["y"].reshape(-1, want["y"].shape[-1]).numpy()
                        for r in ranks])
    np.testing.assert_allclose(y, want["y"].reshape(y.shape), **TOL)
    dx = np.concatenate([r["dx"].reshape(-1, y.shape[-1]).numpy()
                         for r in ranks])
    np.testing.assert_allclose(dx, want["dx"].reshape(dx.shape), **TOL)
    dropped = want["metrics"]["fraction_dropped"]
    assert (dropped > 0) == name.endswith("drops"), dropped
    for r in ranks:
        np.testing.assert_allclose(float(r["aux_loss"]), want["aux_loss"],
                                   **TOL)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(float(r["metrics"][k]), v, **TOL,
                                       err_msg=k)
        for k, v in want["telemetry"].items():
            np.testing.assert_array_equal(r["telemetry"][k].numpy(), v)
        _grads_close(r["grads"], want["grads"], TOL, name)
    if name == "hmoe_drops":
        assert float(want["telemetry"]["overflow"].sum()) > 0


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
@pytest.mark.parametrize("model", ["moa", "paper_h"])
def test_step0_on_mesh_matches_jax(run, model, mesh):
    """Step 0 from the JAX draws: the ranks' mean loss, the aux loss and
    metrics (one process's on every rank) and every gradient."""
    jl, jm, jg = run["models"][model]
    assert jm["fraction_dropped"] > 0
    for r in run["ranks"][mesh]:
        got = r["train"][model]
        np.testing.assert_allclose(got["metrics0"]["loss"], jl, rtol=1e-5)
        for k, v in jm.items():
            if k in got["metrics0"]:
                np.testing.assert_allclose(got["metrics0"][k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        _grads_close(got["grads0"], jg, STEP_TOL, model)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("case", ["moa-whole", "moa-fused", "hier-whole",
                                  "hier-chunked"])
def test_served_on_mesh_matches_jax(run, case, mesh):
    """Every rank's greedy streams are the JAX engine's off a mesh, its
    prefill counters too."""
    want = run["serve"][case]
    for out in run["ranks"][mesh]:
        got = out["serve"][case]
        assert got["done"]
        assert got["streams"] == want["streams"]
        for key in ("prefills", "prefill_chunks", "generated_tokens"):
            assert got["stats"][key] == want["stats"][key], key


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("name", ["moa", "hier"])
def test_logits_on_mesh_match_jax(run, name, mesh):
    """lm_prefill's logits (whole rows on every rank) and one lm_decode
    step's (each rank's slots, the page relaid onto the decode plan)."""
    want = run["logits"][name]
    data, model = MESHES[mesh]
    n = N_SLOTS // data
    for rank, out in enumerate(run["ranks"][mesh]):
        got = out["logits"][name]
        np.testing.assert_allclose(got["prefill"].numpy(), want["prefill"],
                                   **TOL)
        d = rank // model
        np.testing.assert_allclose(got["decode"].numpy(),
                                   want["decode"][d * n:(d + 1) * n], **TOL)


@pytest.mark.parametrize("name", sorted(RECORD))
def test_recorded_collectives_match_the_dry_run(run, name):
    """A training step's collectives: the recorder's table on each gloo
    rank equals what the rank handed torch.distributed, and the dry
    run's trace on meta under a fake (2, 2) group."""
    dry = run["dry"][name]
    assert dry["all_gather"]["calls"] > 0
    for out in run["ranks"]["2x2"]:
        rec = out["record"][name]
        assert set(rec["recorded"]) == set(rec["sent"]) == set(dry)
        for op in dry:
            assert rec["recorded"][op]["calls"] == rec["sent"][op][
                "calls"] == dry[op]["calls"], op
            assert rec["recorded"][op]["bytes"] == pytest.approx(
                rec["sent"][op]["bytes"], rel=1e-12), op
            assert rec["recorded"][op]["bytes"] == pytest.approx(
                dry[op]["bytes"], rel=1e-12), op


def test_global_plan_replicates_experts_that_do_not_divide():
    """moa-demo's 8 head groups over a 16-wide model axis: the plan's
    resolution falls back to replicated groups (every rank runs all of
    them), where the flat MoE's schedule refuses."""
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.sharding.context import MeshContext

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 16)

        def get_local_rank(self, axis):
            return 3 if axis == "model" else 0
    ctx = MeshContext.for_mesh(Mesh(), "dp_tp_ep")
    a = tmoa.MoAArgs(n_experts=8, k=2, d_model=64, n_heads_per_expert=2,
                     head_dim=16)
    gp = ep_lib.GlobalPlan.build(ctx, tmoa.moa_defs(a), 8)
    assert (gp.expert_axes, gp.e0, gp.n) == ((), 0, 8)
    h = th.HMoEArgs(n_groups=32, n_experts_per_group=4, k_primary=2,
                    k_secondary=2, d_model=16, d_ff=32)
    gp = ep_lib.GlobalPlan.build(ctx, th.hmoe_defs(h), 32)
    assert (gp.expert_axes, gp.e0, gp.n) == (("model",), 6, 2)
