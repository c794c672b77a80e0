"""The GPipe pipeline (``train/pipeline.py``) with MoA mixers, the
hierarchical MoE and rows held whole on the ``model`` ranks, on gloo
ranks on the CPU, against JAX's ``pipeline_lm_loss``.

Four cases, each on (stage 2 x model 2) in one spawn of
``torch_dist_workers.py`` (``case_pipeline``) at ``train=True`` with the
reference's noise chain (``fold_in(rng, mb * n_stages + stage)``, then
``fold_in(layer)``; MoA's from ``fold_in(·, 1)`` of that key, the
hierarchical MoE's two levels from its split), each against JAX's own
``pipeline_lm_loss`` on a (2, 2) mesh of four fake host devices, one
subprocess a case, all running while the ranks do:

* ``one_row``: the small kimi-k2 family model with 4 rows in 4
  microbatches, one row a microbatch: each ``model`` rank holds the row
  whole and its flat MoE layers split the row's tokens;
* ``moa``: moa-demo's period-1 variant (every layer an MoA mixer and an
  MoE FFN), MoA dropping tokens at its own capacity factor 0.5 (the
  flat MoE FFN, with its per-shard capacity, drops none);
* ``hierarchical``: the kimi family with a (2, 4) hierarchical MoE at
  capacity factor 0.5 (drops at both levels);
* ``moa_ragged``: the period-1 MoA model at 3 layers on 2 stages, each
  package's ``zero_identity_padding`` applied to the same tree: the
  padding layer's MoE output is zeroed and its MoA output is not (the
  reference's list has no MoA projection, ROADMAP C.5), so the port
  computes what the reference computes.

The loss (the ranks' mean), the xent, the aux loss (every rank's) and
every gradient, at ``test_torch_pipeline.py``'s tolerances: loss 2e-4
relative, gradients rtol 2e-3, atol 2e-5.
"""
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
from test_torch_hierarchical import jax_noise

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.core.router import RouterSpec as JRouterSpec
from repro.train import pipeline as jpp
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.configs.base import layer_kinds
from repro_torch.core.router import RouterSpec as TRouterSpec
from repro_torch.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, N_STAGES = 16, 2
LOSS_TOL = dict(rtol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
SMALL = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
             vocab_size=128, moe_d_ff=32, d_ff=32, q_block=16, kv_block=16,
             remat=False)
PERIOD1 = dict(period=1, moa_positions=(0,), moe_positions=(0,),
               n_experts=4, moe_k=2, moa_experts=4, moa_k=2,
               moa_heads_per_expert=2, capacity_factor=8.0)
# name -> (arch, overrides, MoA's capacity factor, rows, microbatches)
CASES = {
    "one_row": ("kimi-k2-1t-a32b", dict(n_layers=4, n_experts=4, moe_k=2,
                                        capacity_factor=8.0), None, 4, 4),
    "moa": ("moa-demo", dict(PERIOD1, n_layers=4), 0.5, 8, 4),
    "hierarchical": ("kimi-k2-1t-a32b", dict(
        n_layers=4, n_experts=8, moe_k=2, moe_hierarchical=(2, 4),
        capacity_factor=0.5), None, 8, 4),
    "moa_ragged": ("moa-demo", dict(PERIOD1, n_layers=3), 0.5, 8, 4),
}
SEED = 7


def _cfgs(name):
    arch, kw, moa_cf, _, _ = CASES[name]
    jcfg = jget_config(arch).replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32,
        kernel_backend="ref", **SMALL, **kw)
    tcfg = tget_config(arch, param_dtype=torch.float32,
                       compute_dtype=torch.float32, **SMALL, **kw)
    if moa_cf is not None:
        jcfg = jcfg.replace(moa_router=JRouterSpec(capacity_factor=moa_cf))
        tcfg = tcfg.replace(moa_router=TRouterSpec(capacity_factor=moa_cf))
    return jcfg, tcfg


def _tree(jcfg, seed):
    """The pipelined tree of a JAX materialization, every gate redrawn
    (a zero gate routes every token to the first experts)."""
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(jpp.pipeline_param_defs(jcfg, N_STAGES),
                        jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if getattr(path[-1], "key", None) == "wg":
            leaf[...] = rs.randn(*leaf.shape)
    return tree


def _draws(tcfg, rng, rows, n_micro):
    """The reference pipeline's draws as the port's ``make_draws``
    tree."""
    per = -(-tcfg.n_layers // N_STAGES)
    kind = layer_kinds(tcfg)[0]
    t = rows // n_micro * S
    noise = [[[None] * per for _ in range(N_STAGES)] for _ in range(n_micro)]
    moa = [[[None] * per for _ in range(N_STAGES)] for _ in range(n_micro)]
    for mb in range(n_micro):
        for sid in range(N_STAGES):
            for i in range(per):
                key = jax.random.fold_in(
                    jax.random.fold_in(rng, mb * N_STAGES + sid), i)
                if tcfg.moe_hierarchical:
                    a, b = tcfg.moe_hierarchical
                    spec_p, _ = ttransformer.hmoe_lib._level_specs(
                        ttransformer._hmoe_args(tcfg))
                    noise[mb][sid][i] = jax_noise(
                        key, t, a, b, spec_p.capacity(t, a, train=True))
                else:
                    noise[mb][sid][i] = torch.from_numpy(np.array(
                        jax.random.normal(key, (t, tcfg.n_experts))))
                if kind.mixer == "moa":
                    moa[mb][sid][i] = torch.from_numpy(np.array(
                        jax.random.normal(jax.random.fold_in(key, 1),
                                          (t, tcfg.moa_experts))))
    return {"noise": noise, "moa_noise": moa}


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config
    from repro.core.router import RouterSpec
    from repro.sharding import context
    from repro.train import pipeline as pp
    arch, kw, moa_cf, n_micro, seed, pad, path = sys.argv[1:]
    cfg = get_config(arch).replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32,
        kernel_backend="ref", **eval(kw))
    if moa_cf != "None":
        cfg = cfg.replace(moa_router=RouterSpec(capacity_factor=float(
            moa_cf)))
    mesh = context.make_mesh((2, 2), ("data", "model"))
    data = np.load(os.path.join(path, "in.npz"))
    params = {}
    for key in data.files:
        if key.startswith("p/"):
            node = params
            parts = key[2:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(data[key])
    if pad == "True":
        params["blocks"] = pp.zero_identity_padding(params["blocks"], cfg,
                                                    2)
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}
    def f(p):
        return pp.pipeline_lm_loss(p, batch, cfg, mesh=mesh, n_stages=2,
                                   n_micro=int(n_micro),
                                   rng=jax.random.PRNGKey(int(seed)),
                                   train=True)
    (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    out = {"m/" + k: np.asarray(v) for k, v in m.items()}
    for p, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        out["g/" + "/".join(str(getattr(k, "key", k)) for k in p)] = (
            np.asarray(v))
    np.savez(os.path.join(path, "out.npz"), **out)
""")


def _reference(tmp, name, tree, batch):
    """JAX's pipeline_lm_loss of case ``name`` in a subprocess; the
    returned function waits for it and gives its metrics and
    gradients."""
    arch, kw, moa_cf, _, n_micro = CASES[name]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(os.path.join(tmp, "in.npz"), tokens=batch["tokens"],
             labels=batch["labels"], **{"p/" + k: v for k, v in flat.items()})
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, arch, repr(dict(SMALL, **kw)),
         repr(moa_cf), str(n_micro), str(SEED), str(name == "moa_ragged"),
         tmp],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))

    def wait() -> dict:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(os.path.join(tmp, "out.npz"))
        return {k: got[k] for k in got.files}
    return wait


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = jax.random.PRNGKey(SEED)
    refs, cases = {}, {}
    for i, name in enumerate(CASES):
        jcfg, tcfg = _cfgs(name)
        _, _, _, rows, n_micro = CASES[name]
        tree = _tree(jcfg, seed=i)
        tokens = np.random.RandomState(i).randint(
            1, 128, (rows, S)).astype(np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
        refs[name] = _reference(str(tmp_path_factory.mktemp(name)), name,
                                tree, batch)
        cases[name] = {"cfg": tcfg, "n_stages": N_STAGES, "n_micro": n_micro,
                       "params": from_jax_tree(tree, device="cpu"),
                       "batch": {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                       "train": True, "pad": name == "moa_ragged",
                       "draws": _draws(tcfg, rng, rows, n_micro)}
    ranks = workers.spawn("pipeline", tmp_path_factory.mktemp("ranks"),
                          {"cases": cases}, N_STAGES, 2, timeout=600)
    return {"ranks": ranks, "ref": {k: w() for k, w in refs.items()}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_loss_matches_jax_pipeline(run, name):
    """The ranks' mean loss and xent and every rank's aux loss are JAX's
    ``pipeline_lm_loss``'s; the routed cases drop tokens."""
    ref, ranks = run["ref"][name], [r[name] for r in run["ranks"]]
    for key in ("loss", "xent"):
        np.testing.assert_allclose(np.mean([r[key] for r in ranks]),
                                   float(ref["m/" + key]), **LOSS_TOL)
    assert float(ref["m/aux_loss"]) > 0
    for r in ranks:
        np.testing.assert_allclose(r["aux_loss"], float(ref["m/aux_loss"]),
                                   **LOSS_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_gradients_match_jax_pipeline(run, name):
    """Every gradient (the stacked [2, per, ...] blocks as they are) on
    every rank is JAX's."""
    ref = run["ref"][name]
    for r in run["ranks"]:
        flat = jax.tree_util.tree_flatten_with_path(r[name]["grads"])[0]
        assert len(flat) == sum(k.startswith("g/") for k in ref)
        for path, g in flat:
            key = "g/" + "/".join(str(p.key) for p in path)
            np.testing.assert_allclose(g.numpy(), ref[key], **GRAD_TOL,
                                       err_msg=key)


def test_moa_padding_layer_is_the_references(run):
    """The ragged MoA stack's padding layer keeps its MoA output
    projection (the reference zeroes none), so its MoA output still
    moves the loss: that projection's gradient there is nonzero, and the
    port's is the reference's."""
    ref = run["ref"]["moa_ragged"]
    wo = ref["g/blocks/moa/wo"]
    assert np.abs(wo[-1, -1]).max() > 0
    g = run["ranks"][0]["moa_ragged"]["grads"]["blocks"]["moa"]["wo"]
    np.testing.assert_allclose(g.numpy()[-1, -1], wo[-1, -1], **GRAD_TOL)
