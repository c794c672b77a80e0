"""The port's GPipe pipeline (``train/pipeline.py``) on gloo ranks on the
CPU, against the JAX package.

A kimi-k2 family model of 7 layers (MoE in every layer, f32, capacity
factor 8: no shard drops a token) pipelined with a ragged depth: 7
layers pad to 8 with one identity layer, on meshes (stage 2 x model 2)
and (stage 4 x model 1), 4 microbatches of the global batch [8, 16].
Each mesh is one spawn of ``torch_dist_workers.py`` (``case_pipeline``);
the JAX side runs here, on the same parameters (the 7 layers of a
JAX-materialized tree, gates redrawn, then the zero padding layer).

* ``train=False`` with the balance weights on: the pipelined loss
  against the mean over microbatches of JAX's sequential ``lm_loss`` of
  the padded 8-layer stack (the padding layer is an exact identity, but
  its gate routes and adds its balance loss, in both); the xent against
  ``lm_loss`` of the whole batch, the aux loss against the mean of the
  per-microbatch aux losses; every gradient.
* ``train=True`` with the reference's noise chain (``fold_in(rng, mb *
  n_stages + stage)`` then ``fold_in(layer)``): loss and every gradient
  against the same layer loop in JAX (``transformer.block_apply`` with
  those keys), and against JAX's ``pipeline_lm_loss`` itself on a (2, 2)
  mesh of four fake host devices, in a subprocess.
* Two ``make_pipeline_train_step`` steps: the ranks agree and the loss
  falls.

Tolerances are the reference test's (``tests/test_pipeline.py``): the
loss to 2e-4 relative, gradients to rtol 2e-3, atol 2e-5.
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

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.configs.base import layer_kinds as jlayer_kinds
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layers=7, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=128, n_experts=4, moe_k=2, moe_d_ff=32,
             q_block=16, kv_block=16, capacity_factor=8.0, remat=False)
B, S, N_MICRO, TOTAL = 8, 16, 4, 8
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
LOSS_TOL = dict(rtol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _cfgs():
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32,
        kernel_backend="ref", **SMALL)
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, **SMALL)
    return jcfg, tcfg


def _padded_blocks(jcfg):
    """The 7 layers' stacked blocks (gates redrawn) and a zero layer: the
    8-layer sequential stack."""
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    seq = tree["blocks"]["periods"]["pos0"]
    seq["moe"]["gate"]["wg"] = np.random.RandomState(0).randn(
        *seq["moe"]["gate"]["wg"].shape).astype(np.float32)
    pad = jax.tree_util.tree_map(
        lambda a: np.concatenate([a, np.zeros_like(a[:1])]), seq)
    return tree, pad


def _noise_keys(rng, n_stages):
    """[n_micro, TOTAL] keys, layer l of microbatch mb the reference
    pipeline's ``fold_in(fold_in(rng, mb * n_stages + l // per), l %
    per)``."""
    per = TOTAL // n_stages
    return jnp.stack([jnp.stack([
        jax.random.fold_in(jax.random.fold_in(rng, mb * n_stages + l // per),
                           l % per) for l in range(TOTAL)])
        for mb in range(N_MICRO)])


def _jax_layer_loop(jcfg, params, batch, keys):
    """The mean over microbatches of the sequential 8-layer stack's loss
    (a scan over the layers, mapped over the microbatches), layer l of
    microbatch mb drawing its gate noise from keys[mb, l]."""
    kind = jlayer_kinds(jcfg)[0]
    cfg8 = jcfg.replace(n_layers=TOTAL)
    b_mb = B // N_MICRO
    pos = jnp.broadcast_to(jnp.arange(S)[None], (b_mb, S))

    def one(tok, lab, mb_keys):
        def layer(carry, xs):
            x, aux = carry
            p_l, key = xs
            x, a = jtransformer.block_apply(p_l, x, kind, cfg8,
                                            positions=pos, rng=key,
                                            train=True)
            return (x, aux + a["aux_loss"]), None
        x = jlayers.embed(params["embed"], tok, cfg8.compute_dtype)
        (x, aux), _ = jax.lax.scan(layer, (x, jnp.zeros(())),
                                   (params["blocks"], mb_keys))
        x = jlayers.rmsnorm(params["ln_f"], x, cfg8.norm_eps)
        return jlm.chunked_xent(params, x, lab, cfg8, chunk=S) + aux
    split = lambda t: t.reshape(N_MICRO, b_mb, S)  # noqa: E731
    return jnp.mean(jax.lax.map(lambda a: one(*a), (
        split(batch["tokens"]), split(batch["labels"]), keys)))


def _stage_stack(blocks, n_stages):
    return jax.tree_util.tree_map(
        lambda a: a.reshape((n_stages, TOTAL // n_stages) + a.shape[1:]),
        blocks)


def _reference_pipeline(tmp, tree, pad, batch, seed):
    """JAX's pipeline_lm_loss (train=True, the key ``seed``) on a (2, 2)
    mesh of four fake devices, in a subprocess; the returned function
    waits for it and gives its loss and gradients."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                dict(tree, blocks=_stage_stack(pad, 2)))[0]}
    np.savez(os.path.join(tmp, "pp_in.npz"), tokens=batch["tokens"],
             labels=batch["labels"], **{"p/" + k: v for k, v in flat.items()})
    kw = repr(SMALL)
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import get_config
        from repro.sharding import context
        from repro.train import pipeline as pp
        cfg = get_config("kimi-k2-1t-a32b").replace(
            param_dtype=jnp.float32, compute_dtype=jnp.float32,
            kernel_backend="ref", **{kw})
        mesh = context.make_mesh((2, 2), ("data", "model"))
        data = np.load({os.path.join(tmp, "pp_in.npz")!r})
        params = {{}}
        for key in data.files:
            if key.startswith("p/"):
                node = params
                parts = key[2:].split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {{}})
                node[parts[-1]] = jnp.asarray(data[key])
        batch = {{"tokens": jnp.asarray(data["tokens"]),
                  "labels": jnp.asarray(data["labels"])}}
        def f(p):
            return pp.pipeline_lm_loss(p, batch, cfg, mesh=mesh, n_stages=2,
                                       n_micro={N_MICRO},
                                       rng=jax.random.PRNGKey({seed}),
                                       train=True)[0]
        loss, g = jax.jit(jax.value_and_grad(f))(params)
        out = {{"loss": np.asarray(loss)}}
        for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
            out["g/" + "/".join(str(getattr(k, "key", k)) for k in path)] = (
                np.asarray(v))
        np.savez({os.path.join(tmp, "pp_out.npz")!r}, **out)
    """)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PYTHONPATH=(
                                os.path.join(REPO, "src"))))

    def wait() -> dict:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(os.path.join(tmp, "pp_out.npz"))
        return {k: got[k] for k in got.files}
    return wait


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = _cfgs()
    tree, pad = _padded_blocks(jcfg)
    rs = np.random.RandomState(5)
    tokens = rs.randint(1, 128, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    seq8 = dict(tree, blocks=pad)
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    ref_pp = _reference_pipeline(tmp, tree, pad, batch, seed=7)
    rng = jax.random.PRNGKey(7)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    waits, want = {}, {}
    loop = jax.jit(jax.value_and_grad(
        lambda p, k: _jax_layer_loop(jcfg, p, jbatch, k)))
    for name, (stages, model) in MESHES.items():
        keys = _noise_keys(rng, stages)
        cases = {}
        for train in (False, True):
            params = dict(tree, blocks=_stage_stack(pad, stages))
            case = {"cfg": tcfg, "n_stages": stages, "n_micro": N_MICRO,
                    "params": from_jax_tree(params, device="cpu"),
                    "batch": tbatch, "train": train}
            if train:
                per = TOTAL // stages
                case["draws"] = {"noise": [[[torch.from_numpy(np.array(
                    jax.random.normal(keys[mb, s * per + i],
                                      (B // N_MICRO * S, 4))))
                    for i in range(per)] for s in range(stages)]
                    for mb in range(N_MICRO)]}
            else:
                case["steps"] = 2
            cases[f"train={train}"] = case
        waits[name] = workers.start(
            "pipeline", tmp_path_factory.mktemp(f"pp{name}"),
            {"cases": cases}, stages, model, timeout=600)
        loss, g = loop(seq8, keys)
        want[(name, True)] = {"loss": float(loss), "grads": g}
    # train=False: JAX's sequential lm_loss of the padded stack.
    cfg8 = jcfg.replace(n_layers=TOTAL)
    lm8 = dict(tree, blocks={"periods": {"pos0": pad}})
    b_mb = B // N_MICRO
    mbs = [{k: v[i * b_mb:(i + 1) * b_mb] for k, v in jbatch.items()}
           for i in range(N_MICRO)]

    lm_loss = jax.jit(lambda p, b: jlm.lm_loss(p, b, cfg8, rng=None,
                                               train=False))

    def mean_loss(p):
        return sum(lm_loss(p, mb)[0] for mb in mbs) / N_MICRO
    loss, g = jax.jit(jax.value_and_grad(mean_loss))(lm8)
    g = dict(g, blocks=g["blocks"]["periods"]["pos0"])
    aux = np.mean([float(lm_loss(lm8, mb)[1]["aux_loss"]) for mb in mbs])
    xent = float(lm_loss(lm8, jbatch)[1]["xent"])
    for name in MESHES:
        want[(name, False)] = {"loss": float(loss), "grads": g, "aux": aux,
                               "xent": xent}
    return {"ranks": {name: w() for name, w in waits.items()},
            "want": want, "ref_pp": ref_pp()}


def _rank_mean(ranks, case, key):
    return float(np.mean([r[case][key] for r in ranks]))


def _check_grads(got_tree, want_tree, n_stages):
    """Every gradient leaf; the stacked blocks [n_stages, per, ...] read
    as the 8 layers of the sequential stack."""
    got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    assert len(got) == len(want)
    for path, g in got:
        g = g.numpy()
        if path[0].key == "blocks":
            g = g.reshape((TOTAL,) + g.shape[2:])
        np.testing.assert_allclose(g, np.asarray(want[path]), **GRAD_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pipeline_matches_sequential_lm_loss(run, mesh):
    """train=False, balance weights on: the ranks' mean loss is the mean
    of JAX's per-microbatch lm_loss, the xent the whole batch's, the aux
    loss the mean of the per-microbatch aux; every gradient."""
    ranks, want = run["ranks"][mesh], run["want"][(mesh, False)]
    got = _rank_mean(ranks, "train=False", "loss")
    np.testing.assert_allclose(got, want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(_rank_mean(ranks, "train=False", "xent"),
                               want["xent"], **LOSS_TOL)
    assert want["aux"] > 0.0
    for r in ranks:
        np.testing.assert_allclose(r["train=False"]["aux_loss"], want["aux"],
                                   **LOSS_TOL)
    for r in ranks:
        _check_grads(r["train=False"]["grads"], want["grads"],
                     MESHES[mesh][0])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pipeline_noise_chain_matches_jax(run, mesh):
    """train=True with the reference's per-(microbatch, stage, layer)
    noise: loss and every gradient against the JAX layer loop."""
    ranks, want = run["ranks"][mesh], run["want"][(mesh, True)]
    np.testing.assert_allclose(_rank_mean(ranks, "train=True", "loss"),
                               want["loss"], **LOSS_TOL)
    for r in ranks:
        _check_grads(r["train=True"]["grads"], want["grads"],
                     MESHES[mesh][0])


def test_pipeline_matches_jax_pipeline_lm_loss(run):
    """The (2, 2) pipeline at train=True against JAX's own
    ``pipeline_lm_loss`` on a (2, 2) mesh of fake devices: the loss and
    every gradient (the stacked [2, 4, ...] blocks as they are)."""
    ref, ranks = run["ref_pp"], run["ranks"]["2x2"]
    np.testing.assert_allclose(_rank_mean(ranks, "train=True", "loss"),
                               float(ref["loss"]), **LOSS_TOL)
    for r in ranks:
        flat = jax.tree_util.tree_flatten_with_path(r["train=True"]["grads"])
        for path, g in flat[0]:
            key = "g/" + "/".join(str(p.key) for p in path)
            np.testing.assert_allclose(g.numpy(), ref[key], **GRAD_TOL,
                                       err_msg=key)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pipeline_train_steps(run, mesh):
    """Two make_pipeline_train_step steps on one batch: every rank reports
    the same mean loss, finite, and the second is lower."""
    ranks = run["ranks"][mesh]
    losses = ranks[0]["train=False"]["step_losses"]
    for r in ranks:
        assert r["train=False"]["step_losses"] == losses
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
