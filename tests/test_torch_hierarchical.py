"""The port's hierarchical MoE (Appendix B) against the JAX package's
``repro.core.hierarchical``, in f32 on the CPU.

Both packages get the same parameters (a JAX ``pm.materialize`` tree,
gates redrawn so that routing carries information, moved across with
``from_jax_tree``), the same inputs and the same gate noise: the
reference's draws for ``rng`` (the primary level's from
``split(rng)[0]``, group g's from ``split(split(rng)[1], a)[g]``),
passed to the port as tensors.  The port's ``"cuda"`` backend runs its
kernels' plain versions here (CPU tensors) and is held to the JAX
``"pallas"`` backend (Pallas in interpret mode, vmapped over the groups
at the secondary level); the port's ``"ref"`` to the JAX ``"ref"``.
The secondary level is one plan over the flat a·b experts; it is held
integer for integer to the reference's per-group plans, at a capacity
that overflows at both levels.  Tolerances: outputs, gradients, losses
and metrics 1e-5 (atol 1e-6 for the scalars); telemetry, indices and
positions exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.core import dispatch as jdsp
from repro.core import hierarchical as jh
from repro.core import router as jrouter
from repro.models import lm as jlm
from repro.models import paper_lm as jpl
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree, to_jax_tree
from repro_torch.configs import moe_paper as tconfigs
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import hierarchical as th
from repro_torch.core import router as trouter
from repro_torch.models import lm as tlm
from repro_torch.models import paper_lm as tpl
from repro_torch.serve import engine as tengine

A, B, D, F, T = 4, 4, 16, 32, 64
PAIRS = [("pallas", "cuda"), ("ref", "ref")]


def _args(jax_backend, torch_backend, **kw):
    common = dict(n_groups=A, n_experts_per_group=B, k_primary=2,
                  k_secondary=2, d_model=D, d_ff=F,
                  capacity_factor=kw.pop("capacity_factor", 1.0), **kw)
    return (jh.HMoEArgs(dtype=jnp.float32, kernel_backend=jax_backend,
                        **common),
            th.HMoEArgs(dtype=torch.float32, kernel_backend=torch_backend,
                        **common))


def _redraw_gates(tree, rs):
    """Random gates at both levels (zero gates tie every logit)."""
    for key in ("gate_primary", "gate_secondary"):
        for w, scale in (("wg", 1.0), ("wnoise", 0.3)):
            if w in tree[key]:
                tree[key][w] = (scale * rs.randn(*tree[key][w].shape)
                                ).astype(np.float32)


def _setup(ja, seed=0):
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(jh.hmoe_defs(ja), jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    _redraw_gates(params, rs)
    x = rs.randn(T, D).astype(np.float32)
    return params, x


def _torch_params(params, grad=False):
    tp = from_jax_tree(params, device="cpu")
    for leaf in tpm.tree_leaves(tp):
        leaf.requires_grad_(grad)
    return tp


def jax_noise(rng, t, a, b, cp) -> dict:
    """The draws of the reference's ``hmoe_apply(rng=rng)`` at train
    time, as the port's two-level noise dict."""
    rng_p, rng_s = jax.random.split(rng)
    sec = [np.array(jax.random.normal(k, (cp, b)))
           for k in jax.random.split(rng_s, a)]
    return {"primary": torch.from_numpy(np.array(
                jax.random.normal(rng_p, (t, a)))),
            "secondary": torch.from_numpy(np.stack(sec))}


def _cp(ja, t=T, train=True):
    spec_p, _ = jh._level_specs(ja)
    return spec_p.capacity(t, ja.n_groups, train=train)


def _check_aux(taux, jaux):
    np.testing.assert_allclose(float(taux["aux_loss"].detach()),
                               float(jaux["aux_loss"]), rtol=1e-5,
                               atol=1e-6)
    assert set(taux["metrics"]) == set(jaux["metrics"])
    for k, v in jaux["metrics"].items():
        np.testing.assert_allclose(float(taux["metrics"][k].detach()),
                                   float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ("expert_load", "overflow"):
        assert taux["telemetry"][k].shape == (A * B,)
        np.testing.assert_allclose(taux["telemetry"][k].numpy(),
                                   np.asarray(jaux["telemetry"][k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backends", PAIRS)
def test_hmoe_apply_matches_jax(backends, train):
    """y, aux_loss, every metric and both telemetry vectors, with drops
    at both levels (capacity factor 1)."""
    ja, ta = _args(*backends)
    params, x = _setup(ja)
    rng = jax.random.PRNGKey(2)
    jy, jaux = jax.jit(lambda p, x_: jh.hmoe_apply(
        p, x_, ja, train=train, rng=rng))(params, jnp.asarray(x))
    noise = jax_noise(rng, T, A, B, _cp(ja, train=train)) if train else None
    ty, taux = th.hmoe_apply(_torch_params(params), torch.from_numpy(x), ta,
                             train=train, noise=noise)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _check_aux(taux, jaux)
    assert float(taux["metrics"]["fraction_dropped"]) > 0
    assert float(taux["telemetry"]["overflow"].sum()) > 0


TRAIN_PAIRS = [("pallas", "cuda", None), ("ref", "ref", None),
               ("pallas", "cuda", 3)]       # forced three-expert slab


@pytest.mark.parametrize("backends", TRAIN_PAIRS)
def test_hmoe_grads_match_jax(backends):
    """The gradient of every parameter and of x, with the JAX draws."""
    jb, tb, e_block = backends
    ja, ta = _args(jb, tb, dispatch_e_block=e_block)
    params, x = _setup(ja, seed=4)
    gy = np.random.RandomState(5).randn(T, D).astype(np.float32)
    rng = jax.random.PRNGKey(9)

    def jloss(p, x_):
        y, aux = jh.hmoe_apply(p, x_, ja, train=True, rng=rng)
        return jnp.sum(y * gy) + aux["aux_loss"]
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tp = _torch_params(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = th.hmoe_apply(tp, tx, ta, train=True,
                             noise=jax_noise(rng, T, A, B, _cp(ja)))
    tl = torch.sum(ty * torch.from_numpy(gy)) + taux["aux_loss"]
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jgp)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("priority", [False, True])
def test_flat_plan_is_the_per_group_plans(priority):
    """The secondary level's one plan over the a·b experts, against the
    reference router run group by group on the same slot buffers and
    validity mask (what the reference's vmap computes): flat expert
    ``g·b + j``, slot and weight of every assignment equal, with drops
    at both levels."""
    spec = trouter.RouterSpec(capacity_factor=1.0,
                              priority_dispatch=priority)
    jspec = jrouter.RouterSpec(capacity_factor=1.0,
                               priority_dispatch=priority)
    ja, ta = _args("ref", "cuda", router=jspec)
    ta = dataclasses.replace(ta, router=spec)
    params, x = _setup(ja, seed=6)
    tp = _torch_params(params)
    spec_p, spec_s = th._level_specs(ta)
    rng = jax.random.PRNGKey(11)
    noise = jax_noise(rng, T, A, B, _cp(ja))
    dec_p = trouter.Router(spec_p, A).route(
        {"gate": tp["gate_primary"]}, torch.from_numpy(x), train=True,
        noise=noise["primary"])
    assert float(dec_p.plan.fraction_dropped) > 0
    buf = th.backend_lib.get("ref").dispatch(torch.from_numpy(x), dec_p, ta)
    cp = buf.shape[1]
    valid = th._kept_slots(dec_p.plan, A)
    cap = spec_s.capacity(cp, B, train=True)
    flat = trouter.Router(spec_s, B).route(
        {"gate": tp["gate_secondary"]}, buf, train=True,
        noise=noise["secondary"], mask=valid, capacity=cap).plan
    assert (flat.n_experts, flat.capacity) == (A * B, cap)
    # The reference: dispatch of a ones column is the validity mask.
    jvalid = np.asarray(jdsp.dispatch(jnp.ones((T, 1)), jdsp.DispatchPlan(
        expert_index=jnp.asarray(dec_p.plan.expert_index.numpy()),
        position=jnp.asarray(dec_p.plan.position.numpy()),
        weight=jnp.asarray(dec_p.plan.weight.numpy()), n_experts=A,
        capacity=cp, fraction_dropped=0.0)))[..., 0]
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    _, jspec_s = jh._level_specs(ja)
    _, rng_s = jax.random.split(rng)
    route = jax.jit(lambda gp, xg, key, vg: jrouter.Router(
        jspec_s, B).route(gp, xg, train=True, rng=key, mask=vg,
                          capacity=cap))
    pos, eidx, wt = [], [], []
    dropped = 0
    for g, key in enumerate(jax.random.split(rng_s, A)):
        gp = {"gate": {k: v[g] for k, v in params["gate_secondary"].items()}}
        dec = route(gp, jnp.asarray(buf[g].numpy()), key,
                    jnp.asarray(jvalid[g]))
        eidx.append(np.asarray(dec.plan.expert_index) + g * B)
        pos.append(np.asarray(dec.plan.position))
        wt.append(np.asarray(dec.plan.weight))
        dropped += int(((np.asarray(dec.combine_weights) > 0)
                        & (np.asarray(dec.plan.position) >= cap)).sum())
    assert dropped > 0
    np.testing.assert_array_equal(flat.expert_index.numpy(),
                                  np.concatenate(eidx))
    np.testing.assert_array_equal(flat.position.numpy(), np.concatenate(pos))
    np.testing.assert_allclose(flat.weight.numpy(), np.concatenate(wt),
                               rtol=1e-5, atol=1e-6)


def test_mask_threading():
    """Masked tokens route nowhere (y = 0) and take no capacity: the
    valid half equals the compact batch (as the reference's
    ``test_hierarchical_mask_threading``), and the masked call equals
    the reference's."""
    ja, ta = _args("ref", "cuda", capacity_factor=8.0)
    params, _ = _setup(ja)
    x = np.random.RandomState(1).randn(T, D).astype(np.float32)
    mask = np.concatenate([np.ones(T // 2), np.zeros(T // 2)]).astype(
        np.float32)
    tp = _torch_params(params)
    y, aux = th.hmoe_apply(tp, torch.from_numpy(x), ta, train=False,
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(y[T // 2:].numpy(), 0.0, atol=1e-6)
    y_c, _ = th.hmoe_apply(tp, torch.from_numpy(x[:T // 2]), ta,
                           train=False)
    np.testing.assert_allclose(y[:T // 2].numpy(), y_c.numpy(), rtol=2e-3,
                               atol=2e-4)
    jy, jaux = jax.jit(lambda p, x_, m: jh.hmoe_apply(
        p, x_, ja, train=False, mask=m))(params, jnp.asarray(x),
                                         jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _check_aux(aux, jaux)


@pytest.mark.parametrize("backends", PAIRS)
def test_expert_choice_matches_jax(backends):
    """Expert-choice routing at both levels: each group's experts pick
    among its own slots; nothing overflows."""
    ja, ta = _args(*backends)
    ja = dataclasses.replace(ja, router=jrouter.RouterSpec(
        policy="expert_choice", capacity_factor=1.0))
    ta = dataclasses.replace(ta, router=trouter.RouterSpec(
        policy="expert_choice", capacity_factor=1.0))
    params, x = _setup(ja, seed=3)
    jy, jaux = jax.jit(lambda p, x_: jh.hmoe_apply(p, x_, ja, train=True))(
        params, jnp.asarray(x))
    ty, taux = th.hmoe_apply(_torch_params(params), torch.from_numpy(x), ta,
                             train=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _check_aux(taux, jaux)
    assert float(taux["telemetry"]["overflow"].sum()) == 0


@pytest.mark.parametrize("policy", ["batchwise", "threshold"])
def test_appendix_f_policies_raise(policy):
    _, ta = _args("ref", "cuda")
    ta = dataclasses.replace(ta, router=trouter.RouterSpec(policy=policy))
    with pytest.raises(trouter.RouterError, match="hierarchical MoE"):
        th.hmoe_defs(ta)
    with pytest.raises(trouter.RouterError, match="hierarchical MoE"):
        th.hmoe_apply({}, torch.zeros((T, D)), ta)


def test_dispatch_e_block_against_resident():
    """Both levels' e-blocked kernels (plain versions here) against the
    resident ones: output and every gradient within 1e-6."""
    _, ta = _args("ref", "cuda")
    params, x = _setup(_args("ref", "ref")[0], seed=8)
    gy = torch.from_numpy(np.random.RandomState(8).randn(T, D).astype(
        np.float32))
    noise = th.make_noise(ta, T, torch.Generator().manual_seed(8), "cpu")
    res = {}
    for e_block in (None, 3):
        tp = _torch_params(params, grad=True)
        y, aux = th.hmoe_apply(tp, torch.from_numpy(x), dataclasses.replace(
            ta, dispatch_e_block=e_block), train=True, noise=noise)
        (torch.sum(y * gy) + aux["aux_loss"]).backward()
        res[e_block] = [y.detach()] + [p.grad for p in tpm.tree_leaves(tp)
                                       if p.grad is not None]
    assert len(res[None]) == len(res[3]) == 7
    for a, b in zip(res[3], res[None]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_moves_hmoe_trees_as_plain_copies(dtype):
    """The rank-4 expert leaves and the [a, d, b] secondary gates cross
    both ways byte for byte."""
    ja, _ = _args("ref", "ref", activation="swiglu")
    ja = dataclasses.replace(ja, dtype=getattr(jnp, dtype))
    tree = jax.tree_util.tree_map(np.asarray, jpm.materialize(
        jh.hmoe_defs(ja), jax.random.PRNGKey(0)))
    _redraw_gates(tree, np.random.RandomState(0))
    tp = from_jax_tree(tree, device="cpu")
    assert tuple(tp["w1"].shape) == (A, B, D, F)
    assert tuple(tp["gate_secondary"]["wg"].shape) == (A, D, B)
    back = to_jax_tree(tp, bf16=np.dtype(jnp.bfloat16))
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == np.asarray(want).tobytes(), path


# ---------------------------------------------------------------------------
# the models: the paper LM's moe-*-h rows and the transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_params", [
    ("moe-256-h", 305_680_384), ("moe-1024-h", 1_111_773_184),
    ("moe-4096-h", 4_336_144_384)])
def test_hierarchical_paper_configs_match_reference(name, n_params):
    """Same parameter tree, shapes and count as the reference's, at the
    default vocabulary of 32,000 (defs only: nothing is materialized)."""
    from repro.configs import moe_paper as jconfigs
    tdefs = tpl.paper_lm_defs(tconfigs.paper_config(name))
    jdefs = jpl.paper_lm_defs(jconfigs.paper_config(name))
    tshapes = [tuple(d.shape) for d in tpm.tree_leaves(tdefs)]
    jshapes = [tuple(d.shape) for d in jax.tree_util.tree_leaves(
        jdefs, is_leaf=lambda v: isinstance(v, jpm.ParamDef))]
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in tshapes) == n_params


def _paper_draws(rng, cfg, b, s, cp):
    """The draws of the reference's ``paper_lm_loss(rng=rng)``; key 2
    feeds the hierarchical MoE."""
    rngs = jax.random.split(rng, 4)
    draws = {f"keep{i}": torch.from_numpy(np.array(jax.random.bernoulli(
        rngs[i], 1.0 - cfg.dropout, (b, s, cfg.d_model)))) for i in range(4)}
    draws["noise"] = jax_noise(rngs[2], b * s, *cfg.hierarchical, cp)
    return draws


def test_paper_lm_hierarchical_matches_jax():
    """moe-256-h's layout (16 groups of 16 at the paper) at a tiny width
    (4 x 4 experts, d 32): loss and every gradient against JAX's Pallas
    backend, and the port's own draws have the reference's shapes."""
    from repro.data import pipeline as jdata
    from repro_torch.data import pipeline as tdata
    common = dict(vocab_size=64, variant="moe", d_model=32, n_experts=16,
                  hierarchical=(4, 4), expert_hidden=48)
    jcfg = jpl.PaperLMConfig(kernel_backend="pallas", **common)
    tcfg = tpl.PaperLMConfig(**common)
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  jpm.materialize(jpl.paper_lm_defs(jcfg),
                                                  jax.random.PRNGKey(1)))
    _redraw_gates(tree["moe"], np.random.RandomState(1))
    dc = dict(vocab_size=64, seq_len=8, batch_size=4, n_clusters=4)
    batch = jdata.batch_at(jdata.DataConfig(**dc), 3)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jpl.paper_lm_loss(p, batch, jcfg, rng=rng),
        has_aux=True))(tree)
    tp = _torch_params(tree, grad=True)
    tbatch = tdata.batch_at(tdata.DataConfig(**dc), 3, device="cpu")
    cp = _cp(jpl._hmoe_args(jcfg), t=32)
    tl, tm = tpl.paper_lm_loss(tp, tbatch, tcfg,
                               draws=_paper_draws(rng, tcfg, 4, 8, cp))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in jm:
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))
    own = tpl.make_draws(tcfg, 4, 8, torch.Generator().manual_seed(0),
                         "cpu")["noise"]
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        "primary": (32, 4), "secondary": (4, cp, 4)}


SERVE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32,
             capacity_factor=2.0, moe_hierarchical=(2, 2))
TRACE = [(8, 6, 0), (12, 4, 0), (16, 8, 1), (8, 5, 2), (12, 7, 3)]


def test_engine_streams_match_jax():
    """kimi-k2's family with a hierarchical MoE (2 groups of 2) served
    by both engines on a staggered trace with oversubscribed slots:
    greedy streams, stats and the per-expert load over the a·b grid
    equal."""
    from repro.configs.base import get_config as jget_config
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, q_block=16,
        kv_block=16, kernel_backend="ref", **SERVE)
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, **SERVE)
    tree = jax.tree_util.tree_map(np.asarray, jpm.materialize(
        jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    _redraw_gates(tree["blocks"]["periods"]["pos0"]["moe"],
                  np.random.RandomState(0))
    rs = np.random.RandomState(1)
    trace = [(rs.randint(1, 64, (n,)).astype(np.int32), m, arr)
             for n, m, arr in TRACE]
    kw = dict(max_len=32, n_slots=4)
    streams, loads = [], []
    for eng in (jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(**kw)),
                tengine.ServeEngine(from_jax_tree(tree, device="cpu"), tcfg,
                                    tengine.ServeConfig(**kw),
                                    device="cpu")):
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
        eng.run()
        streams.append(([r.tokens for r in reqs], eng.stats))
        loads.append(np.sum([t["expert_load"] for t in eng.telemetry],
                            axis=0))
    assert streams[1] == streams[0]
    assert loads[1].shape == (4,) and loads[1].sum() > 0
    np.testing.assert_array_equal(loads[1], loads[0])


def test_make_draws_layout():
    """A hierarchical layer's noise is the two-level dict, Cp from the
    primary level's training capacity."""
    tcfg = tget_config("kimi-k2-1t-a32b", **dict(SERVE, n_layers=3))
    draws = tlm.make_draws(tcfg, 2, 64, torch.Generator().manual_seed(0),
                           "cpu")["noise"]
    cp = trouter.RouterSpec(k=2).capacity(128, 2, train=True)
    assert cp == 256
    assert [{k: tuple(v.shape) for k, v in n.items()} for n in draws] == [
        {"primary": (128, 2), "secondary": (2, cp, 2)}] * 3
