"""The port's transformer training path against the JAX package, in f32
on the CPU: ``lm_loss`` and every gradient, remat and unstacked layers,
the forced e-blocked dispatch, the optimizer's sliced updates and ten
Trainer steps.

Both packages get the same parameters (a JAX ``pm.materialize`` tree of
``tests/conftest.py::small_config``, gates redrawn so that routing
carries information, moved across with ``from_jax_tree``), the same
data (``batch_at``) and the same gate noise: layer ``l``'s is the
reference's ``normal(fold_in(rng, l), [T, E])``, drawn with JAX and
passed to the port as tensors.  The port runs its default backend
``"cuda"``, whose kernel wrappers take their plain versions on CPU
tensors; the JAX package runs its configs' default backend.
Tolerances: loss and metrics rtol 1e-5, every gradient rtol / atol
1e-5 (as the paper LM's test); a 10-step loss curve 1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_config

from repro.common import param as jpm
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import trainer as jtrain
from repro_torch.common.bridge import from_jax_tree
from repro_torch.common.param import materialize, tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hierarchical as thier
from repro_torch.data import pipeline as tdata
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as ttrain

B, S = 2, 64
KIMI = "kimi-k2-1t-a32b"
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tcfg(jcfg) -> ModelConfig:
    """The port's config with the JAX config's values (torch dtypes, the
    port's default backend)."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        if f.name == "kernel_backend":
            continue
        v = getattr(jcfg, f.name)
        kw[f.name] = _DTYPES.get(v, v) if f.name.endswith("dtype") else v
    return ModelConfig(**kw)


def _params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)

    def redraw(node):
        for key, sub in node.items():
            if key in ("gate", "gate_primary", "gate_secondary"):
                sub["wg"] = rs.randn(*sub["wg"].shape).astype(np.float32)
            elif isinstance(sub, dict):
                redraw(sub)
    redraw(tree)
    return tree


def _torch_params(tree):
    tp = from_jax_tree(tree, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    return tp


def _jax_draws(rng, tcfg, t=B * S) -> dict:
    """The gate noise of the reference's ``lm_loss(rng=rng)``: layer
    ``l``'s from ``fold_in(rng, l)``, which a hierarchical MoE splits
    into its two levels' keys (``test_torch_hierarchical.jax_noise``)."""
    from test_torch_hierarchical import jax_noise
    noise = [None] * tcfg.n_layers
    for layer, kind in ttransformer.layer_index(tcfg):
        if kind.ffn not in ("moe", "moe+dense"):
            continue
        key = jax.random.fold_in(rng, layer)
        if tcfg.moe_hierarchical:
            a, b = tcfg.moe_hierarchical
            spec_p, _ = thier._level_specs(ttransformer._hmoe_args(tcfg))
            noise[layer] = jax_noise(key, t, a, b,
                                     spec_p.capacity(t, a, train=True))
        else:
            noise[layer] = torch.from_numpy(np.array(jax.random.normal(
                key, (t, tcfg.n_experts))))
    return {"noise": noise}


def _dc(vocab, **kw):
    return dict(vocab_size=vocab, seq_len=S, batch_size=B, n_clusters=4,
                **kw)


def _port_loss(tree, tcfg, rng, step=0):
    tp = _torch_params(tree)
    batch = tdata.batch_at(tdata.DataConfig(**_dc(tcfg.vocab_size)), step,
                           device="cpu")
    loss, metrics = tlm.lm_loss(tp, batch, tcfg, draws=_jax_draws(rng, tcfg))
    loss.backward()
    return tp, loss.detach(), {k: v.detach() for k, v in metrics.items()}


@pytest.mark.parametrize("arch,over", [
    ("smollm-135m", {}), ("qwen3-1.7b", {}), (KIMI, {}),
    ("arctic-480b", {}), (KIMI, {"scan_layers": False}),
    (KIMI, {"moe_hierarchical": (2, 2)})])
def test_lm_loss_and_grads_match_jax(arch, over):
    """smollm (dense), qwen3 (qk_norm), kimi-k2 (moe, swiglu), arctic
    (moe+dense), kimi-k2 unstacked (``scan_layers=False``: every layer
    in the tail, no remat) and kimi-k2 with a hierarchical MoE (2 groups
    of 2 experts, Appendix B)."""
    jcfg = small_config(arch, **over)
    tcfg = _tcfg(jcfg)
    tree = _params(jcfg, seed=1)
    batch = jdata.batch_at(jdata.DataConfig(**_dc(jcfg.vocab_size)), 3)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng), has_aux=True))(tree)
    tp, tl, tm = _port_loss(tree, tcfg, rng, step=3)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    if tcfg.n_experts:
        assert float(tm["aux_loss"]) > 0
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-1.7b", "llama3-8b",
                                  "arctic-480b", KIMI, "moa-demo"])
def test_registered_configs_are_the_references(arch):
    """Every ported config carries the reference's values (torch dtypes,
    the port's backend), and the same parameter counts."""
    from repro.configs.base import count_params as jcount
    from repro.configs.base import get_config as jget
    from repro_torch.configs.base import count_params, get_config
    assert get_config(arch) == _tcfg(jget(arch))
    assert count_params(get_config(arch)) == jcount(jget(arch))


def test_unstacked_tree_is_the_references():
    """``scan_layers=False`` declares every layer unstacked under
    "tail", with the reference's paths and shapes."""
    from repro_torch.common.param import ParamDef
    jcfg = small_config(KIMI, scan_layers=False, n_layers=3)
    tdefs = tlm.lm_defs(_tcfg(jcfg))
    assert set(tdefs["blocks"]) == {"tail"}
    jdefs = jlm.lm_defs(jcfg)
    tflat = jax.tree_util.tree_flatten_with_path(
        tdefs, is_leaf=lambda d: isinstance(d, ParamDef))[0]
    jflat = jax.tree_util.tree_flatten_with_path(jdefs, is_leaf=jpm.is_def)[0]
    assert [(p, d.shape) for p, d in tflat] == [(p, d.shape)
                                                for p, d in jflat]


def test_remat_changes_no_number():
    """``remat`` on (a checkpoint around each stacked period) and off:
    the same loss and gradients, bit for bit on the CPU."""
    jcfg = small_config(KIMI)
    tree = _params(jcfg, seed=2)
    rng = jax.random.PRNGKey(3)
    runs = [_port_loss(tree, _tcfg(jcfg).replace(remat=remat), rng)
            for remat in (True, False)]
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a.grad, b.grad)


def test_dispatch_e_block_reaches_the_moe_layers():
    """``cfg.dispatch_e_block`` forces the e-blocked dispatch / combine
    (kernels 3 and 5; their plain versions on the CPU): the same loss
    and gradients as the resident regime within 1e-6 (the slab grouping
    reorders the combine's sums)."""
    jcfg = small_config(KIMI)
    tcfg = _tcfg(jcfg)
    assert ttransformer._moe_args(
        tcfg.replace(dispatch_e_block=2)).dispatch_e_block == 2
    tree = _params(jcfg, seed=4)
    rng = jax.random.PRNGKey(5)
    resident = _port_loss(tree, tcfg, rng)
    blocked = _port_loss(tree, tcfg.replace(dispatch_e_block=2), rng)
    np.testing.assert_allclose(float(blocked[1]), float(resident[1]),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(blocked[0]), tree_leaves(resident[0])):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("what", ["moa"])
def test_unported_training_features_raise(what):
    """MoA training (``moa_apply``) is a later slice: the training path
    raises instead of running without it."""
    tcfg = _tcfg(small_config("moa-demo"))
    tp = materialize(tlm.lm_defs(tcfg), torch.Generator(), "cpu")
    batch = tdata.batch_at(tdata.DataConfig(**_dc(tcfg.vocab_size)), 0,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="MoA training"):
        tlm.lm_loss(tp, batch, tcfg)


def test_make_draws_layout():
    tcfg = _tcfg(small_config("arctic-480b", n_layers=3))
    gen = torch.Generator().manual_seed(0)
    draws = tlm.make_draws(tcfg, B, S, gen, "cpu")
    assert [tuple(n.shape) for n in draws["noise"]] == [
        (B * S, tcfg.n_experts)] * 3
    dense = tlm.make_draws(_tcfg(small_config("smollm-135m")), B, S, gen,
                           "cpu")
    assert dense["noise"] == [None, None]


@pytest.mark.parametrize("kind", ["adam", "factored"])
def test_sliced_update_equals_whole(kind, monkeypatch):
    """Leaves above SLICE_BYTES are normed and updated a slice of their
    leading axes at a time: the same parameters and state as the whole
    leaf at once (the gradient norm sums its slices in another order,
    so 1e-6 relative)."""
    rs = np.random.RandomState(0)
    shapes = {"e": (3, 5, 7), "s": (2, 4, 6, 8), "m": (9, 11), "v": (13,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (sc * rs.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for sc in (3.0, 0.05)]
    oc = topt.OptConfig(kind=kind, learning_rate=1e-2, warmup_steps=3,
                        weight_decay=0.01)
    out = []
    for limit in (topt.SLICE_BYTES, 4 * 20):
        monkeypatch.setattr(topt, "SLICE_BYTES", limit)
        tp = from_jax_tree(params, device="cpu")
        st = topt.init(tp, oc)
        for g in grads:
            _, _, info = topt.apply_updates(tp, from_jax_tree(g, device="cpu"),
                                            st, oc)
        out.append((tp, st, info))
    assert topt._slices(out[0][0]["s"], 2) is not None        # sliced
    np.testing.assert_allclose(float(out[1][2]["grad_norm"]),
                               float(out[0][2]["grad_norm"]), rtol=1e-6)
    for a, b in zip(tree_leaves({"p": out[1][0], "mu": out[1][1]["mu"]}),
                    tree_leaves({"p": out[0][0], "mu": out[0][1]["mu"]})):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_trainer_loss_curve_matches_jax(tmp_path):
    """Ten Trainer steps of kimi-k2's small_config from the same
    parameters, data and draws: the port follows the JAX Trainer's loss
    within 1e-4 relative."""
    jcfg = small_config(KIMI)
    tcfg = _tcfg(jcfg)
    tree = _params(jcfg, seed=3)
    dc = _dc(jcfg.vocab_size)
    # At 1e-2 this small model's loss climbs after step 4, and two
    # climbing curves part by their f32 roundings alone.
    opt = dict(learning_rate=1e-3, warmup_steps=5)
    loop = dict(total_steps=10, log_every=1, checkpoint_every=50)
    jt = jtrain.Trainer(
        loss_fn=lambda p, b, r: jlm.lm_loss(p, b, jcfg, rng=r),
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        oc=jopt.OptConfig(**opt), loop=jtrain.TrainLoopConfig(**loop),
        data_iter=jdata.DataIterator(jdata.DataConfig(**dc)),
        workdir=str(tmp_path / "j"))
    jt.run()
    base = jax.random.PRNGKey(0)
    draws = {ttrain.step_seed(0, s): _jax_draws(jax.random.fold_in(base, s),
                                                tcfg) for s in range(10)}
    tt = ttrain.Trainer(
        loss_fn=lambda p, b, g: tlm.lm_loss(p, b, tcfg,
                                            draws=draws[g.initial_seed()]),
        params=from_jax_tree(tree, device="cpu"), oc=topt.OptConfig(**opt),
        loop=ttrain.TrainLoopConfig(**loop),
        data_iter=tdata.DataIterator(tdata.DataConfig(**dc), device="cpu"),
        workdir=str(tmp_path / "t"), device="cpu")
    tt.run()
    jl = [m["loss"] for m in jt.metrics_log]
    tl = [m["loss"] for m in tt.metrics_log]
    assert len(jl) == len(tl) == 10
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
