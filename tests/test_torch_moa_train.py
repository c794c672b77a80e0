"""The port's Mixture-of-Attention-Heads training path against the JAX
package, in f32 on the CPU.

* ``moa_apply`` (route -> routed Q -> flash attention over the shared
  K/V -> routed O) and its aux, for ``noisy_topk`` and
  ``expert_choice``, with the gate noise the reference draws from its
  key passed in as a tensor; every gradient, the gate's included,
  against ``jax.grad``;
* moa-demo's ``lm_loss`` at ``train=True`` and every gradient against
  the JAX ``lm_loss`` with the same ``rng``: layer ``l``'s MoE noise is
  ``normal(fold_in(rng, l))`` and its MoA noise ``normal(fold_in(
  fold_in(rng, l), 1))`` (``lm.make_draws``' two lists), and draws
  without ``moa_noise`` are refused;
* ``_block``'s fall-back to the whole length, and ``--moa-k`` through
  the port's train launcher.

The port runs its default backend ``"cuda"`` (the kernels' plain
versions on CPU tensors), the JAX package its default (``"ref"``).
Tolerances: outputs and the loss rtol 1e-5, gradients rtol / atol 1e-5,
as ``test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_config
from test_torch_lm import _dc, _jax_draws, _params, _tcfg, _torch_params

from repro.common import param as jpm
from repro.core import moa as jmoa
from repro.core import router as jrouter
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.common.param import materialize, tree_leaves
from repro_torch.core import moa as tmoa
from repro_torch.core import router as trouter
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer

B, S, D = 2, 64, 64


def _args(policy):
    kw = dict(n_experts=4, k=2, d_model=D, n_heads_per_expert=2,
              head_dim=16, n_kv_heads=1, qk_norm=True, q_block=32,
              kv_block=32)
    return (jmoa.MoAArgs(**kw, router=jrouter.RouterSpec(policy=policy),
                         dtype=jnp.float32),
            tmoa.MoAArgs(**kw, router=trouter.RouterSpec(policy=policy),
                         dtype=torch.float32))


def _grads_close(tree_t, grads_j):
    flat_t = jax.tree_util.tree_flatten_with_path(tree_t)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("policy", ["noisy_topk", "expert_choice"])
def test_moa_apply_and_grads_match_jax(policy):
    ja, ta = _args(policy)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(jmoa.moa_defs(ja), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    tree["gate"]["wg"] = rs.randn(*tree["gate"]["wg"].shape).astype(
        np.float32)
    x = rs.randn(B, S, D).astype(np.float32)
    dy = rs.randn(B, S, D).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    key = jax.random.PRNGKey(3)

    def jloss(p, xx):
        y, aux = jmoa.moa_apply(p, xx, ja, positions=jnp.asarray(pos),
                                train=True, rng=key)
        return jnp.sum(y * dy) + aux["aux_loss"], (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(tree, jnp.asarray(x))
    tp = from_jax_tree(tree, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B * S, 4))))
    ty, taux = tmoa.moa_apply(tp, tx, ta, positions=torch.from_numpy(pos),
                              train=True, noise=noise)
    ((ty * torch.from_numpy(dy)).sum() + taux["aux_loss"]).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux["aux_loss"].detach()),
                               float(jaux["aux_loss"]), rtol=1e-5, atol=1e-7)
    assert set(taux["metrics"]) == set(jaux["metrics"])
    for key_ in jaux["metrics"]:
        np.testing.assert_allclose(float(taux["metrics"][key_].detach()),
                                   float(jaux["metrics"][key_]), rtol=1e-5,
                                   atol=1e-6, err_msg=key_)
    for key_ in ("expert_load", "overflow"):
        np.testing.assert_array_equal(taux["telemetry"][key_].numpy(),
                                      np.asarray(jaux["telemetry"][key_]))
    _grads_close(tp, jg)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    # The gate learns only through the final combine's weights and the
    # aux loss: its gradient must be there, and not zero.
    assert float(tp["gate"]["wg"].grad.abs().max()) > 0


def test_moa_demo_lm_loss_and_grads_match_jax():
    """moa-demo's small_config (attention + MoE FFN, MoA mixer + dense
    FFN, a tail layer) at ``train=True``: loss, metrics and every
    gradient against the JAX ``lm_loss`` with the same rng.  A MoA draw
    at the wrong index (or the FFN's draw reused) moves the loss well
    past the tolerance."""
    jcfg = small_config("moa-demo")
    tcfg = _tcfg(jcfg)
    tree = _params(jcfg, seed=5)
    batch = jdata.batch_at(jdata.DataConfig(**_dc(jcfg.vocab_size)), 2)
    rng = jax.random.PRNGKey(11)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng), has_aux=True))(tree)
    draws = _jax_draws(rng, tcfg)
    draws["moa_noise"] = [None] * tcfg.n_layers
    for layer, kind in ttransformer.layer_index(tcfg):
        if kind.mixer == "moa":
            key = jax.random.fold_in(jax.random.fold_in(rng, layer), 1)
            draws["moa_noise"][layer] = torch.from_numpy(np.array(
                jax.random.normal(key, (B * S, tcfg.moa_experts))))
    assert sum(n is not None for n in draws["moa_noise"]) == 2
    tp = _torch_params(tree)
    tbatch = tdata.batch_at(tdata.DataConfig(**_dc(tcfg.vocab_size)), 2,
                            device="cpu")
    tl, tm = tlm.lm_loss(tp, tbatch, tcfg, draws=draws)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    _grads_close(tp, jg)
    for moa in (tp["blocks"]["periods"]["pos1"]["moa"],):
        for name in ("wq", "wo", "wk", "wv"):
            assert float(moa[name].grad.abs().max()) > 0, name
        assert float(moa["gate"]["wg"].grad.abs().max()) > 0
    # Other MoA draws (these, row-flipped): the loss moves.
    swapped = dict(draws, moa_noise=[
        None if n is None else torch.flip(n, dims=[0])
        for n in draws["moa_noise"]])
    other, _ = tlm.lm_loss(_torch_params(tree), tbatch, tcfg, draws=swapped)
    assert abs(float(other) - float(jl)) > 1e-4 * abs(float(jl))


def test_make_draws_moa_layout():
    """One [B*S, moa_experts] draw per MoA mixer, apart from the MoE
    FFN's [B*S, E]; none for the other layers."""
    tcfg = _tcfg(small_config("moa-demo"))
    draws = tlm.make_draws(tcfg, B, S, torch.Generator().manual_seed(0),
                           "cpu")
    kinds = dict(ttransformer.layer_index(tcfg))
    for layer in range(tcfg.n_layers):
        moe = kinds[layer].ffn in ("moe", "moe+dense")
        moa = kinds[layer].mixer == "moa"
        assert (draws["noise"][layer] is not None) == moe
        assert (draws["moa_noise"][layer] is not None) == moa
        if moa:
            assert tuple(draws["moa_noise"][layer].shape) == (
                B * S, tcfg.moa_experts)


def test_draws_without_moa_noise_raise():
    """Hand-built draws for a config with MoA mixers must carry
    ``moa_noise``: without it the MoA gates would run noiseless at
    train=True.  At train=False the draws are not read."""
    tcfg = _tcfg(small_config("moa-demo"))
    tp = materialize(tlm.lm_defs(tcfg), torch.Generator().manual_seed(0),
                     "cpu")
    tbatch = tdata.batch_at(tdata.DataConfig(**_dc(tcfg.vocab_size)), 0,
                            device="cpu")
    draws = tlm.make_draws(tcfg, B, S, torch.Generator().manual_seed(0),
                           "cpu")
    del draws["moa_noise"]
    with pytest.raises(ValueError, match="moa_noise"):
        tlm.lm_loss(tp, tbatch, tcfg, draws=draws)
    loss, _ = tlm.lm_loss(tp, tbatch, tcfg, draws=draws, train=False)
    assert torch.isfinite(loss)


def test_block_falls_back_to_the_whole_length():
    """A block that does not divide the length becomes the length (the
    reference's rule): moa_apply at S = 48 with blocks of 32 runs, and
    equals blocks of 48."""
    assert tmoa._block(32, 48) == 48
    assert tmoa._block(32, 64) == 32
    assert tmoa._block(512, 48) == 48
    _, ta = _args("noisy_topk")
    gen = torch.Generator().manual_seed(0)
    tp = materialize(tmoa.moa_defs(ta), gen, "cpu")
    x = torch.randn(1, 48, D, generator=gen)
    pos = torch.arange(48)[None]
    y, _ = tmoa.moa_apply(tp, x, ta, positions=pos, train=False)
    whole = dataclasses.replace(ta, q_block=48, kv_block=48)
    y48, _ = tmoa.moa_apply(tp, x, whole, positions=pos, train=False)
    assert torch.equal(y, y48)


def test_train_launcher_applies_moa_k(tmp_path, capsys):
    final = tlaunch.main(["--arch", "moa-demo", "--reduce", "--device", "cpu",
                          "--batch", "2", "--seq", "32", "--steps", "2",
                          "--moa-k", "1", "--workdir", str(tmp_path)])
    assert final["step"] == 2 and np.isfinite(final["loss"])
    assert final["aux_loss"] > 0
    assert "moa_k: 1/4 head groups" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no MoA layers"):
        tlaunch.main(["--arch", "smollm-135m", "--reduce", "--device", "cpu",
                      "--steps", "1", "--moa-k", "1", "--workdir",
                      str(tmp_path / "s")])


# Kernel wrapper calls of one moa-demo training step (remat on, resident
# regime), each a launch on the card; chip_smoke.py's MOA_TRAIN_LAUNCHES.
# An MoE layer (swiglu): the forward's top-k, dispatch, three GMMs and
# combine, remat's recompute of them, then B5, the combine's backward
# dispatch, the dispatch's backward combine, the recomputed w1
# pre-activation and two transposed GMMs for each of w1, w2, w3.  An MoA
# layer: top-k, the Q dispatch (token plan), GMM wq, the Q combine
# (assignment plan), the O dispatch (assignment plan), GMM wo and the O
# combine (token plan), twice with remat; then B5, the backward of each
# dispatch (a combine) and of each combine (a dispatch; the assignment
# plan's unit weights take no gradient) and two transposed GMMs for each
# of wq and wo.
MOE_LAYER = {"topk_gating": 2, "topk_gating_bwd": 1, "dispatch": 3,
             "combine": 3, "gmm": 7, "gmm_bwd": 6}
MOA_LAYER = {"topk_gating": 2, "topk_gating_bwd": 1, "dispatch": 6,
             "combine": 6, "gmm": 4, "gmm_bwd": 4}


def test_moa_demo_step_launch_counts(monkeypatch):
    """moa-demo's layer pattern (two periods of attention + MoE FFN and
    MoA + dense FFN) at small widths: one lm_loss forward and backward
    calls each kernel wrapper 2 x MOE_LAYER + 2 x MOA_LAYER times."""
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.kernels import gmm as kgmm
    from repro_torch.kernels import topk_gating as ktopk
    calls: dict = {}

    def counting(module, name, key=None):
        real = getattr(module, name)

        def wrapped(*args, **kw):
            k = key(kw) if key else name
            calls[k] = calls.get(k, 0) + 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)

    counting(ktopk, "topk_gating")
    counting(ktopk, "topk_gating_bwd")
    counting(kdispatch, "dispatch")
    counting(kdispatch, "combine")
    counting(kgmm, "gmm", key=lambda kw: "gmm_bwd" if kw.get("trans_x")
             or kw.get("trans_w") else "gmm")
    tcfg = _tcfg(small_config("moa-demo", n_layers=4))
    assert tcfg.remat
    tp = materialize(tlm.lm_defs(tcfg), torch.Generator().manual_seed(0),
                     "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    batch = tdata.batch_at(tdata.DataConfig(**_dc(tcfg.vocab_size)), 0,
                           device="cpu")
    loss, _ = tlm.lm_loss(tp, batch, tcfg,
                          generator=torch.Generator().manual_seed(1))
    loss.backward()
    assert calls == {k: 2 * MOE_LAYER[k] + 2 * MOA_LAYER[k]
                     for k in MOE_LAYER}
