"""The port's training slice against the JAX package, in f32 on the CPU.

Both packages get the same parameters (a JAX ``pm.materialize`` tree,
moved across with ``from_jax_tree``), the same data (``batch_at``) and
the same random draws (the dropout masks and gate noise drawn from the
JAX keys and passed to the port as tensors).  The port's default
backend ``"cuda"`` runs its kernels' autograd Functions, whose forward
and backward take the plain versions on CPU tensors; the JAX MoE runs
its Pallas kernels in interpret mode (``"pallas"``) or its ``"ref"``
path.  Tolerances: loss and every gradient 1e-5; one optimizer step
1e-6; a 10-step loss curve 1e-4 relative; checkpoints and a resumed run
bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.data import pipeline as jdata
from repro.models import paper_lm as jpl
from repro.optim import optimizers as jopt
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrain
from repro_torch.common.bridge import from_jax_tree
from repro_torch.common.param import tree_leaves
from repro_torch.configs import moe_paper as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.models import paper_lm as tpl
from repro_torch.optim import optimizers as topt
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttrain

V, D, E, K, FH = 64, 32, 8, 4, 48
B, S = 4, 8
VARIANTS = ["moe", "moe_1_wide", "moe_1_deep", "lstm_4x", "lstm_2048_512"]


def _cfgs(variant="moe", jax_backend="ref", **kw):
    common = dict(vocab_size=V, variant=variant, d_model=D, n_experts=E,
                  k=K, expert_hidden=FH, **kw)
    return (jpl.PaperLMConfig(kernel_backend=jax_backend, **common),
            tpl.PaperLMConfig(**common))


def _params(jcfg, seed=0):
    params = jpm.materialize(jpl.paper_lm_defs(jcfg),
                             jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    params)
    if "moe" in params:
        # Zero-initialized gates (Appendix A) tie every clean logit;
        # random gates make the routing decision carry information.
        rs = np.random.RandomState(seed)
        params["moe"]["gate"]["wg"] = rs.randn(D, E).astype(np.float32)
        params["moe"]["gate"]["wnoise"] = (0.3 * rs.randn(D, E)).astype(
            np.float32)
    return params


def _torch_params(params):
    tp = from_jax_tree(params, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    return tp


def _jax_draws(rng, cfg, b=B, s=S) -> dict:
    """The draws of the reference's ``paper_lm_loss(rng=rng)``: its four
    split keys feed the dropout masks, key 2 also the gate noise."""
    rngs = jax.random.split(rng, 4)
    draws = {f"keep{i}": torch.from_numpy(np.array(jax.random.bernoulli(
        rngs[i], 1.0 - cfg.dropout, (b, s, cfg.d_model)))) for i in range(4)}
    draws["noise"] = torch.from_numpy(np.array(jax.random.normal(
        rngs[2], (b * s, cfg.n_experts))))
    return draws


def _dc(**kw):
    return dict(vocab_size=V, seq_len=S, batch_size=B, n_clusters=4, **kw)


def _grad_names(root) -> set:
    seen, names, stack = set(), set(), [root]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("variant", VARIANTS)
def test_paper_lm_loss_and_grads_match_jax(variant):
    jcfg, tcfg = _cfgs(variant, jax_backend="pallas")
    params = _params(jcfg, seed=1)
    batch = jdata.batch_at(jdata.DataConfig(**_dc()), 3)
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jpl.paper_lm_loss(p, batch, jcfg, rng=rng),
        has_aux=True))(params)
    tp = _torch_params(params)
    tbatch = tdata.batch_at(tdata.DataConfig(**_dc()), 3, device="cpu")
    tl, tm = tpl.paper_lm_loss(tp, tbatch, tcfg,
                               draws=_jax_draws(rng, tcfg))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in ("xent", "aux_loss"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=1e-5, atol=1e-6)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        if leaf.grad is None:
            # A leaf the variant does not use (lstm_2048_512 keeps the
            # reference's lstm1 / lstm2 declarations): zero in JAX.
            assert variant == "lstm_2048_512" and path[0].key in (
                "lstm1", "lstm2") and not np.asarray(want).any(), path
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


def test_cuda_backend_trains_through_the_kernel_functions():
    """Through backend "cuda", every parameter gets a gradient and the
    graph passes through the four autograd Functions."""
    jcfg, tcfg = _cfgs()
    assert tcfg.kernel_backend == "cuda"
    tp = _torch_params(_params(jcfg))
    tbatch = tdata.batch_at(tdata.DataConfig(**_dc()), 0, device="cpu")
    loss, _ = tpl.paper_lm_loss(tp, tbatch, tcfg,
                                generator=torch.Generator().manual_seed(0))
    assert {"TopKGatingFnBackward", "DispatchFnBackward",
            "CombineFnBackward", "GMMFnBackward"} <= _grad_names(
                loss.grad_fn)
    loss.backward()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]:
        assert leaf.grad is not None, path
        assert bool(torch.isfinite(leaf.grad).all()), path


def test_hierarchical_and_unknown_variants_raise():
    with pytest.raises(ValueError):
        tpl.paper_lm_defs(tpl.PaperLMConfig(vocab_size=V, variant="gru"))
    with pytest.raises(KeyError):
        tconfigs.paper_config("moe-7")


def test_paper_configs_match_reference():
    from repro.configs import moe_paper as jconfigs
    assert tconfigs.PAPER_CONFIGS == jconfigs.PAPER_CONFIGS
    assert tconfigs.PAPER_VOCAB == jconfigs.PAPER_VOCAB
    for name in tconfigs.PAPER_CONFIGS:
        t, j = tconfigs.paper_config(name), jconfigs.paper_config(name)
        for f in dataclasses.fields(t):
            if f.name not in ("kernel_backend", "dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f)
    # MoE-256 at the 1-Billion-Word vocabulary: 1,085,410,304 parameters
    # (268.4 M of experts, 4.2 M of LSTM, 0.26 M of gate, 2 x 406.3 M of
    # embedding and softmax), as the reference declares them.
    from repro_torch.common.param import ParamDef
    defs = tpl.paper_lm_defs(tconfigs.paper_config("moe-256", 793_471))
    leaves = [d for d in tree_leaves(defs) if isinstance(d, ParamDef)]
    assert sum(d.size for d in leaves) == 1_085_410_304
    jdefs = jpl.paper_lm_defs(jconfigs.paper_config("moe-256", 793_471))
    assert [d.shape for d in leaves] == [
        d.shape for d in jax.tree_util.tree_leaves(jdefs, is_leaf=jpm.is_def)]


# ---------------------------------------------------------------------------
# optimizer, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "factored"])
def test_optimizer_steps_match_jax(kind):
    """Two updates (the first clipped) of a tree of rank-1, -2 and -3
    leaves: params and state within 1e-6."""
    rs = np.random.RandomState(0)
    shapes = {"a": (4, 6), "b": {"c": (3, 5, 7), "d": (5,)}}
    params = jax.tree_util.tree_map(
        lambda s: rs.randn(*s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(
        lambda p, sc=sc: (sc * rs.randn(*p.shape)).astype(np.float32),
        params) for sc in (3.0, 0.05)]
    common = dict(kind=kind, learning_rate=1e-2, warmup_steps=3,
                  weight_decay=0.01)
    joc, toc = jopt.OptConfig(**common), topt.OptConfig(**common)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init(jp, joc)
    tp = from_jax_tree(params, device="cpu")
    tst = topt.init(tp, toc)
    for g in grads:
        jp, jst, jinfo = jopt.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g), jst, joc)
        _, _, tinfo = topt.apply_updates(tp, from_jax_tree(g, device="cpu"),
                                         tst, toc)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=1e-6)
    for got, want in ((tp, jp), (tst["mu"], jst["mu"])):
        gl, wl = jax.tree_util.tree_flatten_with_path(got)[0], \
            jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, a), (_, b) in zip(gl, wl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=str(path))
    assert int(tst["step"]) == int(jst["step"]) == 2
    assert topt.state_bytes(tst) == jopt.state_bytes(jst)


@pytest.mark.parametrize("dc", [_dc(), dict(vocab_size=793_471, seq_len=5,
                                            batch_size=3, seed=4)])
def test_batch_at_matches_reference(dc):
    for step in (0, 1, 17):
        want = jdata.batch_at(jdata.DataConfig(**dc), step)
        got = tdata.batch_at(tdata.DataConfig(**dc), step, device="cpu")
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int64
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    it = tdata.DataIterator(tdata.DataConfig(**dc), start_step=1,
                            device="cpu")
    next(it)
    assert it.state() == {"step": 2}


# ---------------------------------------------------------------------------
# trainer and checkpoints
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-2, warmup_steps=5)


def _jax_trainer(workdir, total_steps, params, checkpoint_every=50,
                 trace_path=None):
    jcfg, _ = _cfgs()
    return jtrain.Trainer(
        loss_fn=lambda p, b, r: jpl.paper_lm_loss(p, b, jcfg, rng=r),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        oc=jopt.OptConfig(**OPT),
        loop=jtrain.TrainLoopConfig(total_steps=total_steps,
                                    checkpoint_every=checkpoint_every,
                                    log_every=1),
        data_iter=jdata.DataIterator(jdata.DataConfig(**_dc())),
        workdir=str(workdir), trace_path=trace_path)


def _torch_trainer(workdir, total_steps, params, loss_fn=None,
                   checkpoint_every=50, crash_at=None, trace_path=None):
    _, tcfg = _cfgs()
    loss_fn = loss_fn or (lambda p, b, g: tpl.paper_lm_loss(p, b, tcfg,
                                                            generator=g))
    return ttrain.Trainer(
        loss_fn=loss_fn, params=from_jax_tree(params, device="cpu"),
        oc=topt.OptConfig(**OPT),
        loop=ttrain.TrainLoopConfig(total_steps=total_steps,
                                    checkpoint_every=checkpoint_every,
                                    log_every=1),
        data_iter=tdata.DataIterator(tdata.DataConfig(**_dc()),
                                     device="cpu"),
        workdir=str(workdir), crash_at_step=crash_at,
        trace_path=trace_path, device="cpu")


def _assert_states_equal(tstate, jstate):
    gl = jax.tree_util.tree_flatten_with_path(tstate)[0]
    wl = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                      err_msg=str(path))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """A checkpoint written by one package's Trainer restores in the
    other's: the same files, manifest and leaves, bit for bit."""
    params = _params(_cfgs()[0])
    if writer == "jax":
        src = _jax_trainer(tmp_path, 2, params, checkpoint_every=2)
        src.run()
        dst = _torch_trainer(tmp_path, 2, params)
    else:
        src = _torch_trainer(tmp_path, 2, params, checkpoint_every=2)
        src.run()
        dst = _jax_trainer(tmp_path, 2, params)
    assert dst.start_step == 2 and dst.data_iter.step == 2
    tstate, jstate = ((dst.state, src.state) if writer == "jax"
                      else (src.state, dst.state))
    _assert_states_equal(tstate, jstate)


def test_checkpoint_roundtrip_keeps_bf16_bits(tmp_path):
    from repro_torch.common.bridge import to_jax_tree
    rs = np.random.RandomState(0)
    tree = {"a": torch.from_numpy(rs.randn(3, 4).astype(np.float32)),
            "b": {"c": torch.randn(5).to(torch.bfloat16),
                  "n": torch.tensor(7, dtype=torch.int32)}}
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save_async(s, tree, {"data": {"step": s}})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    got, extra, step = mgr.restore(3, tree)
    assert step == 3 and extra == {"data": {"step": 3}}
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"].view(torch.int16),
                       tree["b"]["c"].view(torch.int16))
    # ... and the JAX manager reads the same files.
    jtree = to_jax_tree(tree, bf16=np.dtype(jnp.bfloat16))
    jgot, _, _ = jckpt.CheckpointManager(str(tmp_path)).restore(3, jtree)
    assert jgot["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jgot["a"]), tree["a"].numpy())


def test_crash_and_resume_is_bitexact(tmp_path):
    """Kill training mid-run; a fresh Trainer resumes from the last
    checkpoint, and its final state equals an uninterrupted run's bit
    for bit (the per-step generator is seeded from (seed, step))."""
    params = _params(_cfgs()[0], seed=2)
    crash = _torch_trainer(tmp_path / "a", 8, params, checkpoint_every=3,
                           crash_at=5)
    with pytest.raises(RuntimeError, match="injected crash"):
        crash.run()
    resumed = _torch_trainer(tmp_path / "a", 8, params, checkpoint_every=3)
    assert resumed.start_step == 3 and resumed.data_iter.step == 3
    m_resumed = resumed.run()
    clean = _torch_trainer(tmp_path / "b", 8, params, checkpoint_every=3)
    m_clean = clean.run()
    assert m_resumed["loss"] == m_clean["loss"]
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(clean.state)):
        assert torch.equal(a, b)


def test_loss_curve_matches_jax_trainer(tmp_path):
    """Ten steps from the same parameters, data and draws: the port's
    Trainer follows the JAX Trainer's loss within 1e-4 relative."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=3)
    jt = _jax_trainer(tmp_path / "j", 10, params)
    jt.run()
    base = jax.random.PRNGKey(0)
    draws = {ttrain.step_seed(0, s): _jax_draws(jax.random.fold_in(base, s),
                                                tcfg) for s in range(10)}
    tt = _torch_trainer(
        tmp_path / "t", 10, params,
        loss_fn=lambda p, b, g: tpl.paper_lm_loss(
            p, b, tcfg, draws=draws[g.initial_seed()]))
    tt.run()
    jl = [m["loss"] for m in jt.metrics_log]
    tl = [m["loss"] for m in tt.metrics_log]
    assert len(jl) == len(tl) == 10
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_microbatches_accumulate_to_the_full_batch_step():
    jcfg, tcfg = _cfgs("moe_1_wide")
    params = _params(jcfg)
    batch = tdata.batch_at(tdata.DataConfig(**_dc()), 0, device="cpu")
    oc = topt.OptConfig(learning_rate=1e-2, warmup_steps=1)
    out = []
    for n in (1, 4):
        tp = _torch_params(params)
        step = ttrain.make_train_step(
            lambda p, b, g: tpl.paper_lm_loss(p, b, tcfg, train=False), oc,
            microbatches=n)
        step({"params": tp, "opt": topt.init(tp, oc)}, batch, None)
        out.append(tp)
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-6)


def test_trainer_refuses_unported_tracing(tmp_path):
    """Once refused, now ported: with ``trace_path`` both Trainers write
    the same sequence of ``train.*`` spans (names and attributes), and
    the traced port run follows the traced JAX run's losses (1e-4
    relative, as the loss-curve test)."""
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=3)
    paths = {k: str(tmp_path / f"{k}.json") for k in ("jax", "torch")}
    jt = _jax_trainer(tmp_path / "j", 3, params, checkpoint_every=2,
                      trace_path=paths["jax"])
    jt.run()
    base = jax.random.PRNGKey(0)
    draws = {ttrain.step_seed(0, s): _jax_draws(jax.random.fold_in(base, s),
                                                tcfg) for s in range(3)}
    tt = _torch_trainer(
        tmp_path / "t", 3, params, checkpoint_every=2,
        trace_path=paths["torch"],
        loss_fn=lambda p, b, g: tpl.paper_lm_loss(
            p, b, tcfg, draws=draws[g.initial_seed()]))
    tt.run()

    def train_spans(events):
        return [(e["name"], e["args"]) for e in events
                if e["name"].startswith("train.")]
    got = train_spans(ttrace.load(paths["torch"]))
    assert got == train_spans(jtrace.load(paths["jax"]))
    assert [n for n, _ in got].count("train.checkpoint") == 1
    np.testing.assert_allclose([m["loss"] for m in tt.metrics_log],
                               [m["loss"] for m in jt.metrics_log],
                               rtol=1e-4)
