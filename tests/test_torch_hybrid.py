"""falcon-mamba-7b (pure Mamba) and jamba-v0.1-52b (Mamba + attention
1:7, MoE every other layer) in the port, against the JAX package in f32
on the CPU at ``tests/conftest.py::small_config`` scale.

* ``lm_loss`` and every gradient against the JAX ``lm_loss``, jamba's
  MoE noise drawn from the JAX keys (``test_torch_lm._jax_draws``);
* ``lm_prefill`` / ``lm_decode``: logits and the caches (scan and conv
  states, jamba's K/V) after a prompt and decode steps;
* the port's ``ServeEngine`` against the JAX ``ServeEngine`` on prompts
  of unequal lengths under 128 (3 tokens and up): greedy streams and
  ``stats`` equal; prompts of 1 and 2 tokens against the greedy tokens
  of the reference's whole-sequence forward (the reference engine's own
  conv-state handoff is short there, ROADMAP C.4); a chunked
  ``ServeConfig`` warns and falls back to whole prompts;
* the two configs and their parameter counts; both launchers with
  ``--reduce --device cpu``.

Tolerances: loss and metrics rtol 1e-5; logits within 1e-5 of the
reference's logit scale (``atol = 1e-5 * max(1, max |ref|)``), caches
the same of theirs; gradients within 1e-4 normwise (``||g - g_ref|| /
||g_ref||``, each leaf).  jamba's gradients are taken at 9 layers (one
stacked period and a tail layer, every block kind): at small_config's
17 layers both packages' f32 gradients of the first period's leaves
already differ from an f64 run of the port by 7e-5 (JAX) and 2.3e-4
(the port), which a 1e-4 gate would read as conditioning, not the port.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_config
from test_torch_lm import (_dc, _jax_draws, _params, _tcfg,
                           _torch_params)

from repro.common import param as jpm
from repro.configs.base import count_params as jcount
from repro.configs.base import get_config as jget
from repro.data import pipeline as jdata
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.configs.base import count_params, get_config
from repro_torch.data import pipeline as tdata
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import engine as tengine

FALCON, JAMBA = "falcon-mamba-7b", "jamba-v0.1-52b"


def _close(got, want, what=""):
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("arch,over", [(FALCON, {}), (JAMBA,
                                                      {"n_layers": 9})])
def test_lm_loss_and_grads_match_jax(arch, over):
    jcfg = small_config(arch, **over)
    tcfg = _tcfg(jcfg)
    tree = _params(jcfg, seed=1)
    batch = dict(jdata.batch_at(jdata.DataConfig(**_dc(jcfg.vocab_size)),
                                3))
    rng = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, rng=rng), has_aux=True))(tree)
    tp = _torch_params(tree)
    tb = tdata.batch_at(tdata.DataConfig(**_dc(tcfg.vocab_size)), 3,
                        device="cpu")
    draws = _jax_draws(rng, tcfg)
    assert sum(n is not None for n in draws["noise"]) == (
        4 if arch == JAMBA else 0)
    loss, tm = tlm.lm_loss(tp, tb, tcfg, draws=draws)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        assert leaf.grad is not None, path
        g, w = leaf.grad.numpy().astype(np.float64), np.asarray(
            want, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_prefill_and_decode_logits_match_jax(arch):
    """A 32-token prompt for two rows, then 8 decode steps: logits at
    every call and the final caches against the reference's."""
    jcfg = small_config(arch)
    tcfg = _tcfg(jcfg)
    tree = _params(jcfg, seed=2)
    tparams = _torch_params(tree)
    b, s, max_len = 2, 32, 48
    rs = np.random.RandomState(3)
    tokens = rs.randint(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    jcache = jpm.materialize(jtransformer.cache_defs(jcfg, b, max_len),
                             jax.random.PRNGKey(0))
    jl, jcache = jax.jit(lambda p, t, c: jlm.lm_prefill(
        p, {"tokens": t}, c, jcfg))(tree, jnp.asarray(tokens), jcache)
    jdecode = jax.jit(lambda p, t, c, i: jlm.lm_decode(p, t, c, i, jcfg))
    tcache = tpm.zeros(ttransformer.cache_defs(tcfg, b, max_len), "cpu")
    with torch.no_grad():
        tl, tcache = tlm.lm_prefill(tparams, {"tokens": torch.from_numpy(
            tokens)}, tcache, tcfg)
        _close(tl.numpy(), jl, "prefill")
        for i in range(8):
            nxt = rs.randint(1, jcfg.vocab_size, (b,)).astype(np.int32)
            cur = np.full((b,), s + i, np.int32)
            jd, jcache = jdecode(tree, jnp.asarray(nxt), jcache,
                                 jnp.asarray(cur))
            td, tcache = tlm.lm_decode(tparams, torch.from_numpy(nxt), tcache,
                                       torch.from_numpy(cur), tcfg)
            _close(td.numpy(), jd, f"decode step {i}")
    flat_t = jax.tree_util.tree_flatten_with_path(tcache)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [(p, tuple(a.shape)) for p, a in flat_t] == [
        (p, a.shape) for p, a in flat_j]
    keys = {jax.tree_util.keystr(p).split("'")[-2] for p, _ in flat_t}
    assert keys == ({"ssm", "conv"} if arch == FALCON
                    else {"ssm", "conv", "k", "v"})
    for (path, got), (_, want) in zip(flat_t, flat_j):
        _close(got.numpy(), want, jax.tree_util.keystr(path))


@pytest.fixture(scope="module", params=[FALCON, JAMBA])
def served(request):
    jcfg = small_config(request.param)
    tree = _params(jcfg, seed=4)
    return jcfg, _tcfg(jcfg), tree, _torch_params(tree)


# (prompt length, new tokens, arrival step): unequal lengths under the
# scan chunk of 128, with more requests than slots.  The reference's
# whole-prompt attention needs a length its 32-token blocks divide, or
# one shorter than a block (jamba).
TRACE = [(3, 6, 0), (20, 4, 0), (9, 5, 1), (64, 3, 2)]


def _serve(eng, trace):
    reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
    eng.run()
    return [list(r.tokens) for r in reqs], eng.stats


def test_engine_matches_jax(served):
    jcfg, tcfg, tree, tparams = served
    rs = np.random.RandomState(5)
    trace = [(rs.randint(1, jcfg.vocab_size, (n,)).astype(np.int32), m, a)
             for n, m, a in TRACE]
    kw = dict(max_len=72, n_slots=2)
    jeng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(**kw))
    with torch.no_grad():
        teng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                                   device="cpu")
        assert not teng._can_bucket
        tout = _serve(teng, trace)
    assert tout == _serve(jeng, trace)
    # whole, unpadded prompts: one prefill length a prompt length
    assert teng.prefill_lengths == {n for n, _, _ in TRACE}


def _jax_full_logits(tree, jcfg, seq):
    """The reference's training forward (whole-sequence ``ssm.mamba``,
    no cache) over ``seq``: [len, V] logits."""
    tokens = jnp.asarray(np.asarray(seq, np.int32)[None])
    x = jlm._embed_with_prefix(tree, tokens, jcfg)
    pos = jnp.arange(len(seq))[None]
    x, _ = jtransformer.stack_apply(tree["blocks"], x, jcfg, positions=pos,
                                    rng=None, train=False)
    x = jlayers.rmsnorm(tree["ln_f"], x, jcfg.norm_eps)
    return np.asarray(jlm.logits_fn(tree, x, jcfg))[0]


def test_short_prompts_match_the_whole_sequence_forward(served):
    """Prompts of 1 and 2 tokens (shorter than d_conv - 1): the port's
    engine hands the zero-padded conv state to decode, so each greedy
    token is the argmax of the reference's whole-sequence forward over
    the prompt and the tokens before it."""
    jcfg, tcfg, tree, tparams = served
    new = 6
    prompts = [np.array([7], np.int32), np.array([11, 3], np.int32)]
    with torch.no_grad():
        teng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
            max_len=16, n_slots=2), device="cpu")
        streams, _ = _serve(teng, [(p, new, 0) for p in prompts])
    for p, stream in zip(prompts, streams):
        seq = np.concatenate([p, stream[:-1]])
        logits = _jax_full_logits(tree, jcfg, seq)
        assert list(logits[len(p) - 1:].argmax(-1)) == stream


def test_chunked_config_warns_and_falls_back(served):
    jcfg, tcfg, tree, tparams = served
    with pytest.warns(RuntimeWarning, match="chunked prefill"):
        eng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
            max_len=48, n_slots=2, prefill_chunk=16), device="cpu")
    assert eng._chunk == 0 and eng.sched.prefill_chunk == 0
    whole = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
        max_len=48, n_slots=2), device="cpu")
    rs = np.random.RandomState(6)
    trace = [(rs.randint(1, jcfg.vocab_size, (n,)).astype(np.int32), m, a)
             for n, m, a in TRACE[:2]]
    with torch.no_grad():
        assert _serve(eng, trace) == _serve(whole, trace)
    assert eng.stats["prefill_chunks"] == 0


@pytest.mark.parametrize("arch,layers,total", [
    (FALCON, None, 7_270_825_984), (JAMBA, None, 51_568_312_320),
    (JAMBA, 16, 26_052_591_616), (JAMBA, 8, 13_294_731_264)])
def test_configs_and_parameter_counts_are_the_references(arch, layers,
                                                         total):
    over = {} if layers is None else {"n_layers": layers}
    assert get_config(arch) == _tcfg(jget(arch))
    got = count_params(get_config(arch, **over))
    assert got == jcount(jget(arch).replace(**over))
    assert got["total"] == total


@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_launchers_run_reduced_on_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tlaunch
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        final = tlaunch.main(["--arch", arch, "--reduce", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "32",
                              "--workdir", str(tmp_path)])
    assert final["step"] == 2 and np.isfinite(final["loss"])
    assert (final["aux_loss"] > 0) == (arch == JAMBA)
    tokens = tserve.main(["--arch", arch, "--reduce", "--device", "cpu",
                          "--requests", "3", "--prompt-len", "12",
                          "--new-tokens", "4", "--stagger", "1"])
    assert len(tokens) == 3 and all(len(t) == 4 for t in tokens)
    assert "3 requests x 4 tokens" in capsys.readouterr().out
