"""The port's sliding-window attention, ring-buffer caches, modality
frontend stubs and their three configs against the JAX package, in f32
on the CPU.

* the dense FFN (``layers.mlp``) for relu, gelu (the tanh form, as
  ``jax.nn.gelu``'s default), swiglu and geglu;
* windowed training attention, forward and gradients, at window 0 and
  32; ``causal_attention``'s window mask against ``blockwise_attention``;
* the ring buffer: a windowed prefill (prompts shorter and longer than
  the ring) then decode at per-row positions, against a full recompute
  with the training attention and against the reference's caches;
* gemma3-27b, pixtral-12b and musicgen-large at ``small_config``:
  prefill / decode logits and caches (``prefix_embeds`` for the two
  stubs), and the launcher's ``reduced`` shapes of the three (their
  ``lm_loss`` and gradients, and the configs themselves, are
  ``test_torch_lm.py``'s);
* the port's ``ServeEngine`` against the JAX engine on a small gemma3
  (streams and ``stats``), and its fall-back warnings for a windowed
  model (chunking and the prefix cache refused, bucketing off).

Tolerances: rtol / atol 1e-5 for outputs and gradients (as
``test_torch_lm.py``), atol 1e-4 for serving logits (as
``test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_config
from test_torch_attention import _attn_params
from test_torch_lm import _prefix_embeds, _tcfg

from repro.common import param as jpm
from repro.configs.base import get_config as jget
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import engine as tengine

S = 64
GEMMA, PIXTRAL, MUSICGEN = "gemma3-27b", "pixtral-12b", "musicgen-large"


@pytest.mark.parametrize("activation", ["relu", "gelu", "swiglu", "geglu"])
def test_mlp_matches_jax(activation):
    rs = np.random.RandomState(0)
    d, f = 64, 256
    params = {"w1": 0.2 * rs.randn(d, f), "w2": 0.2 * rs.randn(f, d)}
    if activation in ("swiglu", "geglu"):
        params["w3"] = 0.2 * rs.randn(d, f)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rs.randn(2, 8, d).astype(np.float32)
    want = jlayers.mlp(jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(x), activation)
    got = tlayers.mlp(from_jax_tree(params, device="cpu"),
                      torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 32])
def test_windowed_attention_matches_jax(window):
    """The training attention (qk-norm, rope, ``FlashAttentionFn``) at a
    window of 32 over S = 64 in blocks of 16, and without a window:
    output and parameter gradients."""
    jp, tp = _attn_params(32, 4, 2, 8, True, seed=window)
    rs = np.random.RandomState(window + 1)
    x = rs.randn(2, S, 32).astype(np.float32)
    dy = rs.randn(2, S, 32).astype(np.float32)
    pos = np.arange(S)[None].repeat(2, 0)
    kw = dict(rope_theta=1e4, qk_norm=True, window=window, q_block=16,
              kv_block=16)
    jy, jg = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jattn.attention(p, x, pos, **kw) * dy)))(jp)
    jy = jax.jit(lambda p: jattn.attention(p, x, pos, **kw))(jp)
    for leaf in tpm.tree_leaves(tp):
        leaf.requires_grad_(True)
    ty = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         **kw)
    (ty * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, leaf), (_, want) in zip(flat_t, flat_j):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("q_offset", [0, 8])
def test_causal_attention_window_matches_blockwise(q_offset):
    rs = np.random.RandomState(q_offset)
    q = rs.randn(2, 32, 4, 8).astype(np.float32)
    k = rs.randn(2, 32 + q_offset, 2, 8).astype(np.float32)
    v = rs.randn(2, 32 + q_offset, 2, 8).astype(np.float32)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=12,
        q_block=8, kv_block=8, q_offset=q_offset)
    got = tattn.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=12,
                                 q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_ring_buffer_decode_matches_full_recompute():
    """Two rows prefilled separately into ring pages of 16 slots (row 0's
    prompt of 8 tokens writes slots [0, 8); row 1's of 40 writes its
    last 16 positions at ``pos % 16``), stacked, then decoded together at
    their own positions until both have wrapped the ring: every output
    against the windowed training attention over the whole sequence, and
    the prefill outputs and final caches against the reference's."""
    d, h, kv, hd, w, s = 32, 4, 2, 8, 16, 72
    jp, tp = _attn_params(d, h, kv, hd, False)
    x = np.random.RandomState(2).randn(2, s, d).astype(np.float32)
    pos = np.arange(s)[None].repeat(2, 0)
    kw = dict(rope_theta=1e4, qk_norm=False)
    full = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                           window=w, q_block=8, kv_block=8, **kw).detach()
    prompts = (8, 40)
    pages, jpages = [], []
    for row, p in enumerate(prompts):
        page = tpm.zeros(tattn.init_cache_defs(1, s, kv, hd, window=w,
                                               dtype=torch.float32), "cpu")
        assert tuple(page["k"].shape) == (1, w, kv, hd)
        xr = torch.from_numpy(x[row:row + 1, :p])
        y, page = tattn.prefill_attention(tp, xr, torch.arange(p)[None],
                                          cache=page, window=w, **kw)
        np.testing.assert_allclose(y.numpy(), full[row:row + 1, :p].numpy(),
                                   rtol=1e-5, atol=1e-5)
        jcache = jpm.materialize(jattn.init_cache_defs(
            1, s, kv, hd, window=w, dtype=jnp.float32), jax.random.PRNGKey(0))
        jy, jcache = jattn.prefill_attention(
            jp, jnp.asarray(x[row:row + 1, :p]), jnp.arange(p)[None],
            cache=jcache, window=w, q_block=8, kv_block=8, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(page[key].numpy(),
                                       np.asarray(jcache[key]), atol=1e-5)
        pages.append(page)
        jpages.append(jcache)
    cache = {key: torch.cat([pg[key] for pg in pages]) for key in ("k", "v")}
    jcache = {key: jnp.concatenate([pg[key] for pg in jpages])
              for key in ("k", "v")}
    jdecode = jax.jit(lambda c, xt, cur: jattn.decode_attention(
        jp, xt, c, cur, window=w, **kw)[1])
    for i in range(s - max(prompts)):
        cur = np.array([prompts[0] + i, prompts[1] + i])
        xt = np.stack([x[r, c] for r, c in enumerate(cur)])[:, None]
        y, cache = tattn.decode_attention(tp, torch.from_numpy(xt), cache,
                                          torch.from_numpy(cur), window=w,
                                          **kw)
        want = torch.stack([full[r, c] for r, c in enumerate(cur)])
        np.testing.assert_allclose(y[:, 0].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"decode step {i}")
        jcache = jdecode(jcache, jnp.asarray(xt), jnp.asarray(cur))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)


def test_windowed_prefill_refuses_an_offset():
    _, tp = _attn_params(32, 4, 2, 8, False)
    cache = tpm.zeros(tattn.init_cache_defs(1, 32, 2, 8, window=16,
                                            dtype=torch.float32), "cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        tattn.prefill_attention(tp, torch.zeros(1, 8, 32),
                                torch.arange(8)[None], rope_theta=1e4,
                                qk_norm=False, cache=cache, window=16,
                                offset=8)


@pytest.mark.parametrize("arch", [GEMMA, PIXTRAL, MUSICGEN])
def test_launcher_reduced_is_the_references(arch):
    """``launch.train.reduced``: the window cut to 32, no prefix."""
    from repro.launch.train import reduced as jreduced
    from repro_torch.launch.train import reduced
    assert reduced(get_config(arch)) == _tcfg(jreduced(jget(arch)))


@pytest.mark.parametrize("arch", [GEMMA, PIXTRAL, MUSICGEN])
def test_prefill_and_decode_logits_match_jax(arch):
    """A 64-token prompt (longer than gemma's 32-slot rings) prefilled,
    then 24 decode steps that wrap the rings; the logits and the caches
    (for gemma the rings among them) against the reference's."""
    jcfg = small_config(arch)
    tcfg = _tcfg(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jpm.materialize(
        jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    tparams = from_jax_tree(tree, device="cpu")
    b, s, max_len = 2, 64, 96
    rs = np.random.RandomState(3)
    tokens = rs.randint(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    pe = _prefix_embeds(jcfg)
    if pe is not None:
        jb["prefix_embeds"], tb["prefix_embeds"] = (jnp.asarray(pe),
                                                    torch.from_numpy(pe))
    jcache = jpm.materialize(jtransformer.cache_defs(jcfg, b, max_len),
                             jax.random.PRNGKey(0))
    jl, jcache = jax.jit(lambda p, bt, c: jlm.lm_prefill(p, bt, c, jcfg))(
        tree, jb, jcache)
    jdecode = jax.jit(lambda p, t, c, i: jlm.lm_decode(p, t, c, i, jcfg))
    tcache = tpm.zeros(ttransformer.cache_defs(tcfg, b, max_len), "cpu")
    tl, tcache = tlm.lm_prefill(tparams, tb, tcache, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for i in range(24):
        nxt = rs.randint(1, jcfg.vocab_size, (b,)).astype(np.int32)
        cur = np.array([s + i, s + i], np.int32)
        jd, jcache = jdecode(tree, jnp.asarray(nxt), jcache, jnp.asarray(cur))
        td, tcache = tlm.lm_decode(tparams, torch.from_numpy(nxt), tcache,
                                   torch.from_numpy(cur), tcfg)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4,
                                   rtol=0, err_msg=f"decode step {i}")
    flat_t = jax.tree_util.tree_flatten_with_path(tcache)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [(p, tuple(a.shape)) for p, a in flat_t] == [
        (p, a.shape) for p, a in flat_j]
    for (path, got), (_, want) in zip(flat_t, flat_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=str(path))
    if arch == GEMMA:
        lengths = {tuple(a.shape)[-3] for _, a in flat_t}
        assert lengths == {jcfg.sliding_window, max_len}


# (prompt length, new tokens, arrival step): prompts shorter and longer
# than the 32-slot rings, decodes that wrap them.  The reference's
# whole-prompt prefill needs a length that its 32-token blocks divide,
# or one shorter than a block.
TRACE = [(8, 30, 0), (64, 12, 0), (20, 20, 1), (32, 9, 2), (64, 6, 3)]


@pytest.fixture(scope="module")
def gemma():
    jcfg = small_config(GEMMA)
    tree = jax.tree_util.tree_map(np.asarray, jpm.materialize(
        jlm.lm_defs(jcfg), jax.random.PRNGKey(1)))
    return jcfg, _tcfg(jcfg), tree, from_jax_tree(tree, device="cpu")


def _serve(eng, trace):
    reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
    eng.run()
    return [list(r.tokens) for r in reqs], eng.stats


def test_engine_matches_jax_on_windowed_model(gemma):
    jcfg, tcfg, tree, tparams = gemma
    rs = np.random.RandomState(4)
    trace = [(rs.randint(1, jcfg.vocab_size, (n,)).astype(np.int32), m, a)
             for n, m, a in TRACE]
    kw = dict(max_len=80, n_slots=2)
    jeng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(**kw))
    teng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                               device="cpu")
    assert not teng._can_bucket
    jout, tout = _serve(jeng, trace), _serve(teng, trace)
    assert tout == jout
    # Whole, unpadded prompts: one prefill length a prompt length.
    assert teng.prefill_lengths == {n for n, _, _ in TRACE}


def test_windowed_engine_refuses_chunking_and_the_prefix_cache(gemma):
    """As the reference's engine: chunked prefill warns and falls back
    to whole prompts (the scheduler without chunks, the budget checked
    at submit), the prefix cache warns and stays off, and the fall-back
    engine serves the whole-prompt engine's streams."""
    jcfg, tcfg, tree, tparams = gemma
    with pytest.warns(RuntimeWarning, match="chunked prefill"):
        eng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
            max_len=64, n_slots=2, prefill_chunk=16, prefill_budget=32),
            device="cpu")
    assert not eng._can_bucket and eng._chunk == 0
    assert eng.sched.prefill_chunk == 0
    with pytest.raises(ValueError, match="prefill budget"):
        eng.submit(np.arange(1, 40, dtype=np.int32), 2)
    with pytest.warns(RuntimeWarning, match="prefix cache disabled"):
        pref = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
            max_len=80, n_slots=2, prefill_chunk=16, prefix_cache=True),
            device="cpu")
    assert pref.prefix is None and pref._chunk == 0
    rs = np.random.RandomState(5)
    trace = [(rs.randint(1, jcfg.vocab_size, (n,)).astype(np.int32), m, a)
             for n, m, a in TRACE[:3]]
    whole = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
        max_len=80, n_slots=2), device="cpu")
    assert _serve(pref, trace) == _serve(whole, trace)
    assert pref.stats["prefill_chunks"] == 0
